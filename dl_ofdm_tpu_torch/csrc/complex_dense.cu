// complex_dense: y = x @ (wr + i*wi) on IQ-interleaved float32 data.
//
// Replaces the TPU kernel `_cdense_call` / `_cdense_kernel` in
// dl_ofdm_tpu/ops/pallas_kernels.py:56-88 (the learned-DFT `fft_like`
// layer of the DCCN receiver, and the equalizer's ToFreq, CorrT and
// ToTime).  It computes what that kernel computes,
//   yr = xr.wr - xi.wi,   yi = xr.wi + xi.wr,
// in float32 with float32 FMAs (no TF32: the "exact" layer promises true
// float32 products), but reads x as [M, K, 2] and writes y as [M, F, 2]
// directly: the JAX wrapper's split into planes and its final stack
// (pallas_kernels.py:125-137) are fused away.
//
// Bound on an H100 at the sweep's shape (M = 13776, K = 80, F = 64): 15.9 MB
// moved and 0.564 GFLOP, i.e. 4.7 us of HBM traffic against 8.4 us of
// float32 FMA work outside the tensor cores -- the operations bound it; at
// the equalizer's 210,000 x 64 x 64, 0.103 ms of FMA work.
//
// Design (persistent, weight resident, async-fed):
//   * a work item is a tile of RT rows (32 when it fits) by FT = 64
//     features; each block walks items `blockIdx.x, + gridDim.x, ...`, and
//     the grid is as many blocks as the SMs hold (rounded down to a
//     multiple of the feature tiles, so a block keeps one feature tile);
//   * the block loads its weight tile, (wr, wi) [K, 64] as float2 pairs,
//     into shared memory once (40 KB at K = 80), and keeps it for every
//     row tile it walks.  Past 192 rows of K (96 KB) the weight is
//     staged in K chunks inside each item instead;
//   * a row tile of x is one contiguous run of RT * K * 8 bytes, brought in
//     by one bulk asynchronous copy (cp.async.bulk, the TMA's non-tensor
//     mode) that completes on an mbarrier, in a ring of NST stages: the
//     next tiles load while this one computes.  A copy needs a size that
//     is a multiple of 16, so the last 8 bytes of a ragged final tile (odd
//     rows x odd K) are loaded by an ordinary load;
//   * past K = 2,642 not even a ring of three 2-row tiles fits beside the
//     weight chunk, so x is streamed in K chunks as the weight is: each
//     chunk of a 32-row tile ([32, kc] IQ pairs, 48 KB) comes in by 8-byte
//     `cp.async`s, one an IQ pair, which take any K and any alignment (a
//     row's chunk starts on an odd 8 bytes when K is odd), in flight while
//     the block stages the weight chunk beside it.  No K is refused;
//   * each thread keeps 8 rows x 2 features of complex accumulators; a
//     warp's x reads are broadcasts of one address and its w reads 512
//     contiguous bytes (no bank conflict), and with K even a row's IQ pairs
//     come two k at a time as float4: per k pair, eight float4 loads of x
//     and two of w feed 128 FMAs, so the FMA units and not shared memory
//     set the pace.
//
// The bf16 mode (`compute_dtype='bfloat16'`) is a kernel of its own, on
// the tensor cores: csrc/complex_dense_bf16.cu.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py).  The launch plan (rows per
// item, weight chunk, stage size, shared bytes, grid) is made by the
// caller, `complex_dense_plan` in dl_ofdm_tpu_torch/ops/pallas_kernels.py,
// from the card's SMs and the blocks a SM holds, which
// `complex_dense_f32_blocks_per_sm` reports; the entry point checks that
// the plan fits the layout below.  The launch goes on the caller's stream;
// the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int FT = 64;              // features per work item
constexpr int THREADS = 128;        // 4 warps of 8 rows x 64 features
constexpr int NST = 3;              // x tiles in the ring
constexpr int RT_MAX = 32;          // rows per work item
constexpr int SMEM_MAX = 220 * 1024;   // dynamic shared bytes a block may ask
constexpr int BAR_BYTES = 128;      // the ring's mbarriers, at the front

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// thread 0: bring row tile `rtile` of x into stage buffer `dst`, signalling
// `bar` when its bytes have landed
__device__ __forceinline__ void issue_tile(const float2* __restrict__ x,
                                           float2* dst, uint64_t* bar,
                                           int rtile, int rt, int M, int K) {
  const int r0 = rtile * rt;
  const int rows = min(rt, M - r0);
  const uint32_t bytes = static_cast<uint32_t>(rows) * K * 8u;
  const uint32_t bulk = bytes & ~15u;
  const float2* src = x + static_cast<size_t>(r0) * K;
  // the stage was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (bulk < bytes)   // ragged tail: the last IQ pair by an ordinary load
    dst[bulk / 8] = src[bulk / 8];
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bulk) : "memory");
  if (bulk)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bulk), "r"(smem_u32(bar))
        : "memory");
}

// acc[i][c] += x[row i][k] * w[k][feature c] for the thread's 8 rows and 2
// features, in the order (xr wr - xi wi), (xr wi + xi wr), one rounded FMA
// at a time
__device__ __forceinline__ void cmac(float (&accr)[8][2], float (&acci)[8][2],
                                     const float2 (&a)[8], const float4& w) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    accr[i][0] = fmaf(a[i].x, w.x, accr[i][0]);
    accr[i][0] = fmaf(-a[i].y, w.y, accr[i][0]);
    acci[i][0] = fmaf(a[i].x, w.y, acci[i][0]);
    acci[i][0] = fmaf(a[i].y, w.x, acci[i][0]);
    accr[i][1] = fmaf(a[i].x, w.z, accr[i][1]);
    accr[i][1] = fmaf(-a[i].y, w.w, accr[i][1]);
    acci[i][1] = fmaf(a[i].x, w.w, acci[i][1]);
    acci[i][1] = fmaf(a[i].y, w.z, acci[i][1]);
  }
}

// 8 bytes from global to shared memory, asynchronously (cp.async, not the
// bulk copy: any 8-byte aligned address)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// the thread's 8 rows x 2 features over kn k's of one weight chunk: x rows
// at xt + rows[i] * stride, the chunk's weight at wv (float2 pairs of two
// features, FT / 2 float4 a k); with K even a row's IQ pairs are read two k
// at a time as float4
template <bool KPAIR>
__device__ __forceinline__ void mac_chunk(float (&accr)[8][2],
                                          float (&acci)[8][2],
                                          const float2* xt, int stride,
                                          const int (&rows)[8], int kn,
                                          const float4* wv) {
  if (KPAIR) {        // stride and kn even: 16-byte aligned k pairs
    const float4* xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = reinterpret_cast<const float4*>(
          xt + static_cast<size_t>(rows[i]) * stride);
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 2) {
      float4 p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = xv[i][kk / 2];
      const float4 w0 = wv[kk * (FT / 2)], w1 = wv[(kk + 1) * (FT / 2)];
      float2 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = make_float2(p[i].x, p[i].y);
      cmac(accr, acci, a, w0);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = make_float2(p[i].z, p[i].w);
      cmac(accr, acci, a, w1);
    }
  } else {
    const float2* xr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xr[i] = xt + static_cast<size_t>(rows[i]) * stride;
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float2 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = xr[i][kk];
      cmac(accr, acci, a, wv[kk * (FT / 2)]);
    }
  }
}

// Thread (warp w, lane l): rows 8w .. 8w+7 of the item, features 2l and
// 2l+1.  A warp's x reads are broadcasts of one address, its w reads 512
// contiguous bytes.  STREAMED (stage_elems < rt * K): one buffer of
// [rt, kc] IQ pairs, refilled with each weight chunk, in place of the ring;
// a template argument, so the ring's kernel is compiled without it.
template <bool KPAIR, bool STREAMED>
__global__ void __launch_bounds__(THREADS)
complex_dense_kernel(const float2* __restrict__ x,    // [M, K]
                     const float* __restrict__ wr,    // [K, F]
                     const float* __restrict__ wi,    // [K, F]
                     float2* __restrict__ y,          // [M, F]
                     int M, int K, int F, int rt, int kc, int stage_elems,
                     int f_tiles, int n_items) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float2* ws = reinterpret_cast<float2*>(smem + BAR_BYTES);   // [kc][FT]
  float2* xs = ws + kc * FT;                                  // NST stages
  const int tid = threadIdx.x;
  const int lane = tid % 32;               // features 2*lane, 2*lane+1
  const int r8 = (tid / 32) * 8;           // rows r8 .. r8+7
  const int n_mine = (n_items - static_cast<int>(blockIdx.x) +
                      static_cast<int>(gridDim.x) - 1) / gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(bars + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && !STREAMED)
    for (int j = 0; j < NST && j < n_mine; ++j)
      issue_tile(x, xs + j * stage_elems, bars + j,
                 (blockIdx.x + j * gridDim.x) / f_tiles, rt, M, K);

  // rows past a short item's rt read row 0 and are never stored
  int rows[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = r8 + i < rt ? r8 + i : 0;
  const bool vec_w = F % 4 == 0;
  int loaded_ft = -1;
  for (int j = 0; j < n_mine; ++j) {
    const int item = blockIdx.x + j * gridDim.x;
    const int rtile = item / f_tiles, ft = item - rtile * f_tiles;
    const int s = j % NST;
    const float2* xt = xs + s * stage_elems;
    float accr[8][2], acci[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) accr[i][c] = acci[i][c] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kc) {
      const int kn = min(kc, K - k0);
      if (kc < K || ft != loaded_ft) {      // (re)stage the weight tile
        __syncthreads();
        if (STREAMED) {   // this K chunk of the tile's rows, by cp.async
          const int r0 = rtile * rt;
          for (int e = tid; e < rt * kn; e += THREADS) {
            const int r = e / kn, kk = e - r * kn;
            if (r0 + r < M)
              cp_async8(xs + r * kc + kk,
                        x + static_cast<size_t>(r0 + r) * K + k0 + kk);
          }
          asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
        for (int e = tid; e < kn * (FT / 4); e += THREADS) {
          const int kk = e / (FT / 4), c = (e - kk * (FT / 4)) * 4;
          const int f = ft * FT + c;
          const size_t o = static_cast<size_t>(k0 + kk) * F + f;
          float4 r = make_float4(0.f, 0.f, 0.f, 0.f), q = r;
          if (vec_w && f < F) {
            r = __ldg(reinterpret_cast<const float4*>(wr + o));
            q = __ldg(reinterpret_cast<const float4*>(wi + o));
          } else {
            float* rp = &r.x;
            float* qp = &q.x;
            for (int u = 0; u < 4 && f + u < F; ++u) {
              rp[u] = __ldg(wr + o + u);
              qp[u] = __ldg(wi + o + u);
            }
          }
          float4* dst = reinterpret_cast<float4*>(ws + kk * FT + c);
          dst[0] = make_float4(r.x, q.x, r.y, q.y);
          dst[1] = make_float4(r.z, q.z, r.w, q.w);
        }
        if (STREAMED) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        loaded_ft = ft;
      }
      const float4* wv = reinterpret_cast<const float4*>(ws) + lane;
      if (STREAMED) {
        mac_chunk<KPAIR>(accr, acci, xs, kc, rows, kn, wv);
      } else {
        if (k0 == 0) mbar_wait(smem_u32(bars + s), (j / NST) & 1);
        mac_chunk<KPAIR>(accr, acci, xt + k0, K, rows, kn, wv);
      }
    }
    __syncthreads();                        // every read of stage s is done
    if (tid == 0 && !STREAMED && j + NST < n_mine)
      issue_tile(x, xs + s * stage_elems, bars + s,
                 (item + NST * gridDim.x) / f_tiles, rt, M, K);

    const int r0 = rtile * rt;
    const int f0 = ft * FT + 2 * lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r8 + i;
      if (r >= rt || r0 + r >= M) continue;
      float2* out = y + static_cast<size_t>(r0 + r) * F + f0;
      if (F % 2 == 0 && f0 + 1 < F) {       // 16-byte aligned pair
        *reinterpret_cast<float4*>(out) =
            make_float4(accr[i][0], acci[i][0], accr[i][1], acci[i][1]);
      } else if (f0 < F) {
        out[0] = make_float2(accr[i][0], acci[i][0]);
        if (f0 + 1 < F) out[1] = make_float2(accr[i][1], acci[i][1]);
      }
    }
  }
}

using KernelFn = void (*)(const float2*, const float*, const float*, float2*,
                         int, int, int, int, int, int, int, int);

KernelFn kernel_for(int K, bool streamed) {
  if (streamed)
    return K % 2 == 0 ? complex_dense_kernel<true, true>
                      : complex_dense_kernel<false, true>;
  return K % 2 == 0 ? complex_dense_kernel<true, false>
                    : complex_dense_kernel<false, false>;
}

// let the kernel for K take SMEM_MAX shared bytes on the current device
cudaError_t allow_smem(int K, bool streamed) {
  static unsigned long long done[4] = {};   // devices, by bit
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  unsigned long long& d = done[K % 2 + 2 * streamed];
  if (d >> (dev & 63) & 1) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_for(K, streamed),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess) d |= 1ull << (dev & 63);
  return err;
}

}  // namespace

// y [M, F] = x [M, K] . (wr + i wi) [K, F] with the caller's plan: rt rows
// per item, kc weight rows staged at once, stage_elems IQ pairs a ring
// stage (or, below rt * K, the streamed mode's one [rt, kc] buffer), smem
// shared bytes, grid blocks
extern "C" int complex_dense_f32(const void* x, const void* wr, const void* wi,
                                 void* y, int M, int K, int F, int rt, int kc,
                                 int stage_elems, int smem, int grid,
                                 void* stream) {
  // ring mode: NST stages of whole row tiles; streamed mode (a stage
  // smaller than a tile): one buffer of [rt, kc] IQ pairs, kc < K
  const bool streamed = stage_elems < static_cast<long long>(rt) * K;
  const long long need = BAR_BYTES + 8LL * kc * FT +
                         8LL * (streamed ? 1 : NST) * stage_elems;
  if (M <= 0 || K <= 0 || F <= 0 || grid <= 0 || rt < 1 || rt > RT_MAX ||
      kc < 1 || kc > K || (streamed && (kc == K || stage_elems <
                                        static_cast<long long>(rt) * kc)) ||
      stage_elems % 2 || smem < need || smem > SMEM_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(K, streamed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int f_tiles = (F + FT - 1) / FT;
  kernel_for(K, streamed)<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(wr),
      static_cast<const float*>(wi), static_cast<float2*>(y), M, K, F, rt, kc,
      stage_elems, f_tiles, (M + rt - 1) / rt * f_tiles);
  return static_cast<int>(cudaGetLastError());
}

// blocks of the kernel for K (streamed or not) at `smem` shared bytes
// that one SM of the current device holds (out[0]), and the device's SMs
// (out[1])
extern "C" int complex_dense_f32_blocks_per_sm(int K, int streamed, int smem,
                                               int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = allow_smem(K, streamed);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel_for(K, streamed), THREADS, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount,
                                 dev);
  return static_cast<int>(err);
}
