// complex_dense_bf16: complex_dense's bf16 mode, y = bf16(x) @ (bf16(wr) +
// i bf16(wi)) with float32 sums, as one real GEMM on Hopper's tensor cores.
//
// Replaces the TPU kernel `_cdense_call` / `_cdense_kernel` of
// dl_ofdm_tpu/ops/pallas_kernels.py:56-88 fed bf16 operands
// (`compute_dtype='bfloat16'`, dl_ofdm_tpu/ops/complex_ops.py:108-115): four
// bf16 dots with float32 accumulation.  A product of two bf16 values is
// exact in float32, so only the order of the float32 sums differs from the
// plain version's.
//
// The work is one real GEMM in stacked form:
//   A   = x [M, K, 2] read as [M, 2K] (the IQ pairs are already interleaved);
//   W_s [2K, 2F], W_s[2k, 2f] = wr, W_s[2k, 2f+1] = wi, W_s[2k+1, 2f] = -wi,
//       W_s[2k+1, 2f+1] = wr, so that y [M, 2F] = A . W_s is y [M, F, 2].
// Two launches a call:
//   1. `pack_ws` rounds wr and wi to bf16 (nearest even; negation is exact)
//      and writes W_s transposed, K-major: ws[n][kk] = W_s[kk][n], rows of
//      ldk bf16 values (2K padded with zeros to a multiple of 8, the 16-byte
//      pitch a TMA tensor map takes).  It runs on every call: the weights
//      change every training step.  Shared-memory 32 x 32 transposes, so
//      both its reads and its writes are coalesced.
//   2. `gemm` (persistent, warp-specialized): BM x BN = 128 x 128 output
//      tiles walked blockIdx.x, + gridDim.x, ... with the N tile fastest
//      (the tiles of one row block run together and share its x rows in
//      L2).  Warpgroup 2 is the producer: it fills a ring of 4 stages, each
//      a float32 x tile (128 rows x 64 of the 2K columns, two 32-column
//      boxes, 128-byte swizzle) and a W_s tile (128 rows x 64 k, 128-byte
//      swizzle), by TMA (cp.async.bulk.tensor) on a `full` mbarrier; with K
//      odd the x row pitch (8K bytes) is not the 16 bytes TMA takes, so its
//      128 threads bring the x tile by 8-byte `cp.async`s (zero-filled past
//      the edges) into the same swizzled layout instead.  Warpgroups 0 and 1
//      are the consumers, 64 rows each.  At each k tile a consumer waits
//      for the previous k tile's wgmmas, adds their partial sums to a
//      second set of float32 registers and releases that stage on its
//      `empty` mbarrier; then each thread loads its A fragments (rows
//      warp*16 + lane/4 and +8, columns (lane%4)*2 and +8 of each k16
//      step) from the float32 tile, rounds each value once to bf16
//      (`__float22bfloat162_rn`) and issues four wgmma.mma_async
//      m64n128k16 with A from registers and W_s from shared memory, into
//      accumulators that start from zero.  The A registers are written only
//      once no wgmma is in flight: loaded while the previous k tile's
//      wgmmas still ran, registers they were still reading were overwritten
//      (wrong sums, NaN).  The tensor cores' own accumulation is coarser
//      than float32: summed there over all of K = 5,000, 7.5e-5 from
//      float64 sums where the plain version is 1.0e-6; 64 terms at a time,
//      2.9e-6, within the plain version's 1e-5.  The epilogue stores
//      float32 y, predicated at the M and 2F edges.
//   Each x value is rounded once for each N tile that reads it (2F / 128
//   times), and every warp computes rows of its own.  No split over K: each
//   output is one chain of sums in a fixed order, so two calls give the
//   same bits.
//
// Bound on an H100 at the nfft-512 sweep's call (M = 6,944, K = 640,
// F = 512; 6,944 x 1,280 x 1,024 real): 18.2 GFLOP, 0.0184 ms at the bf16
// tensor-core rate; 35.6 MB of x read and 28.4 MB of y written, 0.0199 ms
// at 3.35 TB/s: the bytes bound it.  On an H100 the GEMM takes 0.069 ms
// there (scripts/torch_cdense_bf16_trace.py); without its wgmmas 0.055,
// without any x tile 0.047: each k tile waits for the last one's wgmmas
// before issuing its own (the float32 adds and the A registers need
// that), so loads, MMAs and adds overlap only across the two consumer
// warpgroups.  The SMs pull 428 MB of operand tiles from L2 (x once for
// each of the 8 N tiles).
//
// Plain C interface for ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py).  The
// launch plan (tiles, grid, shared bytes, the TMA or cp.async x path) is
// made by the caller, `complex_dense_bf16_plan` in
// dl_ofdm_tpu_torch/ops/pallas_kernels.py, and checked here.  The tensor
// maps are encoded by `cd_bf16_tensor_map` through cuTensorMapEncodeTiled,
// looked up in the already loaded libcuda.so.1 (no link against libcuda); the caller caches them.  Launches go on the
// caller's stream; each entry point returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;   // output tile; k (of 2K) a stage
constexpr int ST = 4;                        // stages in the ring
constexpr int A_BOX = BM * 128;              // 16 KB: 32 float32 columns
constexpr int A_BYTES = 2 * A_BOX;           // the stage's x tile
constexpr int B_BYTES = BN * BK * 2;         // the stage's W_s tile, 16 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 384;                 // consumers 0-1, producer 2
constexpr int SMEM = ST * STAGE_BYTES + 1024 + 64;   // align, barriers
constexpr int CONSUMER_WARPS = 8;
constexpr int PACK_T = 32;                   // the pack's transpose tile

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

__device__ __forceinline__ void tma_2d(const CUtensorMap* map, uint32_t dst,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// byte offset of float32 column c (0..63) of tile row r in a stage's x
// tile: two boxes of 32 columns, rows of 128 bytes, the 16-byte chunks of
// row r swizzled by r % 8 (TMA's 128-byte swizzle on 1024-byte boxes)
__device__ __forceinline__ uint32_t a_offset(int r, int c) {
  return (c >> 5) * A_BOX + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         (c & 3) * 4;
}

// shared-memory matrix descriptor, 128-byte swizzle, K-major: start
// address, leading byte offset 16 (unused), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(a, b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D32(i) D8(i), D8(i + 8), D8(i + 16), D8(i + 24)

// d[64 x 128] = A[64 x 16] . B[16 x 128] (+ d unless `zero`): A (bf16
// pairs) from registers, B K-major from shared memory, float32 accumulators
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int zero) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : D32(0), D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(zero)
      : "memory");
}

#undef D32
#undef D8

// ws [2F, ldk] bf16: ws[2f][2k] = wr, ws[2f][2k+1] = -wi, ws[2f+1][2k] = wi,
// ws[2f+1][2k+1] = wr (W_s transposed), zeros for k >= K.  Block (bx, by):
// k in [32 bx, +32), f in [32 by, +32); 32 x 8 threads.
__global__ void __launch_bounds__(256)
pack_ws(const float* __restrict__ wr, const float* __restrict__ wi,
        __nv_bfloat16* __restrict__ ws, int K, int F, int ldk) {
  __shared__ float tr[PACK_T][PACK_T + 1], ti[PACK_T][PACK_T + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = blockIdx.x * PACK_T, f0 = blockIdx.y * PACK_T;
#pragma unroll
  for (int i = 0; i < PACK_T / 8; ++i) {
    const int k = k0 + ty + 8 * i, f = f0 + tx;
    float r = 0.f, q = 0.f;
    if (k < K && f < F) {
      r = __ldg(wr + static_cast<size_t>(k) * F + f);
      q = __ldg(wi + static_cast<size_t>(k) * F + f);
    }
    tr[ty + 8 * i][tx] = r;
    ti[ty + 8 * i][tx] = q;
  }
  __syncthreads();
  const int k = k0 + tx;
  if (2 * k >= ldk) return;
#pragma unroll
  for (int i = 0; i < PACK_T / 8; ++i) {
    const int f = f0 + ty + 8 * i;
    if (f >= F) continue;
    __nv_bfloat162 top, bot;
    if (k < K) {
      const __nv_bfloat16 r = __float2bfloat16_rn(tr[tx][ty + 8 * i]);
      const __nv_bfloat16 q = __float2bfloat16_rn(ti[tx][ty + 8 * i]);
      top = __halves2bfloat162(r, __hneg(q));
      bot = __halves2bfloat162(q, r);
    } else {
      top = bot = __floats2bfloat162_rn(0.f, 0.f);
    }
    *reinterpret_cast<__nv_bfloat162*>(ws + static_cast<size_t>(2 * f) * ldk +
                                       2 * k) = top;
    *reinterpret_cast<__nv_bfloat162*>(
        ws + static_cast<size_t>(2 * f + 1) * ldk + 2 * k) = bot;
  }
}

// y [M, N2] = x [M, K2] . W_s, W_s given transposed by ws's map [N2, ldk].
// TMA_A: x tiles by TMA through xmap; else by 8-byte cp.async from x.
template <bool TMA_A>
__global__ void __launch_bounds__(THREADS, 1)
gemm(const __grid_constant__ CUtensorMap xmap,
     const __grid_constant__ CUtensorMap wmap, const float* __restrict__ x,
     float* __restrict__ y, int M, int K2, int N2, int n_tiles_n,
     int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full = base + ST * STAGE_BYTES, empty = full + 8 * ST;
  const int tid = threadIdx.x, wg = tid / 128;
  const int nk = (K2 + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(full + 8 * s), "r"(TMA_A ? 1 : 1 + 128) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(empty + 8 * s), "r"(CONSUMER_WARPS) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: the ring's stages, k tile after k tile, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = tid - 256;
    if (TMA_A && ptid != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles_n) * BM, n0 = (t % n_tiles_n) * BN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % ST;
        mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
        const uint32_t sa = base + s * STAGE_BYTES, sb = sa + A_BYTES;
        const uint32_t bar = full + 8 * s;
        if (ptid == 0) {
          // the stage was last read by the consumers' generic loads
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
              :: "r"(bar), "r"(TMA_A ? STAGE_BYTES : B_BYTES) : "memory");
          if (TMA_A) {
            tma_2d(&xmap, sa, bar, kt * BK, m0);
            tma_2d(&xmap, sa + A_BOX, bar, kt * BK + 32, m0);
          }
          tma_2d(&wmap, sb, bar, kt * BK, n0);
        }
        if (!TMA_A) {
          // a warp takes 256 contiguous bytes of one row a step
          for (int e = ptid; e < BM * BK / 2; e += 128) {
            const int r = e >> 5, c = (e & 31) * 2;
            const int gr = m0 + r, gc = kt * BK + c;
            const bool in = gr < M && gc < K2;
            const float* src = in ? x + static_cast<size_t>(gr) * K2 + gc : x;
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                         :: "r"(sa + a_offset(r, c)), "l"(src),
                            "r"(in ? 8 : 0)
                         : "memory");
          }
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                       :: "r"(bar) : "memory");
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes rows wg*64 .. wg*64+63 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = tid % 32;
  const int rw = wg * 64 + (tid % 128 / 32) * 16 + lane / 4;   // and rw + 8
  const int cq = (lane % 4) * 2;                               // and cq + 8
  float acc[64];      // a k tile's sums, from the tensor cores
  float tot[64];      // the tile's sums over its k tiles, in float32
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = (t / n_tiles_n) * BM, n0 = (t % n_tiles_n) * BN;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % ST;
      mbar_wait(full + 8 * s, (it / ST) & 1);
      const unsigned char* sa = gbase + s * STAGE_BYTES;
      const uint32_t sb = base + s * STAGE_BYTES + A_BYTES;
      // the previous k tile's wgmmas are done: its partial sums join the
      // tile's, its stage goes back to the producer, and no wgmma reads
      // the A registers any more
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc[i];
        if (lane == 0)
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                       :: "r"(empty + 8 * ((it - 1) % ST)) : "memory");
      }
      // A fragments of the stage's four k16 steps, each value rounded once:
      // register h holds row rw + 8 (h & 1), columns c, c + 1 with
      // c = 16 kk + cq + 8 (h >> 1)
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 v = *reinterpret_cast<const float2*>(
              sa + a_offset(rw + 8 * (h & 1), 16 * kk + cq + 8 * (h >> 1)));
          a[kk][h] = bf16x2(v.x, v.y);
        }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, a[kk], b_desc(sb + kk * 32), kk == 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(empty + 8 * ((it - 1) % ST)) : "memory");

    // accumulator fragment: value 4j + h is row rw + 8 (h >> 1), column
    // 8j + cq + (h & 1) of the tile
    const int r0 = m0 + rw;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + cq;
      if (n >= N2) break;                  // N2 is even: n + 1 < N2 too
      if (r0 < M)
        *reinterpret_cast<float2*>(y + static_cast<size_t>(r0) * N2 + n) =
            make_float2(tot[4 * j], tot[4 * j + 1]);
      if (r0 + 8 < M)
        *reinterpret_cast<float2*>(y + static_cast<size_t>(r0 + 8) * N2 + n) =
            make_float2(tot[4 * j + 2], tot[4 * j + 3]);
    }
  }
}

// let gemm<TMA_A> take SMEM shared bytes on the current device
cudaError_t allow_smem(bool tma_a) {
  static unsigned long long done[2] = {};   // devices, by bit
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  unsigned long long& d = done[tma_a];
  if (d >> (dev & 63) & 1) return cudaSuccess;
  err = cudaFuncSetAttribute(tma_a ? gemm<true> : gemm<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err == cudaSuccess) d |= 1ull << (dev & 63);
  return err;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

}  // namespace

// W_s transposed into ws [2F, ldk] (bf16) from wr, wi [K, F] (float32)
extern "C" int cd_bf16_pack(const void* wr, const void* wi, void* ws, int K,
                            int F, int ldk, void* stream) {
  if (K <= 0 || F <= 0 || ldk < 2 * K || ldk % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ldk / 2 + PACK_T - 1) / PACK_T, (F + PACK_T - 1) / PACK_T);
  pack_ws<<<grid, dim3(PACK_T, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<__nv_bfloat16*>(ws), K, F, ldk);
  return static_cast<int>(cudaGetLastError());
}

// a 2-D tensor map (128 bytes at `out`) of `rows` rows of `cols` elements
// (float32 when bf16 == 0, else bf16), `pitch` bytes apart, read in boxes
// of box_cols x box_rows with the 128-byte swizzle, zeros past the edges;
// returns libcuda's CUresult (or cudaErrorInvalidValue without it)
extern "C" int cd_bf16_tensor_map(void* out, const void* p, int bf16,
                                  long long cols, long long rows,
                                  long long pitch, int box_cols,
                                  int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      &map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(p), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) std::memcpy(out, &map, sizeof(map));
  return static_cast<int>(r);
}

// y [M, N2] = x [M, K2] . W_s with the caller's plan: `grid` persistent
// blocks of `smem` shared bytes, x by TMA (tma_a, through xmap) or by
// cp.async; wmap is ws's map [N2 rows of ldk], boxes of 64 x 128
extern "C" int cd_bf16_gemm(const void* xmap, const void* wmap,
                            const void* x, void* y, int M, int K2, int N2,
                            int tma_a, int grid, int smem, void* stream) {
  if (M <= 0 || K2 <= 0 || K2 % 2 || N2 <= 0 || N2 % 2 || grid <= 0 ||
      smem < SMEM || (tma_a && (K2 % 4 || reinterpret_cast<uintptr_t>(x) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(tma_a != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xm, wm;
  std::memset(&xm, 0, sizeof(xm));
  if (tma_a) std::memcpy(&xm, xmap, sizeof(xm));
  std::memcpy(&wm, wmap, sizeof(wm));
  const int n_tiles_n = (N2 + BN - 1) / BN;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * n_tiles_n;
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tma_a)
    gemm<true><<<grid, THREADS, smem, st>>>(
        xm, wm, static_cast<const float*>(x), static_cast<float*>(y), M, K2,
        N2, n_tiles_n, static_cast<int>(tiles));
  else
    gemm<false><<<grid, THREADS, smem, st>>>(
        xm, wm, static_cast<const float*>(x), static_cast<float*>(y), M, K2,
        N2, n_tiles_n, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
