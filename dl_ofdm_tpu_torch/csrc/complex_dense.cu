// complex_dense: y = x @ (wr + i*wi) on IQ-interleaved float32 data.
//
// Replaces the TPU kernel `_cdense_call` / `_cdense_kernel` in
// dl_ofdm_tpu/ops/pallas_kernels.py:56-88 (the learned-DFT `fft_like`
// layer of the DCCN receiver).  It computes what that kernel computes,
//   yr = xr.wr - xi.wi,   yi = xr.wi + xi.wr,
// in float32 with float32 accumulation, but reads x as [M, K, 2] and writes
// y as [M, F, 2] directly: the JAX wrapper's split into planes and its
// final stack (pallas_kernels.py:125-137) are fused away.
//
// Bound on an H100 at the sweep's shape (M = 13776, K = 80, F = 64): 15.9 MB
// moved and 0.564 GFLOP, i.e. 4.7 us of HBM traffic against 8.4 us of
// float32 FMA work outside the tensor cores -- the operations bound it.
// This first version is a plain tiled SIMT GEMM: one block per 64x64 tile of
// (rows, features), the K axis walked in chunks staged in shared memory
// (x as float2 rows, (wr, wi) as float2 pairs), and each thread keeping a
// 4x4 tile of complex accumulators in registers.  Tensor cores (wgmma) and
// TMA are later work.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py).  The launch goes on the
// caller's stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BF = 64;        // features per block
constexpr int KC = 32;        // K chunk staged in shared memory
constexpr int TR = 4;         // rows per thread
constexpr int TF = 4;         // features per thread
constexpr int THREADS = (BM / TR) * (BF / TF);   // 256

__global__ void __launch_bounds__(THREADS)
complex_dense_kernel(const float2* __restrict__ x,    // [M, K]
                     const float* __restrict__ wr,    // [K, F]
                     const float* __restrict__ wi,    // [K, F]
                     float2* __restrict__ y,          // [M, F]
                     int M, int K, int F) {
  // +1 float2 of padding per x row keeps the 16 row-groups of a warp off
  // one bank
  __shared__ float2 xs[BM][KC + 1];
  __shared__ float2 ws[KC][BF];

  const int tid = threadIdx.x;
  const int tf = tid % (BF / TF);     // 0..15: feature lane
  const int tr = tid / (BF / TF);     // 0..15: row lane
  const int m0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BF;

  float acc_r[TR][TF];
  float acc_i[TR][TF];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TF; ++j) {
      acc_r[i][j] = 0.f;
      acc_i[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < K; k0 += KC) {
    // stage x[m0:m0+BM, k0:k0+KC] (masked: zeros past M and K)
    for (int e = tid; e < BM * KC; e += THREADS) {
      const int r = e / KC, c = e % KC;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? x[(size_t)m * K + k]
                                  : make_float2(0.f, 0.f);
    }
    // stage (wr, wi)[k0:k0+KC, f0:f0+BF]
    for (int e = tid; e < KC * BF; e += THREADS) {
      const int r = e / BF, c = e % BF;
      const int k = k0 + r, f = f0 + c;
      const bool in = k < K && f < F;
      const size_t o = (size_t)k * F + f;
      ws[r][c] = in ? make_float2(__ldg(wr + o), __ldg(wi + o))
                    : make_float2(0.f, 0.f);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float2 xv[TR], wv[TF];
#pragma unroll
      for (int i = 0; i < TR; ++i) xv[i] = xs[tr + i * (BM / TR)][kk];
#pragma unroll
      for (int j = 0; j < TF; ++j) wv[j] = ws[kk][tf + j * (BF / TF)];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TF; ++j) {
          acc_r[i][j] = fmaf(xv[i].x, wv[j].x, acc_r[i][j]);
          acc_r[i][j] = fmaf(-xv[i].y, wv[j].y, acc_r[i][j]);
          acc_i[i][j] = fmaf(xv[i].x, wv[j].y, acc_i[i][j]);
          acc_i[i][j] = fmaf(xv[i].y, wv[j].x, acc_i[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int m = m0 + tr + i * (BM / TR);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TF; ++j) {
      const int f = f0 + tf + j * (BF / TF);
      if (f < F) y[(size_t)m * F + f] = make_float2(acc_r[i][j], acc_i[i][j]);
    }
  }
}

}  // namespace

extern "C" int complex_dense_f32(const void* x, const void* wr, const void* wi,
                                 void* y, int M, int K, int F, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (F + BF - 1) / BF);
  complex_dense_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(wr),
      static_cast<const float*>(wi), static_cast<float2*>(y), M, K, F);
  return static_cast<int>(cudaGetLastError());
}
