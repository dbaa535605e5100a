// fir_shift_accum: the fading channel's per-row complex FIR over
// pre-aligned rows,
//   out[b, n] = sum_k h[b, k] * xa[b, n + F - 1 - k],   n < L,
// on separate re/im float32 planes: xa [B, L + F - 1], h [B, F],
// out [B, L].
//
// Replaces the TPU kernel `fir_shift_accum` (`_fir_kernel`) in
// dl_ofdm_tpu/ops/pallas_kernels.py:141-188 (call at :171), the Pallas form
// of the shift-and-accumulate inside `channel.fir.fir_same_iq`.  In the
// port it is that loop on the card: `fir_same_iq` launches it once per call
// in place of 4-8 elementwise launches per tap.
//
// Bound on an H100: the bytes.  At the sweep's shape (B = 30,000,
// L = 560, F = 13) the two input planes, the taps and the two output planes
// are 0.27 GB, 0.08 ms at 3.35 TB/s, against 1.7 GFLOP of float32 work
// (0.03 ms outside the tensor cores).  So the design reads each input once
// and writes each output once, coalesced:
//   * a block takes ROWS rows and walks them in chunks of `tile` outputs;
//     for each chunk it stages the rows' tile + F - 1 input samples of
//     both planes in shared memory (the taps once per block), and every
//     thread then makes outputs at consecutive positions of one row, so a
//     warp's loads from shared memory and its stores are contiguous;
//   * taps are taken in ascending order with explicit __fmul_rn /
//     __fadd_rn / __fsub_rn in the plain version's order,
//       acc_r = (acc_r + sr*hr) - si*hi,  acc_i = (acc_i + sr*hi) + si*hr,
//     so no multiply-add is contracted and the kernel rounds as the plain
//     PyTorch loop does.
// No tensor cores and no TMA: nothing here is a product of matrices, and a
// plain coalesced copy already moves the bytes.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py).  The launch goes on the
// caller's stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>

struct FirArgs {
  const float* xar;   // [B, La] pre-aligned rows, real plane
  const float* xai;   // [B, La] imaginary plane
  const float* hr;    // [B, F] taps, real
  const float* hi;    // [B, F] taps, imaginary
  float* yr;          // [B, L]
  float* yi;          // [B, L]
  int B, L, F, tile;  // La = L + F - 1; tile: outputs per chunk of a row
};

namespace {

constexpr int ROWS = 4;        // rows per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) fir_shift_accum_kernel(FirArgs a) {
  extern __shared__ float smem[];
  const int F = a.F, L = a.L, tile = a.tile;
  const int La = L + F - 1;
  const int W = tile + F - 1;               // staged samples per row
  float* xs_r = smem;                       // [ROWS][W]
  float* xs_i = xs_r + ROWS * W;            // [ROWS][W]
  float* h_r = xs_i + ROWS * W;             // [ROWS][F]
  float* h_i = h_r + ROWS * F;              // [ROWS][F]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * ROWS;

  for (int e = tid; e < ROWS * F; e += THREADS) {
    const int r = e / F, k = e % F;
    const int b = b0 + r;
    const bool in = b < a.B;
    h_r[e] = in ? __ldg(a.hr + (size_t)b * F + k) : 0.f;
    h_i[e] = in ? __ldg(a.hi + (size_t)b * F + k) : 0.f;
  }

  for (int n0 = 0; n0 < L; n0 += tile) {
    __syncthreads();      // the previous chunk's reads are done
    for (int e = tid; e < ROWS * W; e += THREADS) {
      const int r = e / W, m = e % W;
      const int b = b0 + r, col = n0 + m;
      const bool in = b < a.B && col < La;
      const size_t o = (size_t)b * La + col;
      xs_r[e] = in ? __ldg(a.xar + o) : 0.f;
      xs_i[e] = in ? __ldg(a.xai + o) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < ROWS * tile; e += THREADS) {
      const int r = e / tile, n = e % tile;
      const int b = b0 + r;
      if (b >= a.B || n0 + n >= L) continue;
      const float* xr = xs_r + r * W + n + F - 1;   // xa[b, n0 + n + F - 1]
      const float* xi = xs_i + r * W + n + F - 1;
      const float* hr = h_r + r * F;
      const float* hi = h_i + r * F;
      float acc_r = 0.f, acc_i = 0.f;
      for (int k = 0; k < F; ++k) {
        const float sr = xr[-k], si = xi[-k];
        const float tr = hr[k], ti = hi[k];
        acc_r = __fsub_rn(__fadd_rn(acc_r, __fmul_rn(sr, tr)),
                          __fmul_rn(si, ti));
        acc_i = __fadd_rn(__fadd_rn(acc_i, __fmul_rn(sr, ti)),
                          __fmul_rn(si, tr));
      }
      const size_t o = (size_t)b * L + n0 + n;
      a.yr[o] = acc_r;
      a.yi[o] = acc_i;
    }
  }
}

}  // namespace

// Dynamic shared memory a launch with these sizes needs, in bytes.
extern "C" long long fir_shift_accum_smem(int F, int tile) {
  return (long long)sizeof(float) * ROWS * (2LL * (tile + F - 1) + 2LL * F);
}

extern "C" int fir_shift_accum_f32(const FirArgs* args, void* stream) {
  const FirArgs a = *args;
  const long long smem = fir_shift_accum_smem(a.F, a.tile);
  if (a.B <= 0 || a.L <= 0 || a.F <= 0 || a.tile <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fir_shift_accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = (a.B + ROWS - 1) / ROWS;
  fir_shift_accum_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
