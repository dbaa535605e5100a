// fused_model: the DCCN receiver's forward pass, cross-entropy, backward
// pass and confusion counts for one training batch.
//
// Replaces the TPU kernel `_kernel` of dl_ofdm_tpu/ops/fused_model.py
// (lines 117-307, pallas_call at 417), with fuse_norm=True: its inputs are
// the raw signal and noise planes of the fused synthesize kernel and the
// per-position affine x = y*c0 + n*c1 - c2 (c3..c5 for the imaginary
// plane) that normalizes them.  It returns the gradients of the mean
// per-bit CE with respect to every parameter, the CE sum and the counts
// [n11, sum y, sum pred].
//
// The TPU kernel keeps every weight and activation of a frame block in
// VMEM and adds into its gradient outputs from one sequential grid step to
// the next.  Neither carries over: Dense_extract alone (896 x 640 f32,
// 2.3 MB) is ten times a block's shared memory, and blocks run in
// parallel.  So the step is a few launches from this file, with
// activations in device memory:
//   0. the biases and head parameters packed from torch's layouts;
//   1. x2 = fft_like(affine(y, n))  [B*S, 2F]: a real GEMM with K = 2*sps
//      against the complex weight expanded to [[wr, wi], [-wi, wr]]
//      (columns interleaved f*2+iq, flax's layout of the flattened fft_out);
//   2. e  = x2 . We^T + be          [B, 2D]  (We is torch's [2D, S*2F]);
//   3. the head per (frame, d): conv1x1, leaky, llr, CE, dlogits and the
//      head's backward -> de [B, 2D], per-block head-gradient partials and
//      counts, summed in a fixed order into the head's gradients, the mean
//      CE and the confusion matrix;
//   4. dWe = de^T . x2, split over frames into partials, summed in a fixed
//      order by a second pass (no float atomics: deterministic);
//   5. dX2 = de . We;
//   6. dWexp = affine(y, n)^T . dX2 split over rows, summed and folded
//      into dwr and dwi; the bias gradients are column sums, split and
//      summed the same way.
// Every product is computed here, none by a library.
//
// Two GEMM routes, picked by round_bf16:
//   * bfloat16 (`matmul_dtype='bfloat16'`, the training default): every
//     GEMM input is rounded to bf16 (nearest even) once, sums stay f32 --
//     the contract of the TPU kernel's bf16 dots.  The inputs are stored in
//     bf16 the moment they are made: a prologue writes affine(y, n) [B*S,
//     2P], Wexp and We; GEMM 1's epilogue writes x2, the head de, GEMM 5's
//     epilogue dX2.  TMA takes row pitches of whole 16 bytes, so each bf16
//     row is padded to a multiple of 8 elements: 2P to ldx, 2D to ldd, and
//     every run of 2F values (a symbol of x2, dX2, a row of Wexp, a
//     symbol's columns of We) to ldf, with zeros in the padding where a
//     GEMM sums over it (GEMM 2 reads x2 and We as [., S*ldf]).
//     The five GEMMs run on the tensor cores: one templated kernel, 128 x
//     128 output tiles, two consumer warpgroups issuing
//     wgmma.mma_async m64n128k16 (f32 accumulators in registers) on a ring
//     of three 64-deep shared-memory stages that TMA fills
//     (cuTensorMapEncodeTiled, 128-byte swizzle) and signals on mbarriers.
//     M-major A (GEMMs 4, 6) and N-major B (GEMMs 1, 4, 5, 6) use wgmma's
//     transpose bits.  Split-K partials (GEMMs 4 and 6) are summed in a
//     fixed order, so two calls give bit-identical gradients.
//   * float32: a tiled SIMT GEMM on the FMA units, products in true f32
//     (wgmma in f32 would be TF32).
//
// Bound on an H100 at 9,362 frames: 4.01 MFLOP per frame, 37.6 GFLOP in
// all: 0.038 ms on bf16 tensor cores (989 TFLOP/s), 0.56 ms at the float32
// FMA rate (67 TFLOP/s); the ~96 MB of planes and gradients take
// 0.029 ms.  The bf16 route moves a further ~90 MB of bf16 activations and
// f32 split partials through device memory between its launches.
//
// Plain C interface for ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py); all
// launches go on the caller's stream and the function returns the first
// cudaGetLastError() that is not cudaSuccess.  The tensor maps are encoded
// on the host through the driver's cuTensorMapEncodeTiled, looked up in the
// already loaded libcuda.so.1 (no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>

// the arguments, filled field for field by a ctypes.Structure; outside the
// anonymous namespace, so that the extern "C" entry point keeps external
// linkage
struct ModelArgs {
  const float *yr, *yi, *nr, *ni, *cvec;   // raw planes [B, L], affine [6, L]
  const int* idx;                          // [B, D] symbol indices
  const float *wr, *wi, *br, *bi;          // fft_like [sps, F], [F], [F]
  const float *we, *be;                    // Dense_extract [2D, S*2F], [2D]
  const float *wc, *bc, *wl, *bl;          // Dense_conv1x1 [C, 2], [C] and
                                           // Dense_llr [2n, C+2], [2n]
  float *fb, *hp;                          // packed bias [2F], head params
  float *x2, *e, *de, *dx2;                // activations
  float *part_we, *part_w, *part_be, *part_fb, *hpart;   // split partials
  int* cpart;
  float *dwe, *dwr, *dwi, *dbe, *dfb, *dhead;   // gradients (dhead: H + 1)
  float* ce;                               // mean CE
  long long* conf;                         // [2, 2] bits: [true, pred]
  // bf16 route: GEMM inputs [B*S, ldx], [2P, ldf], [2D, S*ldf],
  // [B, S*ldf], [B, ldd], [B, S*ldf]
  __nv_bfloat16 *xb, *wexpb, *web, *x2b, *deb, *dx2b;
  int B, S, P, F, D, nbits, splits_we, splits_w, splits_be, splits_fb,
      head_blocks, round_bf16;
  int ldx, ldd, ldf, ktps_we, ktps_w;   // bf16 pitches, k tiles per split
};

namespace {

// ---------------------------------------------------------------------------
// operands: (row, col) -> float, with which index is contiguous in memory
// ---------------------------------------------------------------------------

struct RowMajor {           // p[r * ld + c]
  const float* p;
  int ld;
  static constexpr bool kInner = true;
  __device__ float operator()(int r, int c) const {
    return __ldg(p + static_cast<size_t>(r) * ld + c);
  }
};

struct ColMajor {           // p[c * ld + r]
  const float* p;
  int ld;
  static constexpr bool kInner = false;
  __device__ float operator()(int r, int c) const {
    return __ldg(p + static_cast<size_t>(c) * ld + r);
  }
};

// The normalized receiver input as [B*S, 2*sps]: row b*S+s holds symbol s
// of frame b, its real samples then its imaginary samples.  Evaluated as
// torch evaluates yr*c0 + nr*c1 - c2: each operation rounded on its own.
struct AffineX {
  const float *yr, *yi, *nr, *ni, *cv;   // planes [B, L], cv [6, L]
  int S, P, L;
  static constexpr bool kInner = true;
  __device__ float operator()(int m, int k) const {
    const int b = m / S, s = m - b * S;
    const int iq = k >= P, pos = s * P + (k - iq * P);
    const size_t o = static_cast<size_t>(b) * L + pos;
    const float* y = iq ? yi : yr;
    const float* n = iq ? ni : nr;
    const float* c = cv + 3 * iq * L;
    return __fsub_rn(__fadd_rn(__fmul_rn(__ldg(y + o), __ldg(c + pos)),
                               __fmul_rn(__ldg(n + o), __ldg(c + L + pos))),
                     __ldg(c + 2 * L + pos));
  }
};

template <class T>
struct Transposed {
  T t;
  static constexpr bool kInner = !T::kInner;
  __device__ float operator()(int r, int c) const { return t(c, r); }
};

// fft_like's complex weight as a real [2*sps, 2F] matrix: rows k < sps are
// (wr, wi) of input k's real part, rows k >= sps (-wi, wr) of its
// imaginary part; column f*2+iq is output f's real (iq 0) or imaginary part
struct CplxW {
  const float *wr, *wi;     // [sps, F]
  int P, F;
  static constexpr bool kInner = true;
  __device__ float operator()(int k, int n) const {
    const int f = n >> 1, iq = n & 1, top = k < P;
    const size_t o = static_cast<size_t>(top ? k : k - P) * F + f;
    if (top) return __ldg(iq ? wi + o : wr + o);
    return iq ? __ldg(wr + o) : -__ldg(wi + o);
  }
};

// ---------------------------------------------------------------------------
// the float32 route's GEMM on the FMA units: C[z] = A[:, kz] . B[kz, :]
// (+ bias), split z over K
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);   // 256

// C is [gridDim.z, M, ldc]; block z sums k in [z*kchunk, (z+1)*kchunk)
template <class LA, class LB>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(LA A, LB B, float* __restrict__ C, const float* __restrict__ bias,
            int M, int N, int K, int kchunk, int ldc) {
  __shared__ float as[BK][BM + 4];
  __shared__ float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN), tm = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / GEMM_THREADS; ++q) {
      const int e = tid + q * GEMM_THREADS;
      const int kk = LA::kInner ? e % BK : e / BM;
      const int mm = LA::kInner ? e / BK : e % BM;
      const int m = m0 + mm, k = k0 + kk;
      as[kk][mm] = (m < M && k < kend) ? A(m, k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < BN * BK / GEMM_THREADS; ++q) {
      const int e = tid + q * GEMM_THREADS;
      const int nn = LB::kInner ? e % BN : e / BK;
      const int kk = LB::kInner ? e / BN : e % BK;
      const int n = n0 + nn, k = k0 + kk;
      bs[kk][nn] = (n < N && k < kend) ? B(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][tm + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tn + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = C + static_cast<size_t>(blockIdx.z) * M * ldc;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + j * (BN / TN);
      if (n < N)
        out[static_cast<size_t>(m) * ldc + n] =
            acc[i][j] + (bias ? __ldg(bias + n) : 0.f);
    }
  }
}

template <class LA, class LB>
cudaError_t gemm(LA a, LB b, float* c, const float* bias, int M, int N,
                 int K, int splits, int ldc, cudaStream_t st) {
  const int kchunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  gemm_kernel<LA, LB><<<grid, GEMM_THREADS, 0, st>>>(a, b, c, bias, M, N, K,
                                                    kchunk, ldc);
  return cudaGetLastError();
}

// out[i] = sum_z part[z * n + i], z in order
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ out, int nz, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  // unrolled for loads in flight; the adds keep their order
#pragma unroll 8
  for (int z = 0; z < nz; ++z) s += part[static_cast<size_t>(z) * n + i];
  out[i] = s;
}

// part[z, c] = sum of x[r, c] over the rows of split z
__global__ void colsum_splits(const float* __restrict__ x,
                              float* __restrict__ part, int rows, int cols,
                              int rchunk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rchunk, r1 = min(rows, r0 + rchunk);
  float s = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) s += x[static_cast<size_t>(r) * cols + c];
  part[static_cast<size_t>(blockIdx.y) * cols + c] = s;
}

// fft_like's gradient from the split partials of dWexp [2P, 2F]: each
// entry summed over z in order (as reduce_splits), then folded,
// dwr = top[:, 0::2] + bottom[:, 1::2], dwi = top[:, 1::2] - bottom[:, 0::2]
__global__ void reduce_fold(const float* __restrict__ part,
                            float* __restrict__ dwr, float* __restrict__ dwi,
                            int nz, int P, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * F) return;
  const int p = i / F, f = i - p * F;
  const size_t n = static_cast<size_t>(4) * P * F;
  const size_t t = static_cast<size_t>(p) * 2 * F + 2 * f;
  const size_t u = static_cast<size_t>(P + p) * 2 * F + 2 * f;
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll 4
  for (int z = 0; z < nz; ++z) {
    const float* q = part + z * n;
    s00 += q[t];
    s01 += q[t + 1];
    s10 += q[u];
    s11 += q[u + 1];
  }
  dwr[i] = s00 + s11;
  dwi[i] = s01 - s10;
}

// fb [2F] = (br, bi) interleaved; hp = wc [2][C], bc [C], wl [C+2][2n],
// bl [2n] (flax's layouts) from torch's [C, 2] and [2n, C+2] weights
__global__ void pack_params(const float* __restrict__ br,
                            const float* __restrict__ bi,
                            const float* __restrict__ wc,
                            const float* __restrict__ bc,
                            const float* __restrict__ wl,
                            const float* __restrict__ bl,
                            float* __restrict__ fb, float* __restrict__ hp,
                            int F, int C, int J) {
  const int CH = C + 2, OBC = 2 * C, OWL = 3 * C, OBL = OWL + CH * J;
  for (int i = threadIdx.x; i < 2 * F; i += blockDim.x)
    fb[i] = (i & 1) ? bi[i >> 1] : br[i >> 1];
  for (int i = threadIdx.x; i < OBL + J; i += blockDim.x) {
    float v;
    if (i < OBC) {
      v = wc[(i % C) * 2 + i / C];
    } else if (i < OWL) {
      v = bc[i - OBC];
    } else if (i < OBL) {
      const int r = i - OWL;
      v = wl[(r % J) * CH + r / J];
    } else {
      v = bl[i - OBL];
    }
    hp[i] = v;
  }
}

constexpr int FIN_THREADS = 256;

// Block i <= H: dhead[i] = the sum of the head blocks' partials of value
// i (thread t sums blocks t, t + 256, ... in order, then a fixed tree);
// block H also writes the mean CE.  Block H + 1: the counts, then the
// confusion matrix.  A fixed order: two calls give the same bits.
__global__ void __launch_bounds__(FIN_THREADS)
head_finish(const float* __restrict__ hpart, const int* __restrict__ cpart,
            float* __restrict__ dhead, float* __restrict__ ce,
            long long* __restrict__ conf, int nblk, int H, long long total) {
  __shared__ float fred[FIN_THREADS / 32];
  __shared__ long long ired[FIN_THREADS / 32][3];
  const int i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  if (i <= H) {
    float s = 0.f;
    for (int z = tid; z < nblk; z += FIN_THREADS)
      s += hpart[static_cast<size_t>(z) * (H + 1) + i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) fred[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < FIN_THREADS / 32; ++w) t += fred[w];
      dhead[i] = t;
      if (i == H) *ce = t / static_cast<float>(total);
    }
    return;
  }
  long long c[3] = {0, 0, 0};
  for (int z = tid; z < nblk; z += FIN_THREADS)
    for (int k = 0; k < 3; ++k) c[k] += cpart[z * 3 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      c[k] += __shfl_xor_sync(0xffffffffu, c[k], o);
    if (lane == 0) ired[warp][k] = c[k];
  }
  __syncthreads();
  if (tid == 0) {
    long long n[3] = {0, 0, 0};
    for (int w = 0; w < FIN_THREADS / 32; ++w)
      for (int k = 0; k < 3; ++k) n[k] += ired[w][k];
    const long long n11 = n[0], n10 = n[1] - n11, n01 = n[2] - n11;
    conf[0] = total - n11 - n10 - n01;
    conf[1] = n01;
    conf[2] = n10;
    conf[3] = n11;
  }
}

// ---------------------------------------------------------------------------
// the head: conv1x1 + leaky + llr + CE + dlogits + head backward
// ---------------------------------------------------------------------------

constexpr int HEAD_THREADS = 256;
constexpr int HEAD_ITEMS = 8;      // (frame, d) elements per thread

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : __fmul_rn(0.2f, x);
}
__device__ __forceinline__ float dleaky(float x) { return x >= 0.f ? 1.f : 0.2f; }
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// packed head parameters (flax layouts): wc [2][C], bc [C], wl [C+2][2n],
// bl [2n]; the per-block partials keep the same order, then the CE sum
template <int NB>
__global__ void __launch_bounds__(HEAD_THREADS)
head_kernel(const float* __restrict__ e, const int* __restrict__ idx,
            const float* __restrict__ hp, float* __restrict__ de,
            __nv_bfloat16* __restrict__ deb, int ldd,
            float* __restrict__ hpart, int* __restrict__ cpart, int n_elem,
            int D, float gscale) {
  constexpr int C = 1 << NB, J = 2 * NB, CH = C + 2;
  constexpr int OWC = 0, OBC = 2 * C, OWL = 3 * C, OBL = OWL + CH * J;
  constexpr int H = OBL + J;              // head-gradient values
  __shared__ float w[H];
  __shared__ float red[HEAD_THREADS / 32][H + 1];
  __shared__ int cred[HEAD_THREADS / 32][3];
  const int tid = threadIdx.x;
  for (int i = tid; i < H; i += HEAD_THREADS) w[i] = hp[i];
  __syncthreads();

  float g[H + 1];
#pragma unroll
  for (int i = 0; i <= H; ++i) g[i] = 0.f;
  int n11 = 0, sy = 0, sp = 0;
  for (int it = 0; it < HEAD_ITEMS; ++it) {
    const int el = (blockIdx.x * HEAD_ITEMS + it) * HEAD_THREADS + tid;
    if (el >= n_elem) break;
    const float2 ev = *reinterpret_cast<const float2*>(e + 2 * static_cast<size_t>(el));
    const float er = ev.x, ei = ev.y;
    const int code = idx[el];
    // the head's pre-activations in the plain version's order of
    // operations, each rounded on its own: from the same e, both take the
    // same side of every leaky kink and of every decision t > 0
    float pre_h[C], ch[CH];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      pre_h[c] = __fadd_rn(__fadd_rn(__fmul_rn(er, w[OWC + c]),
                                     __fmul_rn(ei, w[OWC + C + c])),
                           w[OBC + c]);
      ch[c] = leaky(pre_h[c]);
    }
    ch[C] = er;
    ch[C + 1] = ei;
    float pre_l[J], dpre[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float s = __fadd_rn(w[OBL + j], __fmul_rn(ch[0], w[OWL + j]));
#pragma unroll
      for (int c = 1; c < CH; ++c)
        s = __fadd_rn(s, __fmul_rn(ch[c], w[OWL + c * J + j]));
      pre_l[j] = s;
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      const float t = __fsub_rn(leaky(pre_l[2 * bb + 1]), leaky(pre_l[2 * bb]));
      const int bit = (code >> (NB - 1 - bb)) & 1;
      g[H] += bit ? softplus(-t) : softplus(t);
      const int pred = t > 0.f;
      n11 += bit & pred;
      sy += bit;
      sp += pred;
      const float g1 = (1.f / (1.f + expf(-t)) - bit) * gscale;
      dpre[2 * bb + 1] = g1 * dleaky(pre_l[2 * bb + 1]);
      dpre[2 * bb] = -g1 * dleaky(pre_l[2 * bb]);
    }
    // llr backward
    float dch[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        g[OWL + c * J + j] += ch[c] * dpre[j];
        s += dpre[j] * w[OWL + c * J + j];
      }
      dch[c] = s;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) g[OBL + j] += dpre[j];
    // conv1x1 backward
    float der = dch[C], dei = dch[C + 1];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float dh = dch[c] * dleaky(pre_h[c]);
      g[OWC + c] += er * dh;
      g[OWC + C + c] += ei * dh;
      g[OBC + c] += dh;
      der += dh * w[OWC + c];
      dei += dh * w[OWC + C + c];
    }
    *reinterpret_cast<float2*>(de + 2 * static_cast<size_t>(el)) =
        make_float2(der, dei);
    if (deb) {     // the bf16 route's GEMM input, rounded once
      const int b = el / D;
      *reinterpret_cast<__nv_bfloat162*>(
          deb + static_cast<size_t>(b) * ldd + 2 * (el - b * D)) =
          __floats2bfloat162_rn(der, dei);
    }
  }
  // block sums in a fixed order: warp tree, then warps in order
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i <= H; ++i) {
    float v = g[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][i] = v;
  }
  int cv[3] = {n11, sy, sp};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int v = cv[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) cred[warp][i] = v;
  }
  __syncthreads();
  for (int i = tid; i <= H; i += HEAD_THREADS) {
    float s = 0.f;
    for (int k = 0; k < HEAD_THREADS / 32; ++k) s += red[k][i];
    hpart[static_cast<size_t>(blockIdx.x) * (H + 1) + i] = s;
  }
  if (tid < 3) {
    int s = 0;
    for (int k = 0; k < HEAD_THREADS / 32; ++k) s += cred[k][tid];
    cpart[blockIdx.x * 3 + tid] = s;
  }
}

template <int NB>
cudaError_t launch_head(const ModelArgs& a, cudaStream_t st) {
  // 1 / (n_frames * D * nbits), rounded once to float32 as in JAX
  const float gscale = static_cast<float>(1.0 / (static_cast<double>(a.B) * a.D * NB));
  head_kernel<NB><<<a.head_blocks, HEAD_THREADS, 0, st>>>(
      a.e, a.idx, a.hp, a.de, a.round_bf16 ? a.deb : nullptr, a.ldd,
      a.hpart, a.cpart, a.B * a.D, a.D, gscale);
  return cudaGetLastError();
}

cudaError_t reduce(const float* part, float* out, int nz, int n,
                   cudaStream_t st) {
  reduce_splits<<<(n + 255) / 256, 256, 0, st>>>(part, out, nz, n);
  return cudaGetLastError();
}

cudaError_t colsum(const float* x, float* part, float* out, int rows,
                   int cols, int splits, cudaStream_t st) {
  const int rchunk = (rows + splits - 1) / splits;
  colsum_splits<<<dim3((cols + 127) / 128, splits), 128, 0, st>>>(
      x, part, rows, cols, rchunk);
  cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : reduce(part, out, splits, cols, st);
}

// ---------------------------------------------------------------------------
// the bf16 route: tensor-core GEMMs (wgmma) fed by TMA
// ---------------------------------------------------------------------------

constexpr int TBM = 128, TBN = 128, TBK = 64;   // output tile, k depth
constexpr int TST = 3;                          // stages in the ring
constexpr int TC_THREADS = 256;                 // two consumer warpgroups
constexpr int TILE_BYTES = TBM * TBK * 2;       // 16 KB: A or B of a stage
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int BOX_BYTES = 64 * 64 * 2;          // one 64 x 64 MN-major box
constexpr int TC_SMEM = TST * STAGE_BYTES + 1024 + 64;   // align, barriers

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

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], bf16 in, f32 accumulators; TA /
// TB: A M-major, B N-major in shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// epilogues: (split z, row m, even column n, values at n and n + 1)
struct EpiBf16Bias {          // GEMM 1: x2 = acc + fb, stored in bf16; the
  __nv_bfloat16* out;         // pitch's padding (columns w .. ld) gets zeros
  const float* bias;
  int ld, w;
  __device__ void operator()(int, int m, int n, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * ld + n) =
        n < w ? __floats2bfloat162_rn(v0 + __ldg(bias + n),
                                      v1 + __ldg(bias + n + 1))
              : __floats2bfloat162_rn(0.f, 0.f);
  }
};

// a column n of runs of `w` values on a pitch of `ldp` (w, ldp even) -> its
// column in the unpadded layout, or -1 in the padding
__device__ __forceinline__ int unpad(int n, int w, int ldp) {
  if (w == ldp) return n;
  const int s = n / ldp, f = n - s * ldp;
  return f < w ? s * w + f : -1;
}

struct EpiF32Bias {           // GEMM 2: e = acc + be
  float* out;
  const float* bias;
  int ld;
  __device__ void operator()(int, int m, int n, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * ld + n) =
        make_float2(v0 + __ldg(bias + n), v1 + __ldg(bias + n + 1));
  }
};

struct EpiSplit {             // GEMMs 4, 6: split z's partial, [M, ld]
  float* out;                 // unpadded (runs of w columns on pitch ldp)
  int ld;
  size_t zstride;
  int w, ldp;
  __device__ void operator()(int z, int m, int n, float v0, float v1) const {
    const int c = unpad(n, w, ldp);
    if (c < 0) return;
    *reinterpret_cast<float2*>(out + z * zstride +
                               static_cast<size_t>(m) * ld + c) =
        make_float2(v0, v1);
  }
};

struct EpiF32Bf16 {           // GEMM 5: dX2 in f32 [M, ld] (for dfb) and in
  float* out;                 // bf16 on the padded pitch ldb
  __nv_bfloat16* outb;
  int ld, ldb, w, ldp;
  __device__ void operator()(int, int m, int n, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(outb + static_cast<size_t>(m) * ldb +
                                       n) = __floats2bfloat162_rn(v0, v1);
    const int c = unpad(n, w, ldp);
    if (c >= 0)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * ld + c) =
          make_float2(v0, v1);
  }
};

// C[z] = A[:, kz] . B[kz, :] over k tiles [z*ktps, (z+1)*ktps).  A is
// K-major ([M, K] in memory; TMA box 64 k x 128 rows) or, with AMN,
// M-major ([K, M]; two boxes of 64 m x 64 k); B is K-major ([N, K]) or,
// with BMN, N-major ([K, N]).  TMA fills reads past the edges with zeros,
// so ragged M, N and K need no masks until the epilogue's stores.
template <bool AMN, bool BMN, class Epi>
__global__ void __launch_bounds__(TC_THREADS)
tc_gemm_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, Epi epi, int M, int N,
               int K, int ktps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + TST * STAGE_BYTES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  const int kt0 = blockIdx.z * ktps;
  const int nk = min((K + TBK - 1) / TBK - kt0, ktps);

  if (tid == 0) {
    for (int s = 0; s < TST; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(bars + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* pa = &ta;
  const CUtensorMap* pb = &tb;
  auto load = [=](int s, int kt) {      // thread 0: stage s <- k tile kt
    const uint32_t sa = base + s * STAGE_BYTES, sb = sa + TILE_BYTES;
    const uint32_t bar = bars + 8 * s;
    const int k = kt * TBK;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(STAGE_BYTES) : "memory");
    if (AMN) {
      tma_2d(pa, sa, bar, m0, k);
      tma_2d(pa, sa + BOX_BYTES, bar, m0 + 64, k);
    } else {
      tma_2d(pa, sa, bar, k, m0);
    }
    if (BMN) {
      tma_2d(pb, sb, bar, n0, k);
      tma_2d(pb, sb + BOX_BYTES, bar, n0 + 64, k);
    } else {
      tma_2d(pb, sb, bar, k, n0);
    }
  };
  if (tid == 0)
    for (int s = 0; s < TST && s < nk; ++s) load(s, kt0 + s);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % TST;
    mbar_wait(bars + 8 * s, (i / TST) & 1);
    const uint32_t sa = base + s * STAGE_BYTES, sb = sa + TILE_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      // K-major: rows of 128 bytes, 8-row groups 1024 bytes apart, a k16
      // step 32 bytes along the row; MN-major: k rows of 128 bytes, the
      // second 64-wide box 8 KB on, a k16 step 16 rows down
      const uint64_t da =
          AMN ? smem_desc(sa + wg * BOX_BYTES + kk * 2048, BOX_BYTES, 1024)
              : smem_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = BMN ? smem_desc(sb + kk * 2048, BOX_BYTES, 1024)
                              : smem_desc(sb + kk * 32, 16, 1024);
      wgmma_m64n128k16<AMN, BMN>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // keep this k tile's wgmmas in flight; the previous tile's are done,
    // and once both warpgroups say so its stage takes tile i - 1 + TST
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && i >= 1 && i - 1 + TST < nk)
      load((i - 1) % TST, kt0 + i - 1 + TST);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // accumulator fragment: value 4j + h of a thread is row warp*16 + lane/4
  // (+8 for h >= 2), column 8j + 2*(lane%4) + (h & 1) of its warpgroup's
  // 64 x 128 tile
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < TBN / 8; ++j) {
    const int n = n0 + j * 8 + (lane % 4) * 2;
    if (n >= N) continue;               // N is even: n + 1 < N too
    if (row < M) epi(blockIdx.z, row, n, acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < M) epi(blockIdx.z, row + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <bool AMN, bool BMN, class Epi>
cudaError_t tc_gemm(const CUtensorMap& ta, const CUtensorMap& tb, Epi epi,
                    int M, int N, int K, int splits, int ktps,
                    cudaStream_t st) {
  auto kernel = tc_gemm_kernel<AMN, BMN, Epi>;
  static unsigned long long attr_set = 0;   // devices done, by bit
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(attr_set >> (dev & 63) & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err == cudaSuccess) attr_set |= 1ull << (dev & 63);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((M + TBM - 1) / TBM, (N + TBN - 1) / TBN, splits);
  kernel<<<grid, TC_THREADS, TC_SMEM, st>>>(ta, tb, epi, M, N, K, ktps);
  return cudaGetLastError();
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

// a bf16 matrix of `rows` rows of `cols` elements, `pitch` elements apart,
// read in boxes of box_cols x box_rows with the 128-byte swizzle
bool tensor_map(CUtensorMap* map, const void* p, int cols, int rows,
                int pitch, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(p), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the operand maps: K-major in boxes of 64 k x 128 rows, MN-major in boxes
// of 64 x 64
bool kmajor_map(CUtensorMap* m, const void* p, int k, int rows, int pitch) {
  return tensor_map(m, p, k, rows, pitch, TBK, 128);
}
bool mnmajor_map(CUtensorMap* m, const void* p, int mn, int k, int pitch) {
  return tensor_map(m, p, mn, k, pitch, 64, TBK);
}

// xb [BS, ldx] = bf16(affine(y, n)), zeros in the pitch's padding
__global__ void affine_bf16(AffineX x, __nv_bfloat162* __restrict__ xb,
                            int P2, int ldx, size_t pairs) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < pairs; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(2 * i / ldx);
    const int k = static_cast<int>(2 * i - static_cast<size_t>(m) * ldx);
    xb[i] = __floats2bfloat162_rn(k < P2 ? x(m, k) : 0.f,
                                  k + 1 < P2 ? x(m, k + 1) : 0.f);
  }
}

// the weights in bf16, each run of 2F values on a pitch of ldf with zeros
// in the padding: Wexp [2P, ldf] (CplxW), then We [2D, S*ldf]
__global__ void weights_bf16(CplxW w, const float* __restrict__ we,
                             __nv_bfloat16* __restrict__ wexpb,
                             __nv_bfloat16* __restrict__ web, int P2, int F2,
                             int ldf, int we_runs) {
  const int n_w = P2 * ldf;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;
       i < n_w + we_runs * ldf; i += gridDim.x * blockDim.x) {
    const int j = i < n_w ? i : i - n_w;
    const int r = j / ldf, c = j - r * ldf;
    float v = 0.f;
    if (c < F2) v = i < n_w ? w(r, c) : __ldg(we + r * F2 + c);
    (i < n_w ? wexpb : web)[j] = __float2bfloat16_rn(v);
  }
}

// variadic: a template argument list's commas stay inside the call
#define CHECK(...)                                \
  do {                                            \
    const cudaError_t err_ = (__VA_ARGS__);       \
    if (err_ != cudaSuccess) return err_;         \
  } while (0)

cudaError_t launch_head_nb(const ModelArgs& a, cudaStream_t st) {
  switch (a.nbits) {
    case 1: return launch_head<1>(a, st);
    case 2: return launch_head<2>(a, st);
    case 3: return launch_head<3>(a, st);
    default: return launch_head<4>(a, st);
  }
}

// the tensor maps of the bf16 route's GEMM operands
struct Maps {
  CUtensorMap xk, xm, wexpn, x2k, x2n, wek, wen, dem, dek, dx2n;
};

// (x2, We and dX2 on their padded pitches: X2p = S*ldf columns)
bool make_maps(const ModelArgs& a, Maps* m) {
  const int BS = a.B * a.S, X2p = a.S * a.ldf, E = 2 * a.D;
  const int P2 = 2 * a.P, F2 = 2 * a.F;
  return kmajor_map(&m->xk, a.xb, P2, BS, a.ldx) &&
         mnmajor_map(&m->xm, a.xb, P2, BS, a.ldx) &&
         mnmajor_map(&m->wexpn, a.wexpb, F2, P2, a.ldf) &&
         kmajor_map(&m->x2k, a.x2b, X2p, a.B, X2p) &&
         mnmajor_map(&m->x2n, a.x2b, X2p, a.B, X2p) &&
         kmajor_map(&m->wek, a.web, X2p, E, X2p) &&
         mnmajor_map(&m->wen, a.web, X2p, E, X2p) &&
         mnmajor_map(&m->dem, a.deb, E, a.B, a.ldd) &&
         kmajor_map(&m->dek, a.deb, E, a.B, a.ldd) &&
         mnmajor_map(&m->dx2n, a.dx2b, F2, BS, a.ldf);
}

cudaError_t run(const ModelArgs& a, cudaStream_t st) {
  const int L = a.S * a.P, BS = a.B * a.S, X2 = a.S * 2 * a.F, E = 2 * a.D;
  const int P2 = 2 * a.P, F2 = 2 * a.F;
  const int C = 1 << a.nbits, J = 2 * a.nbits;
  const int H = 3 * C + (C + 2) * J + J;
  const bool tc = a.round_bf16 != 0;
  const AffineX x{a.yr, a.yi, a.nr, a.ni, a.cvec, a.S, a.P, L};
  const CplxW wexp{a.wr, a.wi, a.P, a.F};
  Maps m;
  if (tc && !make_maps(a, &m)) return cudaErrorInvalidValue;
  const auto ktiles = [](int k) { return (k + TBK - 1) / TBK; };

  pack_params<<<1, 256, 0, st>>>(a.br, a.bi, a.wc, a.bc, a.wl, a.bl, a.fb,
                                 a.hp, a.F, C, J);
  CHECK(cudaGetLastError());
  if (tc) {    // the GEMM inputs that exist before the GEMMs, in bf16
    const size_t pairs = static_cast<size_t>(BS) * a.ldx / 2;
    affine_bf16<<<static_cast<int>(std::min<size_t>((pairs + 255) / 256,
                                                    4096)),
                  256, 0, st>>>(x, reinterpret_cast<__nv_bfloat162*>(a.xb),
                                P2, a.ldx, pairs);
    CHECK(cudaGetLastError());
    weights_bf16<<<std::min(((P2 + E * a.S) * a.ldf + 255) / 256, 1024),
                   256, 0, st>>>(wexp, a.we, a.wexpb, a.web, P2, F2, a.ldf,
                                 E * a.S);
    CHECK(cudaGetLastError());
  }
  const int X2p = a.S * a.ldf;   // bf16 route: x2, We, dX2 pitches
  // 1. x2 [B*S, 2F] = affine(y, n) . Wexp + fb (bf16 route: stored in bf16
  //    on the pitch ldf, zeros in the padding)
  CHECK(tc ? tc_gemm<false, true>(m.xk, m.wexpn,
                                  EpiBf16Bias{a.x2b, a.fb, a.ldf, F2}, BS,
                                  a.ldf, P2, 1, ktiles(P2), st)
           : gemm(x, wexp, a.x2, a.fb, BS, F2, P2, 1, F2, st));
  // 2. e [B, 2D] = x2 . We^T + be (bf16 route: summed over the padded
  //    S*ldf, whose padding is zero in both operands)
  CHECK(tc ? tc_gemm<false, false>(m.x2k, m.wek, EpiF32Bias{a.e, a.be, E},
                                   a.B, E, X2p, 1, ktiles(X2p), st)
           : gemm(RowMajor{a.x2, X2}, ColMajor{a.we, X2}, a.e, a.be, a.B, E,
                  X2, 1, E, st));
  // 3. the head (de, and in bf16 on the bf16 route), its gradients, the CE
  //    and the counts
  CHECK(launch_head_nb(a, st));
  head_finish<<<H + 2, FIN_THREADS, 0, st>>>(
      a.hpart, a.cpart, a.dhead, a.ce, a.conf, a.head_blocks, H,
      static_cast<long long>(a.B) * a.D * a.nbits);
  CHECK(cudaGetLastError());
  // 4. dWe [2D, S*2F] = de^T . x2, split over frames; dbe
  CHECK(tc ? tc_gemm<true, true>(m.dem, m.x2n,
                                 EpiSplit{a.part_we, X2,
                                          static_cast<size_t>(E) * X2, F2,
                                          a.ldf},
                                 E, X2p, a.B, a.splits_we, a.ktps_we, st)
           : gemm(ColMajor{a.de, E}, RowMajor{a.x2, X2}, a.part_we, nullptr,
                  E, X2, a.B, a.splits_we, X2, st));
  CHECK(reduce(a.part_we, a.dwe, a.splits_we, E * X2, st));
  CHECK(colsum(a.de, a.part_be, a.dbe, a.B, E, a.splits_be, st));
  // 5. dX2 [B, S*2F] = de . We (bf16 route: also stored in bf16)
  CHECK(tc ? tc_gemm<false, true>(m.dek, m.wen,
                                  EpiF32Bf16{a.dx2, a.dx2b, X2, X2p, F2,
                                             a.ldf},
                                  a.B, X2p, E, 1, ktiles(E), st)
           : gemm(RowMajor{a.de, E}, RowMajor{a.we, X2}, a.dx2, nullptr, a.B,
                  X2, E, 1, X2, st));
  // 6. dWexp [2P, 2F] = affine(y, n)^T . dX2, split over rows, folded into
  //    dwr and dwi; dfb
  CHECK(tc ? tc_gemm<true, true>(m.xm, m.dx2n,
                                 EpiSplit{a.part_w, F2,
                                          static_cast<size_t>(P2) * F2, F2,
                                          F2},
                                 P2, F2, BS, a.splits_w, a.ktps_w, st)
           : gemm(Transposed<AffineX>{x}, RowMajor{a.dx2, F2}, a.part_w,
                  nullptr, P2, F2, BS, a.splits_w, F2, st));
  reduce_fold<<<(a.P * a.F + 255) / 256, 256, 0, st>>>(a.part_w, a.dwr,
                                                      a.dwi, a.splits_w, a.P,
                                                      a.F);
  CHECK(cudaGetLastError());
  CHECK(colsum(a.dx2, a.part_fb, a.dfb, BS, F2, a.splits_fb, st));
  return cudaSuccess;
}

}  // namespace

extern "C" int dccn_fused_grads_f32(const ModelArgs* args, void* stream) {
  const ModelArgs& a = *args;
  if (a.nbits < 1 || a.nbits > 4 || a.B <= 0 ||
      static_cast<long long>(a.head_blocks) * HEAD_THREADS * HEAD_ITEMS <
          static_cast<long long>(a.B) * a.D)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(a, static_cast<cudaStream_t>(stream)));
}

// One tensor-core GEMM on contiguous bf16 operands, for checking each
// operand layout against a reference: A [M, K] (or [K, M] with a_mn), B
// [N, K] (or [K, N] with b_mn), C float32 [splits, M, N] partials over k
// tiles of `ktps` each.  Rows must be a multiple of 8 elements long.
extern "C" int tc_gemm_check(const void* a, const void* b, void* c, int M,
                             int N, int K, int a_mn, int b_mn, int splits,
                             int ktps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  const bool ok =
      (a_mn ? mnmajor_map(&ta, a, M, K, M) : kmajor_map(&ta, a, K, M, K)) &&
      (b_mn ? mnmajor_map(&tb, b, N, K, N) : kmajor_map(&tb, b, K, N, K));
  if (!ok || N % 2) return static_cast<int>(cudaErrorInvalidValue);
  const EpiSplit epi{static_cast<float*>(c), N, static_cast<size_t>(M) * N,
                     N, N};
  cudaError_t err;
  if (a_mn && b_mn)
    err = tc_gemm<true, true>(ta, tb, epi, M, N, K, splits, ktps, st);
  else if (a_mn)
    err = tc_gemm<true, false>(ta, tb, epi, M, N, K, splits, ktps, st);
  else if (b_mn)
    err = tc_gemm<false, true>(ta, tb, epi, M, N, K, splits, ktps, st);
  else
    err = tc_gemm<false, false>(ta, tb, epi, M, N, K, splits, ktps, st);
  return static_cast<int>(err);
}
