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
// parallel.  So the step is a few launches from this file that share one
// tiled SIMT GEMM routine, with activations in device memory:
//   1. x2 = fft_like(affine(y, n))  [B*S, 2F]: a real GEMM with K = 2*sps
//      against the complex weight expanded to [[wr, wi], [-wi, wr]]
//      (columns interleaved f*2+iq, flax's layout of the flattened fft_out);
//   2. e  = x2 . We^T + be          [B, 2D]  (We is torch's [2D, S*2F]);
//   3. the head per (frame, d): conv1x1, leaky, llr, CE, dlogits and the
//      head's backward -> de [B, 2D], per-block head-gradient partials and
//      counts;
//   4. dWe = de^T . x2, split over frames into partials, summed in a fixed
//      order by a second pass (no float atomics: deterministic);
//   5. dX2 = de . We;
//   6. dWexp = affine(y, n)^T . dX2 split over frames, folded into dwr and
//      dwi on the host; the bias gradients are column sums, split and
//      summed the same way.
// Every product is computed here, none by a library.  With round_bf16 the
// GEMMs' inputs are rounded to bfloat16 (nearest even) as they are staged,
// and sums stay float32: the products match `matmul_dtype='bfloat16'` of
// the TPU kernel's dots; without it the products are float32 throughout.
//
// Bound on an H100 at 9,362 frames: 4.01 MFLOP per frame, 37.6 GFLOP in
// all: 0.56 ms at the float32 FMA rate (67 TFLOP/s), 0.038 ms on bf16
// tensor cores (989 TFLOP/s); the ~96 MB of planes and gradients take
// 0.029 ms.  This first version runs every GEMM on the FMA units, so it
// faces the 0.56 ms float32 bound in both modes; wgmma with bf16 operands
// and keeping activations on chip are later work.
//
// Plain C interface for ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py); all
// launches go on the caller's stream and the function returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// the arguments, filled field for field by a ctypes.Structure; outside the
// anonymous namespace, so that the extern "C" entry point keeps external
// linkage
struct ModelArgs {
  const float *yr, *yi, *nr, *ni, *cvec;   // raw planes [B, L], affine [6, L]
  const int* idx;                          // [B, D] symbol indices
  const float *wr, *wi;                    // fft_like [sps, F]
  const float* fb;                         // [2F] interleaved (br, bi)
  const float *we, *be;                    // Dense_extract [2D, S*2F], [2D]
  const float* hp;                         // packed head parameters
  float *x2, *e, *de, *dx2;                // activations
  float *part_we, *part_w, *part_be, *part_fb, *hpart;   // split partials
  int* cpart;
  float *dwe, *dwexp, *dbe, *dfb, *dhead;  // gradients (dhead: H + 1)
  int B, S, P, F, D, nbits, splits_we, splits_w, splits_be, splits_fb,
      head_blocks, round_bf16;
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
// the GEMM: C[z] = A[:, kz] . B[kz, :] (+ bias), split z over K
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);   // 256

template <bool RND>
__device__ __forceinline__ float stage(float v) {
  if (RND) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// C is [gridDim.z, M, ldc]; block z sums k in [z*kchunk, (z+1)*kchunk)
template <class LA, class LB, bool RND>
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
      as[kk][mm] = (m < M && k < kend) ? stage<RND>(A(m, k)) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < BN * BK / GEMM_THREADS; ++q) {
      const int e = tid + q * GEMM_THREADS;
      const int nn = LB::kInner ? e % BN : e / BK;
      const int kk = LB::kInner ? e / BN : e % BK;
      const int n = n0 + nn, k = k0 + kk;
      bs[kk][nn] = (n < N && k < kend) ? stage<RND>(B(k, n)) : 0.f;
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
                 int K, int splits, int ldc, bool rnd, cudaStream_t st) {
  const int kchunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  if (rnd)
    gemm_kernel<LA, LB, true><<<grid, GEMM_THREADS, 0, st>>>(
        a, b, c, bias, M, N, K, kchunk, ldc);
  else
    gemm_kernel<LA, LB, false><<<grid, GEMM_THREADS, 0, st>>>(
        a, b, c, bias, M, N, K, kchunk, ldc);
  return cudaGetLastError();
}

// out[i] = sum_z part[z * n + i], z in order
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ out, int nz, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
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
  for (int r = r0; r < r1; ++r) s += x[static_cast<size_t>(r) * cols + c];
  part[static_cast<size_t>(blockIdx.y) * cols + c] = s;
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
            float* __restrict__ hpart, int* __restrict__ cpart, int n_elem,
            float gscale) {
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
      a.e, a.idx, a.hp, a.de, a.hpart, a.cpart, a.B * a.D, gscale);
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

}  // namespace

#define CHECK(call)                               \
  do {                                            \
    const cudaError_t err_ = (call);              \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

extern "C" int dccn_fused_grads_f32(const ModelArgs* args, void* stream) {
  const ModelArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.nbits < 1 || a.nbits > 4 || a.B <= 0 ||
      static_cast<long long>(a.head_blocks) * HEAD_THREADS * HEAD_ITEMS <
          static_cast<long long>(a.B) * a.D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = a.S * a.P, BS = a.B * a.S, X2 = a.S * 2 * a.F, E = 2 * a.D;
  const bool rnd = a.round_bf16 != 0;
  const AffineX x{a.yr, a.yi, a.nr, a.ni, a.cvec, a.S, a.P, L};
  // 1. x2 [B*S, 2F] = affine(y, n) . Wexp + fb
  CHECK(gemm(x, CplxW{a.wr, a.wi, a.P, a.F}, a.x2, a.fb, BS, 2 * a.F,
             2 * a.P, 1, 2 * a.F, rnd, st));
  // 2. e [B, 2D] = x2 . We^T + be
  CHECK(gemm(RowMajor{a.x2, X2}, ColMajor{a.we, X2}, a.e, a.be, a.B, E, X2,
             1, E, rnd, st));
  // 3. the head
  switch (a.nbits) {
    case 1: CHECK(launch_head<1>(a, st)); break;
    case 2: CHECK(launch_head<2>(a, st)); break;
    case 3: CHECK(launch_head<3>(a, st)); break;
    default: CHECK(launch_head<4>(a, st)); break;
  }
  const int C = 1 << a.nbits, H = 3 * C + (C + 2) * 2 * a.nbits + 2 * a.nbits;
  CHECK(reduce(a.hpart, a.dhead, a.head_blocks, H + 1, st));
  // 4. dWe [2D, S*2F] = de^T . x2, split over frames; dbe
  CHECK(gemm(ColMajor{a.de, E}, RowMajor{a.x2, X2}, a.part_we, nullptr, E,
             X2, a.B, a.splits_we, X2, rnd, st));
  CHECK(reduce(a.part_we, a.dwe, a.splits_we, E * X2, st));
  CHECK(colsum(a.de, a.part_be, a.dbe, a.B, E, a.splits_be, st));
  // 5. dX2 [B, S*2F] = de . We
  CHECK(gemm(RowMajor{a.de, E}, RowMajor{a.we, X2}, a.dx2, nullptr, a.B, X2,
             E, 1, X2, rnd, st));
  // 6. dWexp [2*sps, 2F] = affine(y, n)^T . dX2, split over rows; dfb
  CHECK(gemm(Transposed<AffineX>{x}, RowMajor{a.dx2, 2 * a.F}, a.part_w,
             nullptr, 2 * a.P, 2 * a.F, BS, a.splits_w, 2 * a.F, rnd, st));
  CHECK(reduce(a.part_w, a.dwexp, a.splits_w, 2 * a.P * 2 * a.F, st));
  CHECK(colsum(a.dx2, a.part_fb, a.dfb, BS, 2 * a.F, a.splits_fb, st));
  return static_cast<int>(cudaSuccess);
}
