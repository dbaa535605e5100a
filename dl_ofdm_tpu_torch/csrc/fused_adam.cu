// fused_adam: one optimizer step of the port's training over every leaf in
// one launch: the L2 term's gradient, Adam (optax's `adam` behind its
// staircase schedule, no clipping) and the parameter write, with the loss
// scalars of the fused step.
//
// Replaces no TPU kernel: the JAX package leaves optax's update to XLA,
// which fuses it into the step's program.  Why it exists: the same update
// as PyTorch operations (train/loop.py `Adam.update`, still taken where
// this kernel is not, with `ops/fused_model.py::reg_grads` and
// `train/metrics.py::l2_regularization`) is some 14 `_foreach_*` launches
// and the L2 term's ~25, each issued from Python: at nfft 64 (584,464
// values) the host's launches, not the card, set the optimizer's pace.
//
// Per element, in the `_foreach_*` path's order, each operation rounded on
// its own (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn: nvcc contracts
// no multiply-add), so the results are the foreach path's bit for bit:
//   g   = g_model + w * factor        (Dense leaves, with counts given)
//   mu' = g * (1 - b1) + mu * b1
//   nu' = (g * g) * (1 - b2) + nu * b2
//   u   = ((mu' * r1) / (sqrt(nu' * r2) + eps)) * (-lr)
//   w'  = w + u
// with factor = ber * (reg_coeff * 2 * 0.01) and ber from the int64 2x2
// confusion counts, as `metrics.ber_from_confusion` rounds it.  The rate,
// the scalars and r1 = 1 / (1 - b1^t), r2 = 1 / (1 - b2^t) come from the
// host in double, rounded to float: PyTorch divides a CUDA tensor by a
// Python number (the bias corrections, in `_foreach_div` too) as a product
// with that number's reciprocal, taken in double and rounded to float.
//
// Bound on an H100: the bytes.  Each element reads w, g, mu and nu and
// writes w', mu' and nu' (and g' on request): 28 bytes, 0.82 GB at 29.3 M
// values, 0.25 ms at 3.35 TB/s; at 0.58 M values the launch itself.
// Design: tiles of THREADS x ITEMS elements of one leaf, walked by a grid
// of a few blocks an SM; each thread loads its ITEMS elements of all four
// inputs before it computes, so loads are coalesced and many are in
// flight.  A gradient may be a strided view (the fused model kernel hands
// two transposed ones): element e of a leaf sits at
// g[(e / cols) * s0 + (e % cols) * s1], no copy.  Outputs are new planes,
// never the inputs: the caller's old state stays as it was.
//
// The loss scalars: with counts given, each block sums w * w over the
// Dense leaves in double and writes its partial; the last block to finish
// (a counter, reset by that block) adds the partials in block order, so
// the sum does not depend on the blocks' timing.  Where the leaves take
// more than one launch (more than MAX_LEAVES), each launch's last block
// keeps its launch's sum and the last launch's adds them in order.  It
// then writes reg, ber, log_ber, loss = ce + ber * reg_coeff * reg and
// total_loss = loss + log_ber.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py); the layout (tiles, grid,
// chunks, offsets) is made by dl_ofdm_tpu_torch/ops/fused_adam.py and
// checked here.  The launch goes on the caller's stream; the function
// returns cudaGetLastError().

#include <cuda_runtime.h>

#define MAX_LEAVES 48
#define THREADS 256
#define ITEMS 4

// one leaf of a launch (64 bytes); outside the anonymous namespace, as the
// entry point's argument
struct AdamLeaf {
  const float* w;     // [n] contiguous
  const float* g;     // element e at g[(e / cols) * s0 + (e % cols) * s1]
  const float* mu;    // [n] contiguous
  const float* nu;    // [n] contiguous
  long long off;      // the leaf's first element in each output plane
  int n, cols, s0, s1;
  int tile0;          // the leaf's first tile in the launch
  int dense;          // 1: takes the L2 factor and counts in the L2 sum
};

struct AdamArgs {
  float* out;               // planes of `plane` floats: w', mu', nu' (, g')
  long long plane;
  const long long* conf;    // int64 [2, 2] counts, or null: no L2 term
  const float* ce;          // the mean CE (with conf)
  float* scalars;           // reg, ber, log_ber, loss, total_loss
  double* partials;         // [grid] each block's sum of w * w
  double* chunk_sums;       // [chunks] each launch's sum
  unsigned int* done;       // blocks finished; 0 between launches
  float b1, omb1, b2, omb2, r1, r2, eps, neg_lr;
  float l2_coeff;           // reg_coeff * 2 * 0.01
  float reg_coeff;
  int leaves, tiles, grid, chunk, chunks, write_grads;
  AdamLeaf leaf[MAX_LEAVES];
};

namespace {

constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float ber_of(const long long* conf) {
  long long total = conf[0] + conf[1] + conf[2] + conf[3];
  if (total < 1) total = 1;
  return __fdiv_rn(__ll2float_rn(conf[1] + conf[2]), __ll2float_rn(total));
}

// the block's sum of v, in a fixed order; the result in thread 0
__device__ double block_sum(double v, double* warp_sums) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < WARPS; ++i) s += warp_sums[i];
  }
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(THREADS)
    fused_adam_kernel(const __grid_constant__ AdamArgs a) {
  __shared__ double warp_sums[WARPS];
  __shared__ bool last;
  const bool l2 = a.conf != nullptr;
  const float factor = l2 ? __fmul_rn(ber_of(a.conf), a.l2_coeff) : 0.f;
  double sq = 0.0;
  int k = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    while (k + 1 < a.leaves && a.leaf[k + 1].tile0 <= t) ++k;
    const AdamLeaf& L = a.leaf[k];
    const int base = (t - L.tile0) * TILE + threadIdx.x;
    float w[ITEMS], g[ITEMS], m[ITEMS], v[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int e = base + j * THREADS;
      if (e < L.n) {
        w[j] = L.w[e];
        m[j] = L.mu[e];
        v[j] = L.nu[e];
        const long long gi =
            L.cols == 1 ? static_cast<long long>(e) * L.s0
                        : static_cast<long long>(e / L.cols) * L.s0 +
                              static_cast<long long>(e % L.cols) * L.s1;
        g[j] = L.g[gi];
      }
    }
    const bool fold = l2 && L.dense;
    float* ow = a.out + L.off;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int e = base + j * THREADS;
      if (e < L.n) {
        float gj = g[j];
        if (fold) {
          gj = __fadd_rn(gj, __fmul_rn(w[j], factor));
          sq += static_cast<double>(w[j]) * static_cast<double>(w[j]);
        }
        const float mj =
            __fadd_rn(__fmul_rn(gj, a.omb1), __fmul_rn(m[j], a.b1));
        const float vj = __fadd_rn(__fmul_rn(__fmul_rn(gj, gj), a.omb2),
                                   __fmul_rn(v[j], a.b2));
        const float den =
            __fadd_rn(__fsqrt_rn(__fmul_rn(vj, a.r2)), a.eps);
        const float u =
            __fmul_rn(__fdiv_rn(__fmul_rn(mj, a.r1), den), a.neg_lr);
        ow[e] = __fadd_rn(w[j], u);
        ow[a.plane + e] = mj;
        ow[2 * a.plane + e] = vj;
        if (a.write_grads) ow[3 * a.plane + e] = gj;
      }
    }
  }
  if (!l2) return;
  // the loss scalars: this block's partial, then the last block's sums
  const double s = block_sum(sq, warp_sums);
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double p = 0.0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += THREADS)
    p += __ldcg(a.partials + i);
  const double total = block_sum(p, warp_sums);
  if (threadIdx.x != 0) return;
  *a.done = 0u;
  a.chunk_sums[a.chunk] = total;
  if (a.chunk != a.chunks - 1) return;
  double all = 0.0;
  for (int c = 0; c < a.chunks; ++c) all += __ldcg(a.chunk_sums + c);
  const float reg = static_cast<float>(0.01 * all);
  const float ber = ber_of(a.conf);
  const float log_ber = logf(fmaxf(ber, 1e-12f));
  const float loss =
      __fadd_rn(*a.ce, __fmul_rn(__fmul_rn(ber, a.reg_coeff), reg));
  a.scalars[0] = reg;
  a.scalars[1] = ber;
  a.scalars[2] = log_ber;
  a.scalars[3] = loss;
  a.scalars[4] = __fadd_rn(loss, log_ber);
}

bool args_ok(const AdamArgs& a) {
  if (a.out == nullptr || a.leaves < 1 || a.leaves > MAX_LEAVES ||
      a.tiles < 1 || a.grid < 1 || a.grid > a.tiles || a.plane < 1 ||
      a.chunks < 1 || a.chunk < 0 || a.chunk >= a.chunks)
    return false;
  if (a.conf != nullptr &&
      (a.ce == nullptr || a.scalars == nullptr || a.partials == nullptr ||
       a.chunk_sums == nullptr || a.done == nullptr))
    return false;
  int tiles = 0;
  for (int i = 0; i < a.leaves; ++i) {
    const AdamLeaf& L = a.leaf[i];
    if (L.n < 1 || L.cols < 1 || L.tile0 != tiles || L.off < 0 ||
        L.off + L.n > a.plane || L.w == nullptr || L.g == nullptr ||
        L.mu == nullptr || L.nu == nullptr)
      return false;
    tiles += (L.n + TILE - 1) / TILE;
  }
  return tiles == a.tiles;
}

}  // namespace

// launches on `device` (the caller's current device is restored)
extern "C" int fused_adam(const AdamArgs* args, int device, void* stream) {
  const AdamArgs& a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_adam_kernel<<<a.grid, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
