// complex_conv2d: the equalizers' one-channel complex 2D convolution
// (`ComplexConv2d(1, 1, (kh, kw), padding="same")` over the (symbol,
// subcarrier) map) and its two gradients, in float32 on the CUDA cores.
//
// Every mode of the layer is one real 2-in/2-out tap a kernel position,
// W[a][b][ci][co] (ci, co: the re and im planes), which the caller builds
// from the layer's parameters; with x_pad the input padded as XLA pads
// 'same' (pt = (kh - 1) / 2 rows before, pl = (kw - 1) / 2 columns, the
// odd pixel after):
//   forward         y[n,i,j,co] = bias[co] + sum_{a,b,ci} x_pad[n,i+a,j+b,ci] W[a,b,ci,co]
//   input gradient  the same correlation of dy with the taps flipped, each
//                   2x2 transposed, and the pads swapped (pt' = kh-1-pt)
//   weight gradient dW[a,b,ci,co] = sum_{n,i,j} x_pad[n,i+a,j+b,ci] dy[n,i,j,co]
//   bias gradient   db[co] = sum_{n,i,j} dy[n,i,j,co]
//
// Replaces no TPU kernel: the JAX package leaves the convolution to XLA's
// conv on the TPU.  Why it exists: on the card the same convolution went
// to cuDNN, whose deterministic weight gradient of a one-channel (7, 64)
// convolution took most of the equalizer step's device time.
//
// Bound on an H100: the operations.  A (7, 64) kernel on a 7 x 64 map has
// 37 x 3,072 taps inside the 'same' window, 909,312 FLOP a frame a pass
// (8 a complex tap), 8.5 GFLOP a pass at 9,362 frames: 0.13 ms at 67
// TFLOP/s of float32 FMA, against ~34 MB of each tensor read or written
// (0.01 ms at 3.35 TB/s).  The design keeps the FMA units fed from shared
// memory and registers:
//   * a block stages whole frames in shared memory (zero columns around
//     each row, so no tap tests its column), and the taps in reach of the
//     map (rows a with |a - pt| < S);
//   * forward and input gradient: a lane owns one output column of one
//     frame and all S of its rows (2S accumulators); at each tap column b
//     it reads the S inputs of its window column once and every tap row's
//     2x2 (one broadcast load each), and makes each of the 37 row pairs
//     (i, r) in reach its four FMAs: ~7 FMAs a shared-memory wavefront;
//   * weight gradient: a lane owns one tap column b and every tap row's
//     2x2 (4 (2S - 1) accumulators) over all frames of its block; at each
//     output column j it reads its S inputs and the S gradients (one
//     broadcast load each) and makes the 37 row pairs' outer products.
//     Each block sums a fixed range of frames in a fixed order; a second
//     launch adds the blocks' partials in block order, so a repeat is bit
//     for bit (no float atomics);
//   * the rows S are a template parameter (1-8), so the (i, r) pairs in
//     reach unroll to straight FMAs; the tap rows in reach are tested
//     once a tap column, the same for every lane.
// Lanes whose window runs over a zero column compute zeros: a quarter of
// the FMAs at (7, 64), which buys loops with no test in them.
// Only FMA (fmaf) on float32, float32 accumulators, no tensor cores: the
// configuration states float32 everywhere with no TF32.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py).  The launch plans (frames a
// block, shared bytes, grids) are made by dl_ofdm_tpu_torch/ops/
// complex_conv2d.py and checked here.  Launches go on the caller's stream;
// each function returns cudaGetLastError().

#include <cuda_runtime.h>

#define THREADS 256
#define MAX_S 8
#define SMEM_MAX 232448

struct ConvArgs {
  const float* x;     // [B, S, K, 2]: the input, or dy for the input gradient
  const float* w;     // [kh, kw, 2, 2] W[a][b][ci][co], 16-byte aligned
  const float* bias;  // [2] or null
  float* y;           // [B, S, K, 2]
  int B, S, K, kh, kw;
  int pt, pl;         // pads before: rows, columns
  int flip;           // 1: taps flipped and each 2x2 transposed (dx)
  int frames;         // frames a block
  int smem;           // dynamic shared bytes
  int grid;
};

struct WgradArgs {
  const float* x;     // [B, S, K, 2]
  const float* dy;    // [B, S, K, 2]
  float* partials;    // [grid_x][kh * kw * 4 + 4]: dW's, then db's 2 (+ 2)
  float* dw;          // [kh, kw, 2, 2]
  float* db;          // [2] or null
  int B, S, K, kh, kw, pt, pl;
  int frames;         // frames staged at a time (one a frame slot)
  int chunks;         // tap chunks of 32 columns a block
  int grid_x, grid_y;
  int smem;
  int sum_grid;       // blocks of the partials' sum
};

namespace {

constexpr int WARPS = THREADS / 32;

__host__ __device__ __forceinline__ int reach_lo(int pt, int s) {
  return pt - (s - 1) > 0 ? pt - (s - 1) : 0;
}
__host__ __device__ __forceinline__ int reach_hi(int pt, int s, int kh) {
  return pt + s < kh ? pt + s : kh;
}

// frames [n0, n0 + nf) of src [B, S, K] float2 into dst [nf][S][pitch] at
// column off (the columns outside stay as they are); one warp a row, lanes
// along it
__device__ __forceinline__ void stage_rows(const float2* __restrict__ src,
                                           float2* dst, long long n0,
                                           int nf, int S, int K, int pitch,
                                           int off) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < nf * S; row += WARPS) {
    const float2* s = src + (n0 * S + row) * K;
    float2* d = dst + row * pitch + off;
    for (int c = lane; c < K; c += 32) d[c] = __ldg(s + c);
  }
}

// zero the pad columns of rows [nf][S][pitch]: [0, off) and [off + K, pitch)
__device__ __forceinline__ void zero_pads(float2* dst, int rows, int K,
                                          int pitch, int off) {
  const int pads = pitch - K;
  for (int e = threadIdx.x; e < rows * pads; e += THREADS) {
    const int row = e / pads, p = e - row * pads;
    dst[row * pitch + (p < off ? p : p + K)] = make_float2(0.f, 0.f);
  }
}

// The forward and the input gradient: one block a group of `frames`
// frames; a warp item is (frame, 32 output columns).
template <int S>
__global__ void __launch_bounds__(THREADS, 3)
    complex_conv2d_fwd_kernel(const __grid_constant__ ConvArgs a) {
  extern __shared__ float4 smem4[];
  const int kh = a.kh, kw = a.kw, K = a.K, pt = a.pt;
  const int a0 = reach_lo(pt, S), a1 = reach_hi(pt, S, kh);
  const int kp = K + kw - 1;                  // padded row pitch
  float4* ws = smem4;                         // [a1 - a0][kw]
  float2* xs = reinterpret_cast<float2*>(ws + (a1 - a0) * kw);
  const long long n0 = static_cast<long long>(blockIdx.x) * a.frames;
  const int nf = min(static_cast<long long>(a.frames), a.B - n0);
  const float4* w4 = reinterpret_cast<const float4*>(a.w);
  for (int e = threadIdx.x; e < (a1 - a0) * kw; e += THREADS) {
    const int r = e / kw, b = e - r * kw, ta = a0 + r;
    if (a.flip) {
      const float4 u = __ldg(w4 + (kh - 1 - ta) * kw + (kw - 1 - b));
      ws[e] = make_float4(u.x, u.z, u.y, u.w);
    } else {
      ws[e] = __ldg(w4 + ta * kw + b);
    }
  }
  zero_pads(xs, nf * S, K, kp, a.pl);
  stage_rows(reinterpret_cast<const float2*>(a.x), xs, n0, nf, S, K, kp,
             a.pl);
  __syncthreads();
  const float2 bias = a.bias == nullptr
      ? make_float2(0.f, 0.f)
      : make_float2(__ldg(a.bias), __ldg(a.bias + 1));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (K + 31) >> 5;
  float2* y = reinterpret_cast<float2*>(a.y);
  for (int it = warp; it < nf * chunks; it += WARPS) {
    const int f = it / chunks, j = (it - f * chunks) * 32 + lane;
    // a lane past the last column repeats the last one and stores nothing
    const float2* xf = xs + f * S * kp + min(j, K - 1);
    float2 acc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = make_float2(0.f, 0.f);
#pragma unroll 2
    for (int b = 0; b < kw; ++b) {
      float2 xv[S];
#pragma unroll
      for (int r = 0; r < S; ++r) xv[r] = xf[r * kp + b];
#pragma unroll
      for (int d = 1 - S; d < S; ++d) {
        const int ta = d + pt;                 // tap row; the same in a warp
        if (ta < a0 || ta >= a1) continue;
        const float4 wv = ws[(ta - a0) * kw + b];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int r = i + d;
          if (r < 0 || r >= S) continue;
          acc[i].x = fmaf(xv[r].x, wv.x, acc[i].x);
          acc[i].x = fmaf(xv[r].y, wv.z, acc[i].x);
          acc[i].y = fmaf(xv[r].x, wv.y, acc[i].y);
          acc[i].y = fmaf(xv[r].y, wv.w, acc[i].y);
        }
      }
    }
    if (j < K) {
      float2* yf = y + (n0 + f) * S * K + j;
#pragma unroll
      for (int i = 0; i < S; ++i)
        yf[i * K] = make_float2(acc[i].x + bias.x, acc[i].y + bias.y);
    }
  }
}

// The weight and bias gradients, block (bx, by): frames
// [bx B / grid_x, (bx + 1) B / grid_x), tap columns of chunks
// [by chunks, (by + 1) chunks); warp w takes chunk w % chunks and frame
// slot w / chunks of each staged group.  Writes partials[bx]: rows in
// reach of this block's tap columns and, for by = 0, the bias's two sums.
template <int S>
__global__ void __launch_bounds__(THREADS, 2)
    complex_conv2d_wgrad_kernel(const __grid_constant__ WgradArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int D = 2 * S - 1;                // row offsets d = a - pt
  const int kh = a.kh, kw = a.kw, K = a.K, pt = a.pt;
  const int a0 = reach_lo(pt, S), a1 = reach_hi(pt, S, kh);
  const int kp = K + kw - 1;
  const int nfr = a.frames;
  float2* xs = reinterpret_cast<float2*>(smem4);   // [frames][S][kp]
  float2* ds = xs + nfr * S * kp;                  // [frames][S][K]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slots = WARPS / a.chunks;
  const int slot = warp / a.chunks;
  const int b = (blockIdx.y * a.chunks + warp % a.chunks) * 32 + lane;
  const int bc = min(b, kw - 1);               // past kw: a copy, unstored
  const long long lo = static_cast<long long>(blockIdx.x) * a.B / a.grid_x;
  const long long hi =
      static_cast<long long>(blockIdx.x + 1) * a.B / a.grid_x;
  float4 acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 bsum = make_float2(0.f, 0.f);
  const bool bias = a.db != nullptr && blockIdx.y == 0;
  zero_pads(xs, nfr * S, K, kp, a.pl);
  for (long long n0 = lo; n0 < hi; n0 += nfr) {
    const int nf = static_cast<int>(min(static_cast<long long>(nfr),
                                        hi - n0));
    __syncthreads();                           // the last group is read
    stage_rows(reinterpret_cast<const float2*>(a.x), xs, n0, nf, S, K, kp,
               a.pl);
    stage_rows(reinterpret_cast<const float2*>(a.dy), ds, n0, nf, S, K, K,
               0);
    __syncthreads();
    if (bias) {
      for (int row = warp; row < nf * S; row += WARPS)
        for (int c = lane; c < K; c += 32) {
          bsum.x += ds[row * K + c].x;
          bsum.y += ds[row * K + c].y;
        }
    }
    for (int f = slot; f < nf; f += slots) {
      const float2* xf = xs + f * S * kp + bc;
      const float2* df = ds + f * S * K;
#pragma unroll 2
      for (int j = 0; j < K; ++j) {
        float2 xv[S], dv[S];
#pragma unroll
        for (int r = 0; r < S; ++r) xv[r] = xf[r * kp + j];
#pragma unroll
        for (int i = 0; i < S; ++i) dv[i] = df[i * K + j];
#pragma unroll
        for (int d = 1 - S; d < S; ++d) {
          const int ta = d + pt;
          if (ta < a0 || ta >= a1) continue;
          float4& s = acc[d + S - 1];
#pragma unroll
          for (int i = 0; i < S; ++i) {
            const int r = i + d;
            if (r < 0 || r >= S) continue;
            s.x = fmaf(xv[r].x, dv[i].x, s.x);
            s.y = fmaf(xv[r].x, dv[i].y, s.y);
            s.z = fmaf(xv[r].y, dv[i].x, s.z);
            s.w = fmaf(xv[r].y, dv[i].y, s.w);
          }
        }
      }
    }
  }
  // the frame slots of each tap chunk, added in slot order
  __syncthreads();
  float4* red = smem4;                         // [WARPS][32][D]
#pragma unroll
  for (int d = 0; d < D; ++d) red[(warp * 32 + lane) * D + d] = acc[d];
  float2* bred = reinterpret_cast<float2*>(red + WARPS * 32 * D);
  // the bias: lanes in a fixed tree, then warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bsum.x += __shfl_down_sync(0xffffffffu, bsum.x, o);
    bsum.y += __shfl_down_sync(0xffffffffu, bsum.y, o);
  }
  if (lane == 0) bred[warp] = bsum;
  __syncthreads();
  float* part = a.partials +
      static_cast<long long>(blockIdx.x) * (kh * kw * 4 + 4);
  const int taps = a.chunks * 32;
  for (int e = threadIdx.x; e < taps * D; e += THREADS) {
    const int t = e / D, dd = e - t * D;
    const int ta = dd - (S - 1) + pt;
    const int col = blockIdx.y * taps + t;
    if (ta < a0 || ta >= a1 || col >= kw) continue;
    const int c = t >> 5, l = t & 31;
    float4 s = red[(c * 32 + l) * D + dd];
    for (int sl = 1; sl < slots; ++sl) {
      const float4 v = red[((sl * a.chunks + c) * 32 + l) * D + dd];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(part)[ta * kw + col] = s;
  }
  if (bias && threadIdx.x == 0) {
    float2 s = bred[0];
    for (int w = 1; w < WARPS; ++w) {
      s.x += bred[w].x;
      s.y += bred[w].y;
    }
    part[kh * kw * 4] = s.x;
    part[kh * kw * 4 + 1] = s.y;
  }
}

// dw (and db) from the partials: value e is the sum over blocks bx in
// order, each warp a fixed eighth of them in double, the eighths added in
// warp order; taps out of reach of the map are zero.
__global__ void __launch_bounds__(THREADS)
    complex_conv2d_wgrad_sum_kernel(const __grid_constant__ WgradArgs a) {
  __shared__ double sums[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = a.kh * a.kw * 4 + (a.db != nullptr ? 2 : 0);
  const int e = blockIdx.x * 32 + lane;
  const int pt = a.pt;
  const int a0 = reach_lo(pt, a.S), a1 = reach_hi(pt, a.S, a.kh);
  const int ta = e / (a.kw * 4);
  const bool live = e < n && (e >= a.kh * a.kw * 4 || (ta >= a0 && ta < a1));
  double s = 0.0;
  if (live) {
    const int stride = a.kh * a.kw * 4 + 4;
    const int lo = warp * a.grid_x / WARPS;
    const int hi = (warp + 1) * a.grid_x / WARPS;
#pragma unroll 8
    for (int bx = lo; bx < hi; ++bx)
      s += static_cast<double>(
          __ldg(a.partials + static_cast<long long>(bx) * stride + e));
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || e >= n) return;
  double t = sums[0][lane];
  for (int w = 1; w < WARPS; ++w) t += sums[w][lane];
  const float v = live ? static_cast<float>(t) : 0.f;
  if (e < a.kh * a.kw * 4) a.dw[e] = v;
  else a.db[e - a.kh * a.kw * 4] = v;
}

// shared bytes the forward's layout takes
long long fwd_smem(const ConvArgs& a) {
  const int rows = reach_hi(a.pt, a.S, a.kh) - reach_lo(a.pt, a.S);
  return 16LL * rows * a.kw +
         8LL * a.frames * a.S * (a.K + a.kw - 1);
}

// shared bytes the weight gradient's layout takes
long long wgrad_smem(const WgradArgs& a) {
  const long long tiles =
      8LL * a.frames * a.S * ((a.K + a.kw - 1) + a.K);
  const long long red = 16LL * WARPS * 32 * (2 * a.S - 1) + 8 * WARPS;
  return tiles > red ? tiles : red;
}

bool fwd_ok(const ConvArgs& a) {
  if (a.x == nullptr || a.w == nullptr || a.y == nullptr) return false;
  if (a.B < 1 || a.S < 1 || a.S > MAX_S || a.K < 1 || a.kh < 1 ||
      a.kw < 1 || a.frames < 1 || a.pt < 0 || a.pt >= a.kh || a.pl < 0 ||
      a.pl >= a.kw || (a.flip != 0 && a.flip != 1))
    return false;
  if (a.grid != (a.B + a.frames - 1) / a.frames) return false;
  if (static_cast<long long>(a.B) * a.S * a.K >= (1LL << 30)) return false;
  return a.smem == fwd_smem(a) && a.smem <= SMEM_MAX;
}

bool wgrad_ok(const WgradArgs& a) {
  if (a.x == nullptr || a.dy == nullptr || a.partials == nullptr ||
      a.dw == nullptr)
    return false;
  if (a.B < 1 || a.S < 1 || a.S > MAX_S || a.K < 1 || a.kh < 1 ||
      a.kw < 1 || a.pt < 0 || a.pt >= a.kh || a.pl < 0 || a.pl >= a.kw)
    return false;
  if (a.chunks < 1 || a.chunks > WARPS || WARPS % a.chunks != 0 ||
      a.frames != WARPS / a.chunks)
    return false;
  if (a.grid_x < 1 || a.grid_x > a.B ||
      a.grid_y != ((a.kw + 31) / 32 + a.chunks - 1) / a.chunks)
    return false;
  if (a.sum_grid != (a.kh * a.kw * 4 + 2 + 31) / 32) return false;
  if (static_cast<long long>(a.B) * a.S * a.K >= (1LL << 30)) return false;
  return a.smem == wgrad_smem(a) && a.smem <= SMEM_MAX;
}

template <int S>
cudaError_t launch_fwd(const ConvArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      complex_conv2d_fwd_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  complex_conv2d_fwd_kernel<S><<<a.grid, THREADS, a.smem, stream>>>(a);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_wgrad(const WgradArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      complex_conv2d_wgrad_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  complex_conv2d_wgrad_kernel<S>
      <<<dim3(a.grid_x, a.grid_y), THREADS, a.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  complex_conv2d_wgrad_sum_kernel<<<a.sum_grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// the forward (flip 0) or the input gradient (flip 1): one launch
extern "C" int complex_conv2d_fwd(const ConvArgs* args, void* stream) {
  const ConvArgs& a = *args;
  if (!fwd_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (a.S) {
    case 1: err = launch_fwd<1>(a, s); break;
    case 2: err = launch_fwd<2>(a, s); break;
    case 3: err = launch_fwd<3>(a, s); break;
    case 4: err = launch_fwd<4>(a, s); break;
    case 5: err = launch_fwd<5>(a, s); break;
    case 6: err = launch_fwd<6>(a, s); break;
    case 7: err = launch_fwd<7>(a, s); break;
    default: err = launch_fwd<8>(a, s); break;
  }
  return static_cast<int>(err);
}

// the weight and bias gradients: two launches (the partials, their sum)
extern "C" int complex_conv2d_wgrad(const WgradArgs* args, void* stream) {
  const WgradArgs& a = *args;
  if (!wgrad_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (a.S) {
    case 1: err = launch_wgrad<1>(a, s); break;
    case 2: err = launch_wgrad<2>(a, s); break;
    case 3: err = launch_wgrad<3>(a, s); break;
    case 4: err = launch_wgrad<4>(a, s); break;
    case 5: err = launch_wgrad<5>(a, s); break;
    case 6: err = launch_wgrad<6>(a, s); break;
    case 7: err = launch_wgrad<7>(a, s); break;
    default: err = launch_wgrad<8>(a, s); break;
  }
  return static_cast<int>(err);
}
