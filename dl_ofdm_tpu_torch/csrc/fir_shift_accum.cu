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
// are 0.27 GB, 0.082 ms at 3.35 TB/s, against 1.7 GFLOP of float32 work
// (0.026 ms outside the tensor cores, ~0.06 ms of issue slots once each
// multiply and add is rounded on its own).  So the design keeps HBM busy
// and takes the arithmetic off the load path:
//   * persistent blocks walk work units (R rows x one chunk of up to 2,048
//     outputs), a fixed set a block, and stage each unit's input rows and
//     taps in shared memory by 4-byte `cp.async`s in a ring of NBUF
//     buffers: the next units' rows are in flight while this one computes,
//     behind one barrier a unit.  A 4-byte copy takes any row length and
//     alignment (La = L + F - 1 is odd in general, so rows start
//     anywhere), and its zero-fill form pads the rows' ragged edges and
//     the rows past B;
//   * register blocking: each thread makes V = 8 consecutive outputs of one
//     row; it walks the taps in chunks of KC = 8, reading the chunk's
//     V + KC - 1 window samples of both planes into registers once, so an
//     output costs ~2(V + KC - 1)/(V KC) shared loads a tap in place of 4;
//     any F takes the same path, chunk after chunk;
//   * the rows sit in shared memory skewed, sample c at c + c / 8, with a
//     row pitch equal to 9 G (mod 32) for G threads a row: thread e of the
//     block reads bank 9 e + const, so a warp's window loads are free of
//     bank conflicts, across row boundaries too;
//   * taps are taken in ascending order with explicit __fmul_rn /
//     __fadd_rn / __fsub_rn in the plain version's order,
//       acc_r = (acc_r + sr*hr) - si*hi,  acc_i = (acc_i + sr*hi) + si*hr,
//     so no multiply-add is contracted and the kernel is bit-equal to the
//     plain PyTorch loop.
// No tensor cores and no TMA: nothing here is a product of matrices, and
// the tile copies would need 16-byte aligned rows.  On an H100 the
// arithmetic, not the bytes, sets the pace (scripts/torch_fir_trace.py
// times copies of this source that only copy or only compute): the rounded
// operations keep it near half of the byte bound.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py).  The launch plan (tile,
// rows a unit, threads, row pitch, shared bytes, grid) is made by the
// caller, `fir_plan` in dl_ofdm_tpu_torch/ops/pallas_kernels.py; the entry
// point checks it against the layout below.  The launch goes on the
// caller's stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

struct FirArgs {
  const float* xar;   // [B, La] pre-aligned rows, real plane
  const float* xai;   // [B, La] imaginary plane
  const float* hr;    // [B, F] taps, real
  const float* hi;    // [B, F] taps, imaginary
  float* yr;          // [B, L]
  float* yi;          // [B, L]
  int B, L, F;        // La = L + F - 1
  int tile;           // outputs of a row a unit takes
  int rows;           // R, rows a unit takes
  int threads;        // a block's threads: R * G rounded up to a warp
  int row_stride;     // floats of a staged row (skewed), 9 G mod 32
  int smem;           // dynamic shared bytes
  int grid;
};

namespace {

constexpr int V = 8;              // outputs a thread
constexpr int KC = 8;             // taps a chunk
constexpr int PRE = 8;            // staged samples before a unit's first
constexpr int NBUF = 2;           // units staged at once (a ring)
constexpr int MIN_BLOCKS = 2;     // blocks a SM
constexpr int MAX_THREADS = 384;
constexpr int SMEM_MAX = 232448;  // 227 KB a block on sm_90

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; zeros where !valid (the source
// is not read then)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__host__ __device__ __forceinline__ int skew(int c) {
  return c + (c >> 3);
}

struct Unit {
  int b0, n0;       // first row, first output
};

__device__ __forceinline__ Unit unit_of(const FirArgs& a, int u,
                                        int n_chunks) {
  const int g = u / n_chunks;
  return {g * a.rows, (u - g * n_chunks) * a.tile};
}

// stage unit u's rows (samples n0 - PRE .. n0 + 8G + F - 2 of each, both
// planes) and taps into buffer `buf`, as one cp.async group
__device__ __forceinline__ void issue_unit(const FirArgs& a, float* buf,
                                           Unit un, int width) {
  const int La = a.L + a.F - 1, R = a.rows, F = a.F;
  float* sr = buf;
  float* si = buf + R * a.row_stride;
  float* tr = buf + 2 * R * a.row_stride;
  float* ti = tr + R * F;
  for (int r = 0; r < R; ++r) {
    const int b = un.b0 + r;
    const bool row_ok = b < a.B;
    const size_t ro = static_cast<size_t>(row_ok ? b : 0) * La;
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      const int col = un.n0 - PRE + c;
      const bool ok = row_ok && col >= 0 && col < La;
      const size_t o = ok ? ro + col : 0;
      const int s = r * a.row_stride + skew(c);
      cp_async4(sr + s, a.xar + o, ok);
      cp_async4(si + s, a.xai + o, ok);
    }
  }
  for (int e = threadIdx.x; e < R * F; e += blockDim.x) {
    const bool ok = un.b0 + e / F < a.B;
    const size_t o = ok ? static_cast<size_t>(un.b0) * F + e : 0;
    cp_async4(tr + e, a.hr + o, ok);
    cp_async4(ti + e, a.hi + o, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
fir_shift_accum_kernel(FirArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int R = a.rows, F = a.F, L = a.L;
  const int G = (a.tile + V - 1) / V;           // threads a row
  const int width = PRE + V * G + F - 1;        // staged samples a row
  const int n_chunks = (L + a.tile - 1) / a.tile;
  const int units = (a.B + R - 1) / R * n_chunks;
  const int per_buf = 2 * R * a.row_stride + 2 * R * F;
  const int tid = threadIdx.x;
  const int r = tid / G, g = tid - r * G;       // row of the unit, group
  const bool active = r < R;

  // the ring: unit i of this block (u = blockIdx.x + i * grid) lands in
  // buffer i % NBUF, issued NBUF - 1 units ahead; one cp.async group a
  // unit, empty past the last
  for (int i = 0; i < NBUF - 1; ++i) {
    const int u = blockIdx.x + i * gridDim.x;
    if (u < units)
      issue_unit(a, smem + i * per_buf, unit_of(a, u, n_chunks), width);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NBUF - 2) : "memory");
    // unit u has landed, and every thread is done with unit u - grid, so
    // its buffer takes unit u + (NBUF - 1) grid
    __syncthreads();
    const int ahead = u + (NBUF - 1) * gridDim.x;
    if (ahead < units)
      issue_unit(a, smem + (i + NBUF - 1) % NBUF * per_buf,
                 unit_of(a, ahead, n_chunks), width);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int buf = i % NBUF;

    const Unit un = unit_of(a, u, n_chunks);
    const int b = un.b0 + r;
    if (active && b < a.B && un.n0 + V * g < L && V * g < a.tile) {
      const float* base = smem + buf * per_buf;
      const float* sr = base + r * a.row_stride + 9 * g;
      const float* si = sr + R * a.row_stride;
      const float* tr = base + 2 * R * a.row_stride + r * F;
      const float* ti = tr + R * F;
      float accr[V], acci[V];
#pragma unroll
      for (int v = 0; v < V; ++v) accr[v] = acci[v] = 0.f;
      for (int kb = 0; kb < F; kb += KC) {
        // output v, tap kb + kk reads window sample v + KC - 1 - kk, at
        // staged column 8g + c0 + v + KC - 1 - kk (c0 >= 1)
        const int c0 = PRE + F - 1 - kb - (KC - 1);
        float xr[V + KC - 1], xi[V + KC - 1], hr[KC], hi[KC];
#pragma unroll
        for (int w = 0; w < V + KC - 1; ++w) {
          xr[w] = sr[skew(c0 + w)];
          xi[w] = si[skew(c0 + w)];
        }
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const bool ok = kb + kk < F;
          hr[kk] = ok ? tr[kb + kk] : 0.f;
          hi[kk] = ok ? ti[kb + kk] : 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          if (kb + kk >= F) break;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float s_r = xr[v + KC - 1 - kk], s_i = xi[v + KC - 1 - kk];
            accr[v] = __fsub_rn(__fadd_rn(accr[v], __fmul_rn(s_r, hr[kk])),
                                __fmul_rn(s_i, hi[kk]));
            acci[v] = __fadd_rn(__fadd_rn(acci[v], __fmul_rn(s_r, hi[kk])),
                                __fmul_rn(s_i, hr[kk]));
          }
        }
      }
      const int n = un.n0 + V * g;
      const int nv = min(min(V, L - n), a.tile - V * g);
      const size_t o = static_cast<size_t>(b) * L + n;
      if (nv == V && L % 4 == 0) {       // 16-byte aligned: n0, 8g, L
        float4* pr = reinterpret_cast<float4*>(a.yr + o);
        float4* pi = reinterpret_cast<float4*>(a.yi + o);
        pr[0] = make_float4(accr[0], accr[1], accr[2], accr[3]);
        pr[1] = make_float4(accr[4], accr[5], accr[6], accr[7]);
        pi[0] = make_float4(acci[0], acci[1], acci[2], acci[3]);
        pi[1] = make_float4(acci[4], acci[5], acci[6], acci[7]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (v < nv) {
            a.yr[o + v] = accr[v];
            a.yi[o + v] = acci[v];
          }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

bool plan_ok(const FirArgs& a) {
  if (a.B <= 0 || a.L <= 0 || a.F <= 0 || a.tile <= 0 || a.tile > a.L ||
      (a.tile < a.L && a.tile % V) || a.rows < 1 || a.grid < 1)
    return false;
  const int G = (a.tile + V - 1) / V;
  const int width = PRE + V * G + a.F - 1;
  const long long per_buf = 2LL * a.rows * a.row_stride + 2LL * a.rows * a.F;
  return a.threads % 32 == 0 && a.threads >= a.rows * G &&
         a.threads <= MAX_THREADS && a.row_stride >= skew(width - 1) + 1 &&
         (a.row_stride - 9 * G) % 32 == 0 &&
         a.smem >= NBUF * 4 * per_buf && a.smem <= SMEM_MAX;
}

}  // namespace

extern "C" int fir_shift_accum_f32(const FirArgs* args, void* stream) {
  const FirArgs a = *args;
  if (!plan_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fir_shift_accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fir_shift_accum_kernel<<<a.grid, a.threads, a.smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// blocks of `threads` threads at `smem` shared bytes that one SM of the
// current device holds (out[0]), and the device's SMs (out[1])
extern "C" int fir_shift_accum_blocks_per_sm(int threads, int smem,
                                             int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fir_shift_accum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, fir_shift_accum_kernel, threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount,
                                 dev);
  return static_cast<int>(err);
}
