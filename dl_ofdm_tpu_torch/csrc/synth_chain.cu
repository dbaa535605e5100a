// synth_chain: the plain data plane of `Trainer.synthesize` (TX, the static
// Rayleigh FIR or the AWGN passthrough, AWGN, the receiver's input
// normalization) for a call whose frames all take a static FIR, in two
// launches.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it (`dl_ofdm_tpu/train/loop.py`, `Trainer.synthesize`).  On the
// card today's path takes ~80 launches a call and two host-to-device copies
// of per-frame tables from pageable memory, and the host's pace sets the
// call's time; this chain takes the same draws (bits, tap gains, unit
// noise: tensors the caller draws from its generator) and no copy.
//
//   kernel 1 (`chain_tx_kernel`), a block a group of R frame rows:
//     1. the frequency grid of each OFDM symbol (data symbols from the
//        bits, pilots, zeros) into shared memory; the rows' FIR kernels
//        gt = sum_t (z_t / sqrt 2) coeff_t alpha_t of their profile class
//        (row % P; pre-shifted to one 'same' offset, `profile_classes`);
//        each row's noise std and normalization group;
//     2. the inverse DFT of every symbol in shared memory: radix-2
//        decimation in frequency, natural order in, bit-reversed out
//        (the grid's rows padded by one entry in 16, so that the
//        bit-reversed reads of stage 3 spread over the banks);
//     3. the time samples with the cyclic prefix, scaled by 1/nfft, out as
//        the waveform and, where some row fades, into a zero-padded plane;
//     4. where some row fades, the 'same' convolution (a passthrough row:
//        its samples as they are), written out; each thread's sum of
//        |y|^2 (y the waveform where no row fades);
//     5. the true channel's DFT h[k] = sum_j gt[j] e^{-2 pi i j k / nfft}
//        over the class's own (unshifted) taps; 1 on a passthrough row;
//        the block's sum of |y|^2 by a fixed tree.
//   kernel 2 (`chain_norm_kernel`), a block a tile of W float columns of
//   the [B, 2L] plane over every frame, FS frame slices:
//     0. the batch's mean power from kernel 1's partials (a fixed tree);
//     1. v = y rsqrt(power) + std_b u, written in place; the noise's
//        squares; each slice's sums of d = v - K and d^2 in its own cells
//        of its frame's group (without groups one group of all frames), K
//        the group's first frame's value at the column;
//     2. the block's noise partial; each column's moments, the one-pass
//        E[v^2] - E[v]^2 of `batch_norm_ref` taken on the shifted d (the
//        same estimator, without the cancellation where a pilot's mean
//        dwarfs the spread); then (v - mean) rsqrt(var + 1e-9) / sqrt 2 in
//        place (`normalize` 0 stops after stage 1);
//     3. the last block to finish sums the noise partials in block order.
// Every sum is a fixed-order tree over fixed blocks, no float atomics: two
// calls on the same inputs give the same bits.
//
// Bound on an H100, reading each input and writing each output once: ~30
// MB at the 1,968-frame ETU call at nfft 64 (bits, tap gains, groups, unit
// noise in; waveform, receiver input, h out), 9 us at 3.35 TB/s; ~119 MB
// at the 992-frame AWGN call at nfft 512, 36 us.  The operations (a 64- or
// 512-point FFT a symbol, 13 taps a sample) are a few microseconds at the
// float32 rate.  Measured (CUDA graph, H100 80GB HBM3): kernel 1 31 / 74
// us, kernel 2 38 / 97 us at the two calls.  Kernel 1 spends its issue
// slots on the radix-2 stages and the loops' index arithmetic (the flat
// indices split by `FastDiv`); kernel 2 writes the noisy plane and reads
// it again, and its grouped sums in shared memory leave two or three
// blocks an SM, so few loads are in flight (each thread issues NB frames'
// loads before their stores).
//
// Plain C interface for ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py).  The
// plan (rows a block, columns and slices a block, shared bytes, grids) is
// made by the caller, `chain_plan` in dl_ofdm_tpu_torch/ops/synth_chain.py,
// which mirrors `tx_layout` and `norm_layout` below; the entry point
// checks it.  Both launches go on the caller's stream and the function
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// the arguments, filled field for field by a ctypes.Structure; outside the
// anonymous namespace, so that the extern "C" entry point keeps external
// linkage
struct ChainArgs {
  const int* gmap;          // [S * nfft] a grid cell's data index, -1 empty,
                            // -2 pilot
  const int* dpos;          // [D] the grid cell of each data symbol
  const float2* tw;         // [nfft / 2] e^{+2 pi i k / nfft}
  const float2* sym_tab;    // [2^nbits] symbol of each index
  const float* coeff;       // [P, taps]
  const float* alpha;       // [P, taps, fir_u] pre-shifted to off_u
  const int* cls_pass;      // [P] 1: a passthrough class
  const int* cls_shift;     // [P] off_u - the class's own 'same' offset
  const int* cls_nfir;      // [P] the class's own kernel length
  const float* noise_tab;   // [128] bf16 unit normals (with noise_idx)
  const int* bits;          // [B, D, nbits] 0/1
  const float2* zck;        // [B, zstride] tap gains before the 1 / sqrt 2
  const float* snr;         // [B] dB
  const float* onehot;      // [B, G] group rows (n_groups > 0)
  const float* noise;       // [B, 2L] float32 unit normals, or null
  const int* noise_idx;     // [B, 2L] 7-bit table indices, or null
  float* wf;                // [B, 2L] the transmitted waveform
  float* y;                 // [B, 2L] faded (kernel 1, where fade), then the
                            // receiver's input (kernel 2)
  float2* h;                // [B, nfft] the true channel's DFT
  float* pwr_part;          // [tx_grid] each block's sum of |y|^2
  float* stdv;              // [B] noise std per component
  int* grp;                 // [B] normalization group (-1: none)
  float* np_part;           // [norm_grid] each block's sum of squared noise
  float* noise_power;       // [1]
  unsigned int* done;       // [1] kernel 2's finished blocks; 0 between calls
  float pilot_re, pilot_im;
  int n_frames, nbits, nsymbol, nfft, log2n, cp, sps, frame_size;
  int n_classes, taps, zstride, fir_u, off_u;
  int fade;                 // 1: some class is not a passthrough
  int n_groups;             // G; 0: moments over the whole batch
  int normalize;
  int rows, tx_smem, tx_grid;
  int cols, slices, norm_smem, norm_grid;
};

namespace {

constexpr int THREADS = 256;             // kernel 1's block; kernel 2's most
constexpr int MAX_ROWS = 8;
constexpr int SMEM_LIMIT = 232448;       // 227 KB a block on sm_90
constexpr float SQRT_HALF = 0.70710677f;
constexpr float NORM_EPS = 1e-9f;
constexpr int NOISE_TAB = 128;           // the bf16 unit normals' table
constexpr int MAX_TABLE = 16;            // symbols of 16-QAM
constexpr int NB = 8;                    // kernel 2's loads in flight a thread

__host__ __device__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// kernel 1's shared memory for R rows: byte offsets of the grid [R][S][fp]
// (fp = nfft + nfft / 16, the padded symbol), the time planes [R][pitch]
// where a row fades (pitch = L + fir_u - 1, sample t at lead + t), the FIR
// kernels [R][fir_u], the power tree [THREADS], the symbol table [16] and
// the rows' groups [R]
struct TxLayout {
  int fp, pitch, lead;
  size_t grid, plane, gts, red, tab, grp, total;
};

__host__ __device__ TxLayout tx_layout(const ChainArgs& a, int R) {
  const size_t L = static_cast<size_t>(a.nsymbol) * a.sps;
  TxLayout ly;
  ly.fp = a.nfft + (a.nfft >> 4);
  ly.pitch = static_cast<int>(L) + a.fir_u - 1;
  ly.lead = a.fir_u - 1 - a.off_u;
  size_t o = 0;
  ly.grid = o;
  o = align16(o + static_cast<size_t>(R) * a.nsymbol * ly.fp * 8);
  ly.plane = o;
  o = align16(o + static_cast<size_t>(R) * ly.pitch * 8 * (a.fade ? 1 : 0));
  ly.gts = o;   o = align16(o + static_cast<size_t>(R) * a.fir_u * 8);
  ly.red = o;   o = align16(o + THREADS * 4);
  ly.tab = o;   o = align16(o + MAX_TABLE * 8);
  ly.grp = o;   o = align16(o + static_cast<size_t>(R) * 4);
  ly.total = o;
  return ly;
}

// kernel 2's shared memory: the reduction tree [T], the noise table
// [128]; where it normalizes the slices' sums [2][FS][Ge][W], the columns'
// shifts, then means, and scales [2][Ge][W], the groups' frame counts and
// first frames [Ge]
struct NormLayout {
  size_t red, tab, acc, stats, cnt, first, total;
};

__host__ __device__ NormLayout norm_layout(const ChainArgs& a) {
  const size_t W = a.cols, FS = a.slices, z = a.normalize ? 1 : 0;
  const size_t ge = a.n_groups > 0 ? a.n_groups : 1;
  NormLayout ly;
  size_t o = 0;
  ly.red = o;   o = align16(o + W * FS * 4);
  ly.tab = o;   o = align16(o + NOISE_TAB * 4);
  ly.acc = o;   o = align16(o + z * 2 * FS * ge * W * 4);
  ly.stats = o; o = align16(o + z * 2 * ge * W * 4);
  ly.cnt = o;   o = align16(o + z * ge * 4);
  ly.first = o; o = align16(o + z * ge * 4);
  ly.total = o;
  return ly;
}

// grid entry i of a symbol, one pad entry in 16
__device__ __forceinline__ int fpos(int i) { return i + (i >> 4); }

// x / d for 0 <= x < 2^31 by a multiply and a shift (d >= 1, set up once a
// thread): the loops' flat indices split without an integer division each
struct FastDiv {
  unsigned d, m, s;
  __device__ explicit FastDiv(int d_) : d(static_cast<unsigned>(d_)), s(0) {
    while ((1u << s) < d) ++s;
    m = static_cast<unsigned>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int x) const {
    const unsigned ux = static_cast<unsigned>(x);
    return static_cast<int>((__umulhi(ux, m) + ux) >> s);
  }
};

// the sum of red[0 .. T) into red[0] by a fixed tree (T a power of two);
// every thread of the block calls it
__device__ __forceinline__ float block_sum(float* red, float v) {
  const int tid = threadIdx.x;
  __syncthreads();
  red[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(THREADS)
chain_tx_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TxLayout ly = tx_layout(a, a.rows);
  float2* F = reinterpret_cast<float2*>(smem + ly.grid);    // [R][S][fp]
  float2* X = reinterpret_cast<float2*>(smem + ly.plane);   // [R][pitch]
  float2* G = reinterpret_cast<float2*>(smem + ly.gts);     // [R][fir_u]
  float* red = reinterpret_cast<float*>(smem + ly.red);
  float2* tab = reinterpret_cast<float2*>(smem + ly.tab);   // [2^nbits]
  int* gsel = reinterpret_cast<int*>(smem + ly.grp);        // [R]
  const int tid = threadIdx.x, T = blockDim.x;
  const int S = a.nsymbol, N = a.nfft, half0 = N >> 1, fp = ly.fp;
  const int SN = S * N, D = a.frame_size, nb = a.nbits, fir_u = a.fir_u;
  const int L = S * a.sps, pitch = ly.pitch, lead = ly.lead;
  const int row0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, a.n_frames - row0);
  const int NG = a.n_groups, lg = a.log2n;
  const FastDiv by_sn(SN), by_d(D), by_l(L), by_sps(a.sps), by_p(a.n_classes);
  auto cls_of = [&](int r) {
    const int row = row0 + r;
    return row - by_p.div(row) * a.n_classes;
  };
  float2* wf = reinterpret_cast<float2*>(a.wf);
  float2* yo = reinterpret_cast<float2*>(a.y);

  // --- 1. grids (the pilots and zeros by cell, the data symbols by data
  // index; the loops unrolled so that their loads are in flight together),
  // plane pads, FIR kernels, std and group of each row
  for (int e = tid; e < (1 << nb); e += T) tab[e] = __ldg(a.sym_tab + e);
  for (int r = tid; r < nrows; r += T) gsel[r] = NG;
  __syncthreads();
#pragma unroll 4
  for (int e = tid; e < nrows * SN; e += T) {
    const int r = by_sn.div(e), c = e - r * SN;
    const int m = __ldg(a.gmap + c);
    if (m >= 0) continue;
    const int s = c >> lg;
    F[(r * S + s) * fp + fpos(c & (N - 1))] =
        m == -2 ? make_float2(a.pilot_re, a.pilot_im) : make_float2(0.f, 0.f);
  }
#pragma unroll 4
  for (int e = tid; e < nrows * D; e += T) {
    const int r = by_d.div(e), d = e - r * D;
    const int* bp = a.bits + (static_cast<size_t>(row0) * D + e) * nb;
    unsigned idx = 0;
    for (int j = 0; j < nb; ++j)
      idx = (idx << 1) | static_cast<unsigned>(__ldg(bp + j) & 1);
    const int c = __ldg(a.dpos + d);
    F[(r * S + (c >> lg)) * fp + fpos(c & (N - 1))] = tab[idx];
  }
  const int padn = a.fade ? pitch - L : 0;
  for (int e = tid; e < nrows * padn; e += T) {
    const int r = e / padn, k = e - r * padn;
    X[r * pitch + (k < lead ? k : L + k)] = make_float2(0.f, 0.f);
  }
  if (a.fade) {
    for (int e = tid; e < nrows * fir_u; e += T) {
      const int r = e / fir_u, k = e - r * fir_u;
      const int cls = cls_of(r);
      if (a.cls_pass[cls]) continue;
      const float2* z = a.zck + static_cast<size_t>(row0 + r) * a.zstride;
      float gr = 0.f, gi = 0.f;
#pragma unroll 4
      for (int t = 0; t < a.taps; ++t) {
        const float2 zt = __ldg(z + t);
        const float c = __ldg(a.coeff + cls * a.taps + t);
        const float al = __ldg(a.alpha + (cls * a.taps + t) * fir_u + k);
        gr += ((zt.x * SQRT_HALF) * c) * al;
        gi += ((zt.y * SQRT_HALF) * c) * al;
      }
      G[r * fir_u + k] = make_float2(gr, gi);
    }
  }
  // each row's group: the first column of its one-hot row that is not 0
#pragma unroll 4
  for (int e = tid; e < nrows * NG; e += T)
    if (__ldg(a.onehot + static_cast<size_t>(row0) * NG + e) != 0.f)
      atomicMin(gsel + e / NG, e % NG);
  for (int r = tid; r < nrows; r += T) {
    const float snr = __ldg(a.snr + row0 + r);
    a.stdv[row0 + r] = SQRT_HALF * powf(10.f, -snr / 20.f);
  }
  __syncthreads();
  for (int r = tid; NG > 0 && r < nrows; r += T)
    a.grp[row0 + r] = gsel[r] < NG ? gsel[r] : -1;

  // --- 2. inverse DFT of each symbol: radix-2 decimation in frequency
  for (int half = half0, step = 1; half >= 1; half >>= 1, step <<= 1) {
    for (int e = tid; e < nrows * S * half0; e += T) {
      const int q = e >> (lg - 1), j = e & (half0 - 1);
      const int p = j & (half - 1), i0 = ((j - p) << 1) + p;
      float2* f = F + q * fp;
      const float2 u = f[fpos(i0)], v = f[fpos(i0 + half)];
      const float2 w = __ldg(a.tw + p * step);
      const float dx = u.x - v.x, dy = u.y - v.y;
      f[fpos(i0)] = make_float2(u.x + v.x, u.y + v.y);
      f[fpos(i0 + half)] = make_float2(dx * w.x - dy * w.y,
                                       dx * w.y + dy * w.x);
    }
    __syncthreads();
  }

  // --- 3. time samples with the cyclic prefix, scaled by 1/nfft; where no
  // row fades, y is the waveform and only its power is summed
  const float inv_n = 1.f / static_cast<float>(N);     // a power of two
  float pw = 0.f;
  for (int e = tid; e < nrows * L; e += T) {
    const int r = by_l.div(e), t = e - r * L;
    const int s = by_sps.div(t);
    int n = t - s * a.sps - a.cp;
    if (n < 0) n += N;
    const int br = static_cast<int>(__brev(static_cast<unsigned>(n)) >>
                                    (32 - a.log2n));
    const float2 v = F[(r * S + s) * fp + fpos(br)];
    const float2 x = make_float2(v.x * inv_n, v.y * inv_n);
    if (a.fade)
      X[r * pitch + lead + t] = x;
    else
      pw += x.x * x.x + x.y * x.y;
    wf[static_cast<size_t>(row0 + r) * L + t] = x;
  }
  __syncthreads();

  // --- 4. 'same' convolution in the unified offset: y[t] = sum_k
  // x[t + off_u - k] gt[k], x[j] at lead + j of the row's plane; a
  // passthrough row's samples as they are
  for (int e = tid; a.fade && e < nrows * L; e += T) {
    const int r = by_l.div(e), t = e - r * L;
    const int cls = cls_of(r);
    float2 v;
    if (a.cls_pass[cls]) {
      v = X[r * pitch + lead + t];
    } else {
      const float2* xb = X + r * pitch + t + fir_u - 1;
      const float2* g = G + r * fir_u;
      float vr = 0.f, vi = 0.f;
      for (int k = 0; k < fir_u; ++k) {
        const float2 s = xb[-k], gk = g[k];
        vr += s.x * gk.x - s.y * gk.y;
        vi += s.x * gk.y + s.y * gk.x;
      }
      v = make_float2(vr, vi);
    }
    yo[static_cast<size_t>(row0 + r) * L + t] = v;
    pw += v.x * v.x + v.y * v.y;
  }

  // --- 5. the true channel: the DFT of the class's own taps
  for (int e = tid; e < nrows * N; e += T) {
    const int r = e >> lg, k = e & (N - 1);
    const int cls = cls_of(r);
    float2 hv = make_float2(1.f, 0.f);
    if (a.fade && !a.cls_pass[cls]) {
      const float2* g = G + r * fir_u + a.cls_shift[cls];
      float hr = 0.f, hi = 0.f;
      for (int j = 0; j < a.cls_nfir[cls]; ++j) {
        const int m = (j * k) & (N - 1);
        float2 w = __ldg(a.tw + (m < half0 ? m : m - half0));
        if (m >= half0) w = make_float2(-w.x, -w.y);   // e^{+i pi} factor
        // times e^{-2 pi i m / N} = conj(w)
        hr += g[j].x * w.x + g[j].y * w.y;
        hi += g[j].y * w.x - g[j].x * w.y;
      }
      hv = make_float2(hr, hi);
    }
    a.h[static_cast<size_t>(row0 + r) * N + k] = hv;
  }
  const float total = block_sum(red, pw);
  if (tid == 0) a.pwr_part[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
chain_norm_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const NormLayout ly = norm_layout(a);
  float* red = reinterpret_cast<float*>(smem + ly.red);
  float* tab = reinterpret_cast<float*>(smem + ly.tab);     // [128]
  float* acc = reinterpret_cast<float*>(smem + ly.acc);     // [2][FS][Ge][W]
  float* stats = reinterpret_cast<float*>(smem + ly.stats); // [2][Ge][W]
  float* shift = stats;          // [Ge][W] each column's shift, then mean
  int* cnt = reinterpret_cast<int*>(smem + ly.cnt);         // [Ge]
  int* first = reinterpret_cast<int*>(smem + ly.first);     // [Ge]
  const int tid = threadIdx.x, T = blockDim.x;
  const int W = a.cols, FS = a.slices, w = tid % W, f = tid / W;
  const int B = a.n_frames, G = a.n_groups, ge = G > 0 ? G : 1;
  const size_t L = static_cast<size_t>(a.nsymbol) * a.sps, C = 2 * L;
  const size_t c0 = static_cast<size_t>(blockIdx.x) * W, c = c0 + w;
  const bool live = c < C;
  const float count = static_cast<float>(static_cast<size_t>(B) * L);

  // --- 0. the batch's mean power, from kernel 1's partials; the groups'
  // frame counts and first frames (without groups one group of all)
  float s = 0.f;
  for (int i = tid; i < a.tx_grid; i += T) s += a.pwr_part[i];
  const float scale = rsqrtf(block_sum(red, s) / count);
  const float* src = a.fade ? a.y : a.wf;
  if (!a.noise)
    for (int i = tid; i < NOISE_TAB; i += T) tab[i] = a.noise_tab[i];
  __syncthreads();
  auto unit = [&](size_t o) {
    return a.noise ? a.noise[o] : tab[a.noise_idx[o] & (NOISE_TAB - 1)];
  };
  auto noisy = [&](float y, float u, float sd, float& noise) {
    noise = __fmul_rn(sd, u);
    return __fadd_rn(__fmul_rn(y, scale), noise);
  };
  if (a.normalize) {
    for (int i = tid; i < 2 * FS * ge * W; i += T) acc[i] = 0.f;
    for (int i = tid; i < ge; i += T) {
      cnt[i] = G > 0 ? 0 : B;
      first[i] = G > 0 ? B : 0;
    }
    __syncthreads();
    if (G > 0)
#pragma unroll 4
      for (int b = tid; b < B; b += T) {
        const int g = a.grp[b];
        if (g >= 0) {
          atomicAdd(cnt + g, 1);
          atomicMin(first + g, b);
        }
      }
    __syncthreads();
    // each column's shift in each group: the group's first frame's value
    for (int e = tid; e < ge * W; e += T) {
      const int g = e / W;
      const size_t col = c0 + (e - g * W);
      float n0;
      shift[e] = 0.f;
      if (col < C && first[g] < B) {
        const size_t o = static_cast<size_t>(first[g]) * C + col;
        shift[e] = noisy(src[o], unit(o), a.stdv[first[g]], n0);
      }
    }
    __syncthreads();
  }

  // --- 1. v = y rsqrt(power) + std u, in place; the slices' shifted sums.
  // NB frames' loads are issued before any of their stores: y is written
  // where it is read, so no load could move past an earlier store
  float np = 0.f;
  float* a1 = acc + f * ge * W + w;
  float* a2 = a1 + FS * ge * W;
  for (int b0 = f; live && b0 < B; b0 += NB * FS) {
    float yv[NB], uv[NB], sd[NB];
    int gg[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int b = b0 + j * FS;
      if (b < B) {
        const size_t o = static_cast<size_t>(b) * C + c;
        yv[j] = src[o];
        uv[j] = unit(o);
        sd[j] = a.stdv[b];
        gg[j] = G > 0 ? a.grp[b] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int b = b0 + j * FS;
      if (b >= B) continue;
      float n;
      const float v = noisy(yv[j], uv[j], sd[j], n);
      np += n * n;
      a.y[static_cast<size_t>(b) * C + c] = v;
      const int g = gg[j];
      if (a.normalize && g >= 0) {
        const float d = v - shift[g * W + w];
        a1[g * W] += d;
        a2[g * W] += d * d;
      }
    }
  }

  // --- 2. noise partial; moments; normalization
  const float np_block = block_sum(red, np);
  if (tid == 0) a.np_part[blockIdx.x] = np_block;
  if (a.normalize) {
    for (int e = tid; e < ge * W; e += T) {
      const int g = e / W, ww = e - g * W;
      float t1 = 0.f, t2 = 0.f;
      for (int q = 0; q < FS; ++q) {
        t1 += acc[(q * ge + g) * W + ww];
        t2 += acc[((FS + q) * ge + g) * W + ww];
      }
      const float n = static_cast<float>(cnt[g]), m1 = t1 / n;
      stats[e] = shift[e] + m1;              // the mean, over the shift
      stats[ge * W + e] = rsqrtf((t2 / n - m1 * m1) + NORM_EPS);
    }
    __syncthreads();
    // the frames in reverse: the last ones written are the likeliest to be
    // in L2 still
    const int nlast = f + (B - 1 - f) / FS * FS;   // this slice's last frame
    for (int b0 = nlast; live && f < B && b0 >= 0; b0 -= NB * FS) {
      float v[NB];
      int gg[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int b = b0 - j * FS;
        if (b >= 0) {
          v[j] = a.y[static_cast<size_t>(b) * C + c];
          gg[j] = G > 0 ? a.grp[b] : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int b = b0 - j * FS;
        if (b < 0) continue;
        float mean = 0.f, sc = rsqrtf(NORM_EPS);   // a frame in no group
        if (gg[j] >= 0) {
          mean = stats[gg[j] * W + w];
          sc = stats[(ge + gg[j]) * W + w];
        }
        a.y[static_cast<size_t>(b) * C + c] = ((v[j] - mean) * sc) *
                                              SQRT_HALF;
      }
    }
  }

  // --- 3. the last block sums the noise partials in block order
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float t = 0.f;
  for (int i = tid; i < static_cast<int>(gridDim.x); i += T)
    t += __ldcg(a.np_part + i);
  const float total = block_sum(red, t);
  if (tid == 0) {
    *a.noise_power = total / count;
    *a.done = 0u;
  }
}

bool args_ok(const ChainArgs& a) {
  const long long L = static_cast<long long>(a.nsymbol) * a.sps;
  const long long C = 2 * L;
  const int T2 = a.cols * a.slices;
  return a.n_frames > 0 && a.nbits >= 1 && a.nbits <= 4 && a.nsymbol >= 1 &&
         a.log2n >= 1 && a.log2n <= 12 && a.nfft == (1 << a.log2n) &&
         a.cp >= 0 && a.cp < a.nfft && a.sps == a.nfft + a.cp &&
         a.frame_size >= 1 && a.n_classes >= 1 && a.taps >= 1 &&
         a.zstride >= a.taps && a.fir_u >= 1 && a.off_u >= 0 &&
         a.off_u < a.fir_u && a.n_groups >= 0 &&
         static_cast<long long>(a.n_frames) * C < (1LL << 31) &&
         a.rows >= 1 && a.rows <= MAX_ROWS &&
         a.tx_grid == (a.n_frames + a.rows - 1) / a.rows &&
         a.cols >= 1 && a.slices >= 1 && T2 <= THREADS &&
         (T2 & (T2 - 1)) == 0 &&
         a.norm_grid == static_cast<int>((C + a.cols - 1) / a.cols) &&
         a.gmap && a.dpos && a.tw && a.sym_tab && a.bits && a.snr && a.wf &&
         a.y && a.h && a.pwr_part && a.stdv && a.np_part && a.noise_power &&
         a.done && (a.noise || (a.noise_idx && a.noise_tab)) &&
         (!a.fade || (a.zck && a.coeff && a.alpha && a.cls_pass &&
                      a.cls_shift && a.cls_nfir)) &&
         (a.n_groups == 0 || (a.onehot && a.grp));
}

}  // namespace

extern "C" int synth_chain_f32(const ChainArgs* args, void* stream) {
  const ChainArgs& a = *args;
  if (!args_ok(a) ||
      tx_layout(a, a.rows).total != static_cast<size_t>(a.tx_smem) ||
      norm_layout(a).total != static_cast<size_t>(a.norm_smem) ||
      a.tx_smem > SMEM_LIMIT || a.norm_smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      chain_tx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.tx_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chain_norm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               a.norm_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_tx_kernel<<<a.tx_grid, THREADS, a.tx_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_norm_kernel<<<a.norm_grid, a.cols * a.slices, a.norm_smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
