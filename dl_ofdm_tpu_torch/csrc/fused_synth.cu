// fused_synth: the training step's data plane, bits -> OFDM TX -> Rayleigh
// FIR (static or Jakes-Doppler) -> AWGN -> per-position partial sums, one
// pass per frame row.
//
// Replaces the TPU kernel `_p1_kernel` of dl_ofdm_tpu/ops/fused_synth.py
// (lines 449-636, pallas_call at 763): static profiles, the AWGN
// passthrough, the mixRayleigh/mixAll cycles, the Doppler (mobile) rows and
// the true channel (want_h).  Per frame row it
//   1. draws the symbol indices (Philox stream 0) and writes them; draws
//      the row's static Rayleigh taps (streams 1, 2; Box-Muller), and on a
//      Doppler row (global row % C on in dop_cycle) its 2*SS*taps Jakes
//      phases (streams 5, 6);
//   2. on a Doppler row, sums the SS sinusoids of each tap at each symbol
//      time, z_s = sqrt(1/SS) sum_n cos(2 pi s t_sym fd base_n + theta_n),
//      n ascending;
//   3. runs the per-symbol TX operator, x = sum_d sym_d * w[d, :] + bias,
//      into a zero-padded row of shared memory; builds its FIR kernel
//      gt = gbias + sum_t z_t coeff_t alpha_t from the constants of its
//      profile class (global row % P), one kernel per symbol on a Doppler
//      row; with want_h, writes h = hbias + sum_t z_t coeff_t hb_t (per
//      symbol on a mobile spec);
//   4. convolves 'same' in the unified offset (a Doppler row: per symbol,
//      with n_taps look-back and zero future), draws the noise (streams 3,
//      4; Box-Muller) at the row's std, writes y and n, and adds the row
//      into its block's 10 per-position sums (y, y^2, n, n^2, y*n for each
//      IQ plane).
// The host side sums the blocks' partials, stats [grid, 10, L], and
// derives the normalization (`_combine_stats`), as XLA does on the TPU.
//
// Random words: Philox4x32-10 (philox.cuh), key (seed0, seed1), counter
// (j / 4, stream, row, 0), word j = lane j % 4.  The plain version
// (dl_ofdm_tpu_torch/ops/fused_synth.py) makes the same words in torch, so
// the two agree draw for draw.  No --use_fast_math: logf, sincosf and cosf
// stay within a few ulp of torch's.  The Doppler arithmetic is written with
// explicit _rn operations in the plain version's order, so that no multiply
// and add are contracted where torch rounds twice.
//
// Bound on an H100 at 9,362 static frames: ~0.27 MFLOP per frame (the TX
// operator, 320 x 80 complex MACs, is 0.2 of it), ~2.5 GFLOP in all, 38 us
// at the float32 rate; the ~96 MB written take 29 us at 3.35 TB/s.  The
// noise's Box-Muller (accurate logf, sqrtf, sincosf) and Philox words are
// not in that count and take about as many issue slots as the TX.
//
// Design; scripts/torch_synth_stage_trace.py times each stage on the card
// (copies of this source that stop before each `// --- n.` marker):
//   * persistent blocks of 288 threads, two a SM: block b walks row groups
//     b, b + grid, ... of R rows (8 at nfft 64), a fixed set, so two calls
//     give the same bits; stage 4's threads add each row into their own
//     cells of per-block sums in shared memory, and the block writes one
//     [10, L] partial at the end (264 partials at nfft 64).  Sums in
//     registers across the groups spilled at the 96 registers that two
//     9-warp blocks a SM leave;
//   * stage 1 decodes each row's symbols once into two float planes; stage
//     3's TX gives a thread a tile of 8 rows x 2 consecutive samples of one
//     symbol (4 rows x 4 at 4 rows a group): per data subcarrier one
//     16-byte load of the operator through the read-only cache, prefetched
//     a subcarrier ahead, and 8 broadcast symbol loads feed 32 FMAs (64
//     for a complex table; BPSK's is real and its zero imaginary products
//     are dropped).  The operator's traffic from L2, 25 KB a frame, is
//     what bounds this stage; the cyclic prefix's columns repeat the
//     symbol's last ones exactly, so TX computes nfft of the sps samples
//     and copies the prefix (20 % less of both).  No tensor cores: the
//     3xTF32 split would triple the products of a stage bound by its loads;
//   * stage 4 gives a thread one column quad of every other row (H = 2
//     halves of the rows at nfft 64): the FIR reads a window of the padded
//     row by 16-byte loads, aligned for every quad because the row's store
//     is offset by the kernel's look-back (conflict-free: neighbours read
//     neighbouring 16 bytes), taps in chunks of 8 with the window in
//     registers; a Doppler column's valid tap range is computed once a
//     column, not tested per tap against a division;
//   * stage 2 spreads the Jakes sums of a group's Doppler rows over all
//     threads, one (row, symbol, tap, plane) sum of SS cosines a thread; a
//     mobile group's phases and bases live in the planes' space until TX;
//   * four barriers a group (five on a mobile spec); the two blocks of a SM
//     overlap each other's.
//
// Plain C interface for ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py).  The
// launch plan (rows a group, threads, halves, shared bytes, grid) is made by
// the caller, `synth_plan` in dl_ofdm_tpu_torch/ops/fused_synth.py, which
// mirrors `layout` below; the entry point checks it.  The launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

// the arguments, filled field for field by a ctypes.Structure; outside the
// anonymous namespace, so that the extern "C" entry point keeps external
// linkage
struct SynthArgs {
  const long long* seeds;   // [2] seed words (values < 2^32)
  const float* std_;        // [B] noise std per component
  const float2* w_iq;       // [D, sps] TX operator rows (re, im)
  const float2* bias_iq;    // [S, sps] pilots' waveform
  const float2* sym_tab;    // [2^nbits] symbol of each index
  const int* sym_start;     // [S + 1] first data row of each symbol
  const float* coeff;       // [P, taps]
  const float* alpha;       // [P, taps, fir_u]
  const float* gbias;       // [P, fir_u]
  const float2* hb_iq;      // [P, taps, nfft] alpha @ DFT (want_h)
  const float* hbias;       // [P, nfft] H of the passthrough delta
  const float* fd_cls;      // [P] Doppler shift (Hz) (mobile)
  const int* dop_cycle;     // [C] 1: the row takes the Jakes path (mobile)
  const float2* jakes_base; // [SS * taps] (base_re, base_im) (mobile)
  const float* sym_phase;   // [S] float32(2 pi s t_sym) (mobile)
  int* idx;                 // [B, D]
  float *yr, *yi, *nr, *ni; // [B, L]
  float2* h;                // [B, S or 1, nfft] (want_h)
  float* stats;             // [grid, 10, L]
  float jakes_c1;           // float32(sqrt(1 / SS))
  int n_frames, nbits, nsymbol, sps, frame_size, n_classes, taps, fir_u,
      off_u, do_fir, nfft, mobile, cyc_len, ss, want_h;
  int real_tab;             // 1: every symbol's imaginary part is 0
  int cp;                   // > 0: samples t < cp of a symbol repeat t + nfft
                            // in w and bias (the cyclic prefix)
  int rows;                 // R, frame rows a group
  int threads;              // a block's
  int halves;               // H: stage 4 splits a group's rows H ways
  int smem;                 // dynamic shared bytes (layout(R).total)
  int grid;                 // blocks, and partials in stats
};

namespace {

constexpr int STATS = 10;
constexpr int MAX_ROWS = 8;
constexpr int MAX_TABLE = 16;
constexpr int FW = 8;                    // FIR taps a window chunk
constexpr int SMEM_LIMIT = 232448;       // 227 KB a block on sm_90

size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// shared memory for R rows: byte offsets of the regions, and the planes'
// row pitch (floats) and lead (the store offset of sample 0).  The planes
// region holds a mobile group's Jakes phases and bases before TX fills it.
struct Layout {
  int pitch, lead, nch;
  size_t sym, sums, zs, zsym, gts, tab, coef, alph, gb, sstart, total;
};

Layout layout(const SynthArgs& a, int R) {
  const size_t S = a.nsymbol, L = S * a.sps, L4c = (L + 3) / 4;
  const size_t nsst = static_cast<size_t>(a.ss) * a.taps;
  const size_t S1 = a.mobile ? S : 1, R4 = (R + 3) / 4 * 4;
  const size_t P = a.n_classes, taps = a.taps, fir_u = a.fir_u;
  Layout ly;
  ly.nch = (a.fir_u + FW - 1) / FW;
  ly.pitch = static_cast<int>(4 * L4c + FW * ly.nch);
  ly.lead = a.fir_u - 1 - a.off_u;
  size_t planes = 2 * static_cast<size_t>(R) * ly.pitch;
  const size_t jakes = a.mobile ? 2 * R * nsst + 2 * nsst : 0;
  if (planes < jakes) planes = jakes;
  size_t o = align16(planes * sizeof(float));
  ly.sym = o;    o = align16(o + 2 * R4 * a.frame_size * sizeof(float));
  ly.sums = o;   o = align16(o + a.halves * STATS * L * sizeof(float));
  ly.zs = o;     o = align16(o + R * taps * sizeof(float2));
  ly.zsym = o;   o = align16(o + (a.mobile ? R * S * taps : 0) * sizeof(float2));
  ly.gts = o;    o = align16(o + R * S1 * fir_u * sizeof(float2));
  ly.tab = o;    o = align16(o + MAX_TABLE * sizeof(float2));
  ly.coef = o;   o = align16(o + P * taps * sizeof(float));
  ly.alph = o;   o = align16(o + P * taps * fir_u * sizeof(float));
  ly.gb = o;     o = align16(o + P * fir_u * sizeof(float));
  ly.sstart = o; o = align16(o + (S + 1) * sizeof(int));
  ly.total = o;
  return ly;
}

__device__ __forceinline__ float2 box_muller(float u1, float u2) {
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.2831855f * u2, &s, &c);   // float32(2 pi) * u2
  return make_float2(r * c, r * s);
}

// h = hbias + sum_t (z_t coeff_t) hb_t, complex, in the plain version's
// order ((h + cr*br) - ci*bi, (h + cr*bi) + ci*br)
__device__ __forceinline__ float2 tap_h(const SynthArgs& a, const float2* z,
                                        const float* coef, int cls, int k) {
  float hr = a.hbias[cls * a.nfft + k], hi = 0.f;
  for (int t = 0; t < a.taps; ++t) {
    const float c = coef[cls * a.taps + t];
    const float cr = __fmul_rn(z[t].x, c), ci = __fmul_rn(z[t].y, c);
    const float2 b = __ldg(a.hb_iq + (static_cast<size_t>(cls) * a.taps + t) *
                                         a.nfft + k);
    hr = __fsub_rn(__fadd_rn(hr, __fmul_rn(cr, b.x)), __fmul_rn(ci, b.y));
    hi = __fadd_rn(__fadd_rn(hi, __fmul_rn(cr, b.y)), __fmul_rn(ci, b.x));
  }
  return make_float2(hr, hi);
}

// the TS operator samples w[d][t0 .. t0 + TS) (zeros past nt)
template <int TS>
__device__ __forceinline__ void load_w(const float2* wp, bool vec, int nt,
                                       float2 (&w)[TS]) {
  if (vec && nt == TS) {       // (d P + t0) even: 16-byte aligned
#pragma unroll
    for (int v = 0; v < TS / 2; ++v) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(wp) + v);
      w[2 * v] = make_float2(u.x, u.y);
      w[2 * v + 1] = make_float2(u.z, u.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < TS; ++j)
      w[j] = j < nt ? __ldg(wp + j) : make_float2(0.f, 0.f);
  }
}

// TX of a group: tile (symbol s, sample run q) sums sym[r][d] * w[d][t]
// over the symbol's data rows d for the tile's TR rows and TS = 16 / TR
// samples from cp + TS q, products in the plain complex order (REAL: the
// table's imaginary parts are 0 and their products are dropped).  The
// next subcarrier's operator samples load while this one's multiply.  With
// cp > 0 the prefix's samples are copies of the symbol's last cp, whose
// operator columns and bias they repeat exactly.
template <bool REAL, int TR>
__device__ __forceinline__ void tx_group(const SynthArgs& a,
                                         const float* symr,
                                         const float* symi,
                                         const int* sstart, float* xr,
                                         float* xi, int nrows, int pitch,
                                         int lead) {
  constexpr int TS = 16 / TR;
  const int S = a.nsymbol, P = a.sps, D = a.frame_size, cp = a.cp;
  const int NQ = (P - cp + TS - 1) / TS;
  const bool vec = P % 2 == 0 && cp % 2 == 0;
  for (int e = threadIdx.x; e < S * NQ; e += blockDim.x) {
    const int q = e % NQ, s = e / NQ;
    const int t0 = cp + TS * q, nt = min(TS, P - t0);
    const int d0 = sstart[s], d1 = sstart[s + 1];
    float ar[TR][TS], ai[TR][TS];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) ar[i][j] = ai[i][j] = 0.f;
    const float2* wp = a.w_iq + t0;
    float2 wn[TS];
    if (d0 < d1) load_w<TS>(wp + static_cast<size_t>(d0) * P, vec, nt, wn);
    for (int d = d0; d < d1; ++d) {
      float2 w[TS];
#pragma unroll
      for (int j = 0; j < TS; ++j) w[j] = wn[j];
      if (d + 1 < d1)
        load_w<TS>(wp + static_cast<size_t>(d + 1) * P, vec, nt, wn);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float sx = symr[i * D + d];
        const float sy = REAL ? 0.f : symi[i * D + d];
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          ar[i][j] = fmaf(sx, w[j].x, ar[i][j]);
          ai[i][j] = fmaf(sx, w[j].y, ai[i][j]);
          if (!REAL) {
            ar[i][j] = fmaf(-sy, w[j].y, ar[i][j]);
            ai[i][j] = fmaf(sy, w[j].x, ai[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (i >= nrows) continue;
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        if (j >= nt) continue;
        const float2 b = a.bias_iq[s * P + t0 + j];
        const int o = i * pitch + lead + s * P + t0 + j;
        const float vr = ar[i][j] + b.x, vi = ai[i][j] + b.y;
        xr[o] = vr;
        xi[o] = vi;
        if (cp && t0 + j >= a.nfft) {    // the prefix: the same sums
          xr[o - a.nfft] = vr;
          xi[o - a.nfft] = vi;
        }
      }
    }
  }
}

template <int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
fused_synth_kernel(SynthArgs a, Layout ly) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int R = a.rows, R4 = (R + 3) / 4 * 4;
  const int S = a.nsymbol, P = a.sps, D = a.frame_size;
  const int L = S * P, L4c = (L + 3) / 4;
  const int pitch = ly.pitch, lead = ly.lead;
  const uint32_t k0 = static_cast<uint32_t>(a.seeds[0]);
  const uint32_t k1 = static_cast<uint32_t>(a.seeds[1]);
  const int ncls = a.n_classes, taps = a.taps, fir_u = a.fir_u;
  const int nsst = a.ss * taps, S1 = a.mobile ? S : 1;
  const int groups = (a.n_frames + R - 1) / R;

  float* xr = reinterpret_cast<float*>(smem);    // [R][pitch]
  float* xi = xr + R * pitch;                    // [R][pitch]
  // a mobile group's Jakes phases [R][2][nsst] and bases [nsst], before TX
  float* theta = xr;
  float2* jb = reinterpret_cast<float2*>(theta + 2 * R * nsst);
  float* symr = reinterpret_cast<float*>(smem + ly.sym);     // [R4][D]
  float* symi = symr + R4 * D;                               // [R4][D]
  float* sums = reinterpret_cast<float*>(smem + ly.sums);    // [H][10][L]
  float2* zs = reinterpret_cast<float2*>(smem + ly.zs);      // [R][taps]
  float2* zsym = reinterpret_cast<float2*>(smem + ly.zsym);  // [R][S][taps]
  float2* gts = reinterpret_cast<float2*>(smem + ly.gts);    // [R][S1][fir_u]
  float2* tab = reinterpret_cast<float2*>(smem + ly.tab);
  float* coef = reinterpret_cast<float*>(smem + ly.coef);    // [P][taps]
  float* alph = reinterpret_cast<float*>(smem + ly.alph);    // [P][taps][fir_u]
  float* gb = reinterpret_cast<float*>(smem + ly.gb);        // [P][fir_u]
  int* sstart = reinterpret_cast<int*>(smem + ly.sstart);    // [S + 1]

  // constants; the planes' pads stay zero (TX writes the samples only; a
  // mobile group zeroes them again after its Jakes stage)
  for (int e = tid; e < (1 << a.nbits); e += T) tab[e] = a.sym_tab[e];
  for (int e = tid; e <= S; e += T) sstart[e] = a.sym_start[e];
  for (int e = tid; e < ncls * taps; e += T) coef[e] = a.coeff[e];
  for (int e = tid; e < ncls * taps * fir_u; e += T) alph[e] = a.alpha[e];
  for (int e = tid; e < ncls * fir_u; e += T) gb[e] = a.gbias[e];
  for (int e = tid; e < 2 * R * pitch; e += T) xr[e] = 0.f;
  for (int e = tid; e < a.halves * STATS * L; e += T) sums[e] = 0.f;

  // this thread's part of stage 4: column quad c4 of rows hh, hh + H, ...
  // of every group; its sums go to slot hh, in a fixed order
  const int H = a.halves;
  const int c4 = tid % L4c, hh = tid / L4c;
  const bool owner = hh < H;
  const int col = 4 * c4, nq = min(4, L - col);
  __syncthreads();

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int row0 = grp * R;
    const int nrows = min(R, a.n_frames - row0);

    // the group's Doppler rows, by bit
    unsigned dmask = 0;
    if (a.mobile)
      for (int r = 0; r < nrows; ++r)
        dmask |= (a.dop_cycle[(row0 + r) % a.cyc_len] ? 1u : 0u) << r;

    // --- 1. indices and symbols, static taps, Jakes phases
    {
      const int nb_idx = (D + 3) / 4;
      const uint32_t mask = (1u << a.nbits) - 1u;
      const bool vec = D % 4 == 0;
      for (int e = tid; e < nrows * nb_idx; e += T) {
        const int r = e / nb_idx, j4 = e - r * nb_idx;
        const int row = row0 + r;
        const uint4 w = philox(j4, 0u, row, 0u, k0, k1);
        int v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = static_cast<int>(lane(w, q) & mask);
        int* out = a.idx + static_cast<size_t>(row) * D + 4 * j4;
        if (vec) *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2],
                                                           v[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (4 * j4 + q < D) {
            if (!vec) out[q] = v[q];
            const float2 sy = tab[v[q]];
            symr[r * D + 4 * j4 + q] = sy.x;
            symi[r * D + 4 * j4 + q] = sy.y;
          }
        }
      }
    }
    if (a.do_fir) {
      const int nb = (taps + 3) / 4;
      for (int e = tid; e < nrows * nb; e += T) {
        const int r = e / nb, t4 = e - r * nb;
        const int row = row0 + r;
        const uint4 w1 = philox(t4, 1u, row, 0u, k0, k1);
        const uint4 w2 = philox(t4, 2u, row, 0u, k0, k1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 4 * t4 + q;
          if (t < taps) {
            const float2 g = box_muller(u01(lane(w1, q)), u01(lane(w2, q)));
            zs[r * taps + t] = make_float2(g.x * 0.70710677f,
                                           g.y * 0.70710677f);
          }
        }
      }
    }
    if (a.mobile) {
      for (int e = tid; e < nsst; e += T) jb[e] = a.jakes_base[e];
      const int nb = (nsst + 3) / 4;
      for (int e = tid; e < __popc(dmask) * 2 * nb; e += T) {
        const int r = __fns(dmask, 0, e / (2 * nb) + 1);
        const int c = (e / nb) % 2, j4 = e % nb;
        const uint4 w = philox(j4, 5u + c, row0 + r, 0u, k0, k1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * j4 + q;
          if (j < nsst)
            theta[(r * 2 + c) * nsst + j] = __fmul_rn(6.2831855f,
                                                      u01(lane(w, q)));
        }
      }
    }
    __syncthreads();

    // --- 2. Jakes gains of the group's Doppler rows
    if (a.mobile) {
      const int per_row = S * taps * 2;
      for (int e = tid; e < __popc(dmask) * per_row; e += T) {
        const int r = __fns(dmask, 0, e / per_row + 1), f = e % per_row;
        const int c = f % 2, t = (f / 2) % taps, s = f / (2 * taps);
        const float fd = a.fd_cls[(row0 + r) % ncls];
        const float cs = a.sym_phase[s];
        const float* th = theta + (r * 2 + c) * nsst;
        float z = 0.f;
        for (int n = 0; n < a.ss; ++n) {
          const float2 b = jb[n * taps + t];
          const float fv = __fmul_rn(fd, c ? b.y : b.x);
          const float v = cosf(__fadd_rn(__fmul_rn(cs, fv), th[n * taps + t]));
          z = n ? __fadd_rn(z, v) : v;
        }
        float* dst = reinterpret_cast<float*>(zsym + (r * S + s) * taps + t);
        dst[c] = __fmul_rn(a.jakes_c1, z);
      }
      __syncthreads();
      // the phases are done with: the planes' pads are zeros again
      const int padn = pitch - L;
      for (int e = tid; e < 2 * R * padn; e += T) {
        const int rp = e / padn, c = e - rp * padn;
        xr[rp * pitch + (c < lead ? c : L + c)] = 0.f;
      }
    }

    // --- 3. TX into the padded planes; FIR kernels; true channel
    if (R4 == 8) {
      if (a.real_tab)
        tx_group<true, 8>(a, symr, symi, sstart, xr, xi, nrows, pitch, lead);
      else
        tx_group<false, 8>(a, symr, symi, sstart, xr, xi, nrows, pitch, lead);
    } else {
      if (a.real_tab)
        tx_group<true, 4>(a, symr, symi, sstart, xr, xi, nrows, pitch, lead);
      else
        tx_group<false, 4>(a, symr, symi, sstart, xr, xi, nrows, pitch, lead);
    }
    if (a.do_fir) {
      // kernel slot s of row r: the static kernel in slot 0; a Doppler
      // row's symbol s in slot s
      for (int e = tid; e < nrows * S1 * fir_u; e += T) {
        const int k = e % fir_u, s = (e / fir_u) % S1, r = e / (fir_u * S1);
        const int cls = (row0 + r) % ncls;
        float gr = gb[cls * fir_u + k], gi = 0.f;
        if ((dmask >> r) & 1) {
          const float2* z = zsym + (r * S + s) * taps;
          for (int t = 0; t < taps; ++t) {
            const float c = coef[cls * taps + t];
            const float al = alph[(cls * taps + t) * fir_u + k];
            gr = __fadd_rn(gr, __fmul_rn(__fmul_rn(z[t].x, c), al));
            gi = __fadd_rn(gi, __fmul_rn(__fmul_rn(z[t].y, c), al));
          }
        } else if (s == 0) {
          for (int t = 0; t < taps; ++t) {
            const float2 z = zs[r * taps + t];
            const float c = coef[cls * taps + t];
            const float al = alph[(cls * taps + t) * fir_u + k];
            gr += (z.x * c) * al;
            gi += (z.y * c) * al;
          }
        } else {
          continue;
        }
        gts[(r * S1 + s) * fir_u + k] = make_float2(gr, gi);
      }
      if (a.want_h) {
        for (int e = tid; e < nrows * S1 * a.nfft; e += T) {
          const int k = e % a.nfft, s = (e / a.nfft) % S1;
          const int r = e / (a.nfft * S1);
          const int cls = (row0 + r) % ncls;
          const float2* z = (dmask >> r) & 1 ? zsym + (r * S + s) * taps
                                             : zs + r * taps;
          a.h[(static_cast<size_t>(row0 + r) * S1 + s) * a.nfft + k] =
              tap_h(a, z, coef, cls, k);
        }
      }
    } else if (a.want_h) {
      for (int e = tid; e < nrows * a.nfft; e += T)
        a.h[static_cast<size_t>(row0) * a.nfft + e] = make_float2(1.f, 0.f);
    }
    __syncthreads();

    // --- 4. FIR, noise (streams 3, 4), outputs, sums
    // window sample i of column quad c4 is x[4 c4 + off_u - fir_u + 1 + i],
    // stored at 4 c4 + i of the row (lead = fir_u - 1 - off_u): output q,
    // tap k reads i = q + fir_u - 1 - k
    if (owner) {
      float* slot = sums + hh * STATS * L + col;   // this thread's cells
      // a Doppler column's symbol and valid taps:
      // -taps <= m + off_u - k < sps, m its place in its symbol
      for (int r = hh; r < nrows; r += H) {
        const int row = row0 + r;
        float yv[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) yv[0][q] = yv[1][q] = 0.f;
        const float* xrr = xr + r * pitch;
        const float* xir = xi + r * pitch;
        if (!a.do_fir) {
          for (int q = 0; q < nq; ++q) {
            yv[0][q] = xrr[lead + col + q];
            yv[1][q] = xir[lead + col + q];
          }
        } else {
          const bool dop = (dmask >> r) & 1;
          const float2* g = gts + r * S1 * fir_u;
          int gq[4], klo[4], khi[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = col + q, sq = c / P, m = c - sq * P;
            gq[q] = dop ? min(sq, S - 1) * fir_u : 0;
            klo[q] = dop ? max(0, m + a.off_u - P + 1) : 0;
            khi[q] = !dop ? fir_u - 1
                          : c < L ? min(fir_u - 1, m + a.off_u + taps) : -1;
          }
          // taps ascending: windows from the last chunk down, i descending
          for (int jb0 = (ly.nch - 1) * FW; jb0 >= 0; jb0 -= FW) {
            float wr[FW + 4], wi[FW + 4];
            const float4* pr = reinterpret_cast<const float4*>(xrr + col + jb0);
            const float4* pi = reinterpret_cast<const float4*>(xir + col + jb0);
#pragma unroll
            for (int v = 0; v < FW / 4 + 1; ++v) {
              const float4 u = pr[v], x = pi[v];
              wr[4 * v] = u.x; wr[4 * v + 1] = u.y;
              wr[4 * v + 2] = u.z; wr[4 * v + 3] = u.w;
              wi[4 * v] = x.x; wi[4 * v + 1] = x.y;
              wi[4 * v + 2] = x.z; wi[4 * v + 3] = x.w;
            }
#pragma unroll
            for (int jj = FW - 1; jj >= 0; --jj) {
              const int k = fir_u - 1 - (jb0 + jj);
              if (k < 0) continue;
              if (!dop) {     // out[t] = sum_k x[t + off_u - k] gt[k]
                const float2 gk = g[k];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float sr = wr[q + jj], si = wi[q + jj];
                  yv[0][q] = yv[0][q] + sr * gk.x - si * gk.y;
                  yv[1][q] = yv[1][q] + sr * gk.y + si * gk.x;
                }
              } else {        // per symbol, over the column's valid taps
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  if (k < klo[q] || k > khi[q]) continue;
                  const float2 gk = g[gq[q] + k];
                  const float sr = wr[q + jj], si = wi[q + jj];
                  yv[0][q] = __fadd_rn(yv[0][q],
                                       __fsub_rn(__fmul_rn(sr, gk.x),
                                                 __fmul_rn(si, gk.y)));
                  yv[1][q] = __fadd_rn(yv[1][q],
                                       __fadd_rn(__fmul_rn(sr, gk.y),
                                                 __fmul_rn(si, gk.x)));
                }
              }
            }
          }
        }
        const uint4 w1 = philox(c4, 3u, row, 0u, k0, k1);
        const uint4 w2 = philox(c4, 4u, row, 0u, k0, k1);
        const float sd = a.std_[row];
        float nv[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 g = box_muller(u01(lane(w1, q)), u01(lane(w2, q)));
          nv[0][q] = sd * g.x;
          nv[1][q] = sd * g.y;
        }
        const size_t o = static_cast<size_t>(row) * L + col;
        float st[STATS][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float y0 = yv[0][q], y1 = yv[1][q];
          const float n0 = nv[0][q], n1 = nv[1][q];
          st[0][q] = y0;
          st[1][q] = y1;
          st[2][q] = y0 * y0;
          st[3][q] = y1 * y1;
          st[4][q] = n0;
          st[5][q] = n1;
          st[6][q] = n0 * n0;
          st[7][q] = n1 * n1;
          st[8][q] = y0 * n0;
          st[9][q] = y1 * n1;
        }
        // the row into this thread's sums, then out
        if (L % 4 == 0) {
#pragma unroll
          for (int k = 0; k < STATS; ++k) {
            float4* cell = reinterpret_cast<float4*>(slot + k * L);
            const float4 v = *cell;
            *cell = make_float4(v.x + st[k][0], v.y + st[k][1],
                                v.z + st[k][2], v.w + st[k][3]);
          }
          *reinterpret_cast<float4*>(a.yr + o) =
              make_float4(yv[0][0], yv[0][1], yv[0][2], yv[0][3]);
          *reinterpret_cast<float4*>(a.yi + o) =
              make_float4(yv[1][0], yv[1][1], yv[1][2], yv[1][3]);
          *reinterpret_cast<float4*>(a.nr + o) =
              make_float4(nv[0][0], nv[0][1], nv[0][2], nv[0][3]);
          *reinterpret_cast<float4*>(a.ni + o) =
              make_float4(nv[1][0], nv[1][1], nv[1][2], nv[1][3]);
        } else {
          for (int q = 0; q < nq; ++q) {
            for (int k = 0; k < STATS; ++k) slot[k * L + q] += st[k][q];
            a.yr[o + q] = yv[0][q];
            a.yi[o + q] = yv[1][q];
            a.nr[o + q] = nv[0][q];
            a.ni[o + q] = nv[1][q];
          }
        }
      }
    }
    __syncthreads();
  }

  // the block's sums: slot 0 + slot 1 + ..., in order
  float* out = a.stats + static_cast<size_t>(blockIdx.x) * STATS * L;
  for (int e = tid; e < STATS * L; e += T) {
    float v = sums[e];
    for (int h = 1; h < H; ++h) v += sums[h * STATS * L + e];
    out[e] = v;
  }
}

bool args_ok(const SynthArgs& a) {
  return a.n_frames > 0 && a.nbits >= 1 && a.nbits <= 4 && a.n_classes >= 1 &&
         a.taps >= 1 && a.fir_u >= 1 && a.off_u >= 0 && a.off_u < a.fir_u &&
         a.nsymbol >= 1 && a.sps >= 1 && a.frame_size >= 1 &&
         (!a.mobile || (a.cyc_len >= 1 && a.ss >= 1)) &&
         (!a.want_h || a.nfft >= 1) &&
         (a.cp == 0 || (a.cp > 0 && a.cp <= a.nfft && a.cp + a.nfft == a.sps));
}

using KernelFn = void (*)(SynthArgs, Layout);

// two blocks of 288 threads a SM; frames past 1,152 samples take one block
// of up to 1,024
KernelFn kernel_for(int threads) {
  return threads <= 288 ? fused_synth_kernel<288, 2>
                        : fused_synth_kernel<1024, 1>;
}

}  // namespace

extern "C" int fused_synth_f32(const SynthArgs* args, void* stream) {
  const SynthArgs& a = *args;
  const int R = a.rows, L4c = (a.nsymbol * a.sps + 3) / 4;
  if (!args_ok(a) || R < 1 || R > MAX_ROWS || a.threads % 32 ||
      a.threads > 1024 || a.threads < L4c || a.halves < 1 ||
      a.halves * L4c > a.threads || a.halves > R || a.grid < 1 ||
      a.grid > (a.n_frames + R - 1) / R)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout ly = layout(a, R);
  if (ly.total != static_cast<size_t>(a.smem) || a.smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = kernel_for(a.threads);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<a.grid, a.threads, a.smem, static_cast<cudaStream_t>(stream)>>>(a, ly);
  return static_cast<int>(cudaGetLastError());
}

// blocks of `threads` threads at `smem` shared bytes that one SM of the
// current device holds (out[0]), and the device's SMs (out[1])
extern "C" int fused_synth_blocks_per_sm(int threads, int smem, int* out) {
  int dev = 0;
  const KernelFn fn = kernel_for(threads);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads,
                                                        smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount,
                                 dev);
  return static_cast<int>(err);
}
