// fused_synth: the training step's data plane, bits -> OFDM TX -> Rayleigh
// FIR (static or Jakes-Doppler) -> AWGN -> per-position partial sums, one
// pass per frame row.
//
// Replaces the TPU kernel `_p1_kernel` of dl_ofdm_tpu/ops/fused_synth.py
// (lines 449-636, pallas_call at 763): static profiles, the AWGN
// passthrough, the mixRayleigh/mixAll cycles, the Doppler (mobile) rows and
// the true channel (want_h).  Per frame row it
//   1. draws the symbol indices (Philox stream 0) and writes them;
//   2. on a Doppler row (global row % C on in dop_cycle), draws the
//      2*SS*taps Jakes phases (streams 5, 6) and sums the SS sinusoids of
//      each tap at each symbol time, z_s = sqrt(1/SS) sum_n cos(2 pi s t_sym
//      fd base_n + theta_n), n ascending;
//   3. runs the per-symbol TX operator, x = sum_d sym_d * w[d, :] + bias,
//      into a zero-padded row of shared memory;
//   4. draws the row's static Rayleigh taps (streams 1, 2; Box-Muller) and
//      builds its FIR kernel gt = gbias + sum_t z_t coeff_t alpha_t from
//      the constants of its profile class (global row % P); a Doppler row
//      builds one kernel per symbol from z_s; with want_h, writes
//      h = hbias + sum_t z_t coeff_t hb_t (per symbol on a mobile spec);
//   5. convolves 'same' in the unified offset (a Doppler row: per symbol,
//      with n_taps look-back and zero future), draws the noise (streams 3,
//      4; Box-Muller) at the row's std, writes y and n;
//   6. adds the row into the block's 10 partial sums per position (y, y^2,
//      n, n^2, y*n for each IQ plane), written as stats[block, 10, L].
// The host side sums the blocks' partials and derives the normalization
// (`_combine_stats`), as XLA does on the TPU.
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
// at the float32 rate; the ~96 MB written take 29 us at 3.35 TB/s.  A
// Doppler row adds S*taps*2*SS cosines (6,048 at nfft 64) and S kernels.
// Design: a block owns R rows (16, fewer where a long frame would overflow
// shared memory; the host asks `fused_synth_rows`), keeps their padded TX
// planes in shared memory (the Jakes phases use the same space before TX
// fills it), reads the TX operator through the read-only cache, and loops
// every per-position stage over the frame in strides of its threads.  Each
// thread sums its positions' statistics over the block's rows in a fixed
// order, so the result does not depend on scheduling.
//
// Plain C interface for ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py); the
// launch goes on the caller's stream and the function returns
// cudaGetLastError().

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
  float* stats;             // [blocks, 10, L]
  float jakes_c1;           // float32(sqrt(1 / SS))
  int n_frames, nbits, nsymbol, sps, frame_size, n_classes, taps, fir_u,
      off_u, do_fir, nfft, mobile, cyc_len, ss, want_h;
  int rows;                 // R, frame rows per block (fused_synth_rows)
  int stats_blocks;         // blocks the stats buffer holds
};

namespace {

constexpr int THREADS = 320;   // 10 warps
constexpr int MAX_ROWS = 16;
constexpr int MAX_TABLE = 16;
constexpr int STATS = 10;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block on sm_90

size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// byte offsets of the shared-memory regions for R rows
struct Layout {
  size_t tab, zs, zsym, gts, jb, coef, alph, gb, sstart, dflag, idxs, total;
};

int col_halves(const SynthArgs& a) {   // H: rows split over 2 thread halves
  const int L4c = (a.nsymbol * a.sps + 3) / 4;
  return 2 * L4c <= THREADS ? 2 : 1;
}

Layout layout(const SynthArgs& a, int R) {
  const size_t S = a.nsymbol, L = S * a.sps, LP = L + 2 * (a.fir_u - 1);
  const size_t nsst = static_cast<size_t>(a.ss) * a.taps;
  const size_t S1 = a.mobile ? S : 1;
  size_t region0 = 2 * R * LP;                          // the planes
  if (a.mobile && region0 < 2 * R * nsst) region0 = 2 * R * nsst;  // phases
  if (col_halves(a) == 2 && region0 < STATS * L) region0 = STATS * L;
  Layout ly;
  size_t o = align16(region0 * sizeof(float));
  ly.tab = o;    o = align16(o + MAX_TABLE * sizeof(float2));
  ly.zs = o;     o = align16(o + static_cast<size_t>(R) * a.taps * sizeof(float2));
  ly.zsym = o;   o = align16(o + (a.mobile ? R * S * a.taps : 0) * sizeof(float2));
  ly.gts = o;    o = align16(o + R * S1 * a.fir_u * sizeof(float2));
  ly.jb = o;     o = align16(o + (a.mobile ? nsst : 0) * sizeof(float2));
  ly.coef = o;   o = align16(o + static_cast<size_t>(a.n_classes) * a.taps * sizeof(float));
  ly.alph = o;   o = align16(o + static_cast<size_t>(a.n_classes) * a.taps * a.fir_u * sizeof(float));
  ly.gb = o;     o = align16(o + static_cast<size_t>(a.n_classes) * a.fir_u * sizeof(float));
  ly.sstart = o; o = align16(o + (S + 1) * sizeof(int));
  ly.dflag = o;  o = align16(o + R * sizeof(int));
  ly.idxs = o;   o = align16(o + static_cast<size_t>(R) * a.frame_size);
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

__global__ void __launch_bounds__(THREADS)
fused_synth_kernel(SynthArgs a, Layout ly) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int R = a.rows;
  const int S = a.nsymbol, P = a.sps, D = a.frame_size;
  const int L = S * P, L4c = (L + 3) / 4;
  const int pad = a.fir_u - 1, LP = L + 2 * pad;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.n_frames - row0);
  const uint32_t k0 = static_cast<uint32_t>(a.seeds[0]);
  const uint32_t k1 = static_cast<uint32_t>(a.seeds[1]);
  const int ncls = a.n_classes, taps = a.taps, fir_u = a.fir_u;
  const int nsst = a.ss * taps, S1 = a.mobile ? S : 1;

  float* xr = reinterpret_cast<float*>(smem);    // [R][LP]
  float* xi = xr + R * LP;                       // [R][LP]
  float* theta = xr;         // [R][2][nsst] Jakes phases, before TX
  float2* tab = reinterpret_cast<float2*>(smem + ly.tab);
  float2* zs = reinterpret_cast<float2*>(smem + ly.zs);      // [R][taps]
  float2* zsym = reinterpret_cast<float2*>(smem + ly.zsym);  // [R][S][taps]
  float2* gts = reinterpret_cast<float2*>(smem + ly.gts);    // [R][S1][fir_u]
  float2* jb = reinterpret_cast<float2*>(smem + ly.jb);      // [nsst]
  float* coef = reinterpret_cast<float*>(smem + ly.coef);    // [P][taps]
  float* alph = reinterpret_cast<float*>(smem + ly.alph);    // [P][taps][fir_u]
  float* gb = reinterpret_cast<float*>(smem + ly.gb);        // [P][fir_u]
  int* sstart = reinterpret_cast<int*>(smem + ly.sstart);    // [S + 1]
  int* dflag = reinterpret_cast<int*>(smem + ly.dflag);      // [R]
  uint8_t* idxs = smem + ly.idxs;                            // [R][D]

  // --- constants ------------------------------------------------------------
  for (int e = tid; e < (1 << a.nbits); e += THREADS) tab[e] = a.sym_tab[e];
  for (int e = tid; e <= S; e += THREADS) sstart[e] = a.sym_start[e];
  for (int e = tid; e < ncls * taps; e += THREADS) coef[e] = a.coeff[e];
  for (int e = tid; e < ncls * taps * fir_u; e += THREADS)
    alph[e] = a.alpha[e];
  for (int e = tid; e < ncls * fir_u; e += THREADS) gb[e] = a.gbias[e];
  for (int r = tid; r < R; r += THREADS)
    dflag[r] = a.mobile && r < nrows && a.dop_cycle[(row0 + r) % a.cyc_len];
  if (a.mobile)
    for (int e = tid; e < nsst; e += THREADS) jb[e] = a.jakes_base[e];

  // --- 1. symbol indices (stream 0) -----------------------------------------
  const int nb_idx = (D + 3) / 4;
  const uint32_t mask = (1u << a.nbits) - 1u;
  for (int e = tid; e < nrows * nb_idx; e += THREADS) {
    const int r = e / nb_idx, j4 = e % nb_idx;
    const int row = row0 + r;
    const uint4 w = philox(j4, 0u, row, 0u, k0, k1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * j4 + q;
      if (j < D) {
        const uint32_t v = lane(w, q) & mask;
        idxs[r * D + j] = static_cast<uint8_t>(v);
        a.idx[static_cast<size_t>(row) * D + j] = static_cast<int>(v);
      }
    }
  }
  __syncthreads();

  // --- 2. Doppler rows: Jakes phases (streams 5, 6), per-symbol gains -------
  if (a.mobile) {
    const int nb = (nsst + 3) / 4;
    for (int e = tid; e < nrows * 2 * nb; e += THREADS) {
      const int r = e / (2 * nb), c = (e / nb) % 2, j4 = e % nb;
      if (!dflag[r]) continue;
      const uint4 w = philox(j4, 5u + c, row0 + r, 0u, k0, k1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * j4 + q;
        if (j < nsst)
          theta[(r * 2 + c) * nsst + j] = __fmul_rn(6.2831855f,
                                                    u01(lane(w, q)));
      }
    }
    __syncthreads();
    for (int e = tid; e < nrows * S * taps * 2; e += THREADS) {
      const int c = e % 2, t = (e / 2) % taps, s = (e / (2 * taps)) % S;
      const int r = e / (2 * taps * S);
      if (!dflag[r]) continue;
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
    __syncthreads();           // the phases are done with: TX takes over
  }

  // --- 3. TX: per-symbol operator into the padded planes --------------------
  for (int e = tid; e < nrows * 2 * pad; e += THREADS) {
    const int r = e / (2 * pad), c = e % (2 * pad);
    const int col = c < pad ? c : L + c;     // [0, pad) and [pad+L, LP)
    xr[r * LP + col] = 0.f;
    xi[r * LP + col] = 0.f;
  }
  {
    // item (s, q, t): sample t of symbol s for rows 4q .. 4q+3
    const int NQ = (nrows + 3) / 4;
    for (int e = tid; e < S * NQ * P; e += THREADS) {
      const int t = e % P, q = (e / P) % NQ, s = e / (P * NQ);
      const int d0 = sstart[s], d1 = sstart[s + 1];
      float ar[4], ai[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ar[i] = 0.f;
        ai[i] = 0.f;
      }
      for (int d = d0; d < d1; ++d) {
        const float2 w = __ldg(a.w_iq + static_cast<size_t>(d) * P + t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * q + i;
          if (r < nrows) {
            const float2 sy = tab[idxs[r * D + d]];
            ar[i] = fmaf(sy.x, w.x, ar[i]);
            ar[i] = fmaf(-sy.y, w.y, ar[i]);
            ai[i] = fmaf(sy.x, w.y, ai[i]);
            ai[i] = fmaf(sy.y, w.x, ai[i]);
          }
        }
      }
      const float2 bias = a.bias_iq[s * P + t];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * q + i;
        if (r < nrows) {
          xr[r * LP + pad + s * P + t] = ar[i] + bias.x;
          xi[r * LP + pad + s * P + t] = ai[i] + bias.y;
        }
      }
    }
  }

  // --- 4. static taps (streams 1, 2), FIR kernels, true channel ------------
  if (a.do_fir) {
    for (int e = tid; e < nrows * taps; e += THREADS) {
      const int r = e / taps, t = e % taps;
      const int row = row0 + r;
      const uint4 w1 = philox(t / 4, 1u, row, 0u, k0, k1);
      const uint4 w2 = philox(t / 4, 2u, row, 0u, k0, k1);
      const float2 g = box_muller(u01(lane(w1, t % 4)), u01(lane(w2, t % 4)));
      zs[r * taps + t] = make_float2(g.x * 0.70710677f, g.y * 0.70710677f);
    }
    __syncthreads();
    // kernel slot s of row r: the static kernel in slot 0; a Doppler row's
    // symbol s in slot s
    for (int e = tid; e < nrows * S1 * fir_u; e += THREADS) {
      const int k = e % fir_u, s = (e / fir_u) % S1, r = e / (fir_u * S1);
      const int cls = (row0 + r) % ncls;
      float gr = gb[cls * fir_u + k], gi = 0.f;
      if (dflag[r]) {
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
      for (int e = tid; e < nrows * S1 * a.nfft; e += THREADS) {
        const int k = e % a.nfft, s = (e / a.nfft) % S1;
        const int r = e / (a.nfft * S1);
        const int cls = (row0 + r) % ncls;
        const float2* z = dflag[r] ? zsym + (r * S + s) * taps : zs + r * taps;
        a.h[(static_cast<size_t>(row0 + r) * S1 + s) * a.nfft + k] =
            tap_h(a, z, coef, cls, k);
      }
    }
  } else if (a.want_h) {
    for (int e = tid; e < nrows * a.nfft; e += THREADS)
      a.h[static_cast<size_t>(row0) * a.nfft + e] = make_float2(1.f, 0.f);
  }
  __syncthreads();

  // --- 5. FIR, noise (streams 3, 4), outputs; 6. partial sums --------------
  // item (c4, h): columns 4*c4 .. 4*c4+3 of the rows h, h+H, h+2H, ...
  const int H = 2 * L4c <= THREADS ? 2 : 1;
  const bool vec = L % 4 == 0;
  float acc[STATS][4];
  int my_c4 = -1, my_h = 0;
  for (int e = tid; e < H * L4c; e += THREADS) {
    const int c4 = e % L4c, hh = e / L4c;
    const int col = 4 * c4;
    const int nq = min(4, L - col);
#pragma unroll
    for (int k = 0; k < STATS; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
    for (int r = hh; r < nrows; r += H) {
      const int row = row0 + r;
      float yv[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        yv[0][q] = 0.f;
        yv[1][q] = 0.f;
      }
      const float* xrr = xr + r * LP + pad;
      const float* xir = xi + r * LP + pad;
      if (!a.do_fir) {
        for (int q = 0; q < nq; ++q) {
          yv[0][q] = xrr[col + q];
          yv[1][q] = xir[col + q];
        }
      } else if (dflag[r]) {
        // per symbol: out[m] = sum_k x[m + off_u - k] gt_s[k] over the
        // window -taps <= m + off_u - k < sps of the column's symbol
        for (int q = 0; q < nq; ++q) {
          const int s = (col + q) / P, m = (col + q) % P;
          const float2* g = gts + (r * S1 + s) * fir_u;
          float y0 = 0.f, y1 = 0.f;
          for (int k = 0; k < fir_u; ++k) {
            const int rel = m + a.off_u - k;
            if (rel < -taps || rel >= P) continue;
            const float sr = xrr[col + q + a.off_u - k];
            const float si = xir[col + q + a.off_u - k];
            y0 = __fadd_rn(y0, __fsub_rn(__fmul_rn(sr, g[k].x),
                                         __fmul_rn(si, g[k].y)));
            y1 = __fadd_rn(y1, __fadd_rn(__fmul_rn(sr, g[k].y),
                                         __fmul_rn(si, g[k].x)));
          }
          yv[0][q] = y0;
          yv[1][q] = y1;
        }
      } else {
        // out[t] = sum_k x[t + off_u - k] * gt[k]
        const float2* g = gts + r * S1 * fir_u;
        for (int k = 0; k < fir_u; ++k) {
          const float2 gk = g[k];
          const int base = col + a.off_u - k;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < nq) {
              const float sr = xrr[base + q], si = xir[base + q];
              yv[0][q] = yv[0][q] + sr * gk.x - si * gk.y;
              yv[1][q] = yv[1][q] + sr * gk.y + si * gk.x;
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
      if (vec) {
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
          a.yr[o + q] = yv[0][q];
          a.yi[o + q] = yv[1][q];
          a.nr[o + q] = nv[0][q];
          a.ni[o + q] = nv[1][q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float y0 = yv[0][q], y1 = yv[1][q];
        const float n0 = nv[0][q], n1 = nv[1][q];
        acc[0][q] += y0;
        acc[1][q] += y1;
        acc[2][q] += y0 * y0;
        acc[3][q] += y1 * y1;
        acc[4][q] += n0;
        acc[5][q] += n1;
        acc[6][q] += n0 * n0;
        acc[7][q] += n1 * n1;
        acc[8][q] += y0 * n0;
        acc[9][q] += y1 * n1;
      }
    }
    if (H == 1) {              // this thread's columns are whole: write
      float* out = a.stats + static_cast<size_t>(blockIdx.x) * STATS * L;
      for (int k = 0; k < STATS; ++k)
        for (int q = 0; q < nq; ++q) out[k * L + col + q] = acc[k][q];
    } else {                   // H == 2: one item a thread, joined below
      my_c4 = c4;
      my_h = hh;
    }
  }
  if (H == 2) {
    __syncthreads();           // the planes are free: reuse them below
    float* part = reinterpret_cast<float*>(smem);   // [10][L], odd rows
    if (my_c4 >= 0 && my_h == 1)
      for (int k = 0; k < STATS; ++k)
        for (int q = 0; q < min(4, L - 4 * my_c4); ++q)
          part[k * L + 4 * my_c4 + q] = acc[k][q];
    __syncthreads();
    if (my_c4 >= 0 && my_h == 0) {
      float* out = a.stats + static_cast<size_t>(blockIdx.x) * STATS * L;
      for (int k = 0; k < STATS; ++k)
        for (int q = 0; q < min(4, L - 4 * my_c4); ++q) {
          const int c = 4 * my_c4 + q;
          out[k * L + c] = acc[k][q] + part[k * L + c];
        }
    }
  }
}

bool args_ok(const SynthArgs& a) {
  return a.n_frames > 0 && a.nbits >= 1 && a.nbits <= 4 && a.n_classes >= 1 &&
         a.taps >= 1 && a.fir_u >= 1 && a.nsymbol >= 1 && a.sps >= 1 &&
         a.frame_size >= 1 && (!a.mobile || (a.cyc_len >= 1 && a.ss >= 1)) &&
         (!a.want_h || a.nfft >= 1);
}

}  // namespace

// rows a block takes for these arguments: the most, up to 16, whose shared
// memory fits in a block; 0 if not even one row fits
extern "C" int fused_synth_rows(const SynthArgs* args) {
  if (!args_ok(*args)) return 0;
  for (int r = MAX_ROWS; r >= 1; r /= 2)
    if (layout(*args, r).total <= SMEM_LIMIT) return r;
  return 0;
}

extern "C" int fused_synth_f32(const SynthArgs* args, void* stream) {
  const SynthArgs& a = *args;
  const int R = a.rows;
  if (!args_ok(a) || R < 1 || R > MAX_ROWS ||
      a.stats_blocks != (a.n_frames + R - 1) / R)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout ly = layout(a, R);
  if (ly.total > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ly.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_synth_kernel<<<a.stats_blocks, THREADS, ly.total,
                       static_cast<cudaStream_t>(stream)>>>(a, ly);
  return static_cast<int>(cudaGetLastError());
}
