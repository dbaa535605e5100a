// fused_synth: the training step's data plane, bits -> OFDM TX -> Rayleigh
// FIR -> AWGN -> per-position partial sums, one pass per frame row.
//
// Replaces the TPU kernel `_p1_kernel` of dl_ofdm_tpu/ops/fused_synth.py
// (lines 449-636, pallas_call at 763) for static profiles, the AWGN
// passthrough and the mixRayleigh/mixAll cycles.  Per frame row it
//   1. draws the symbol indices (Philox stream 0) and writes them;
//   2. runs the per-symbol TX operator, x = sum_d sym_d * w[d, :] + bias,
//      into a zero-padded row of shared memory;
//   3. draws the row's Rayleigh taps (streams 1, 2; Box-Muller) and builds
//      its FIR kernel gt = gbias + sum_t z_t coeff_t alpha_t from the
//      constants of its profile class (global row % P);
//   4. convolves 'same' in the unified offset, draws the noise (streams 3,
//      4; Box-Muller) at the row's std, writes y and n;
//   5. adds the row into the block's 10 partial sums per position (y, y^2,
//      n, n^2, y*n for each IQ plane), written as stats[block, 10, L].
// The host side sums the blocks' partials and derives the normalization
// (`_combine_stats`), as XLA does on the TPU.
//
// Random words: Philox4x32-10 written out here, key (seed0, seed1), counter
// (j / 4, stream, row, 0), word j = lane j % 4.  The plain version
// (dl_ofdm_tpu_torch/ops/fused_synth.py) makes the same words in torch, so
// the two agree draw for draw.  No --use_fast_math: logf and sincosf stay
// within a few ulp of torch's.
//
// Bound on an H100 at 9,362 frames: ~0.27 MFLOP per frame (the TX operator,
// 320 x 80 complex MACs, is 0.2 of it), ~2.5 GFLOP in all, 38 us at the
// float32 rate; the ~96 MB written take 29 us at 3.35 TB/s.  Design: a
// block owns 16 rows (no padding: rows past B are masked), keeps their
// padded TX planes (16 x 584 x 2 floats) in shared memory, reads the TX
// operator (205 KB, too big for shared memory beside the planes) through
// the read-only cache, and sums its rows' statistics in registers in a
// fixed order, so the result does not depend on scheduling.
//
// Plain C interface for ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py); the
// launch goes on the caller's stream and the function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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
  int* idx;                 // [B, D]
  float *yr, *yi, *nr, *ni; // [B, L]
  float* stats;             // [blocks, 10, L]
  int n_frames, nbits, nsymbol, sps, frame_size, n_classes, taps, fir_u,
      off_u, do_fir;
  int stats_blocks;         // blocks the stats buffer holds
};

namespace {

constexpr int R = 16;          // frame rows per block
constexpr int THREADS = 320;   // 10 warps
constexpr int MAX_CLASSES = 8;
constexpr int MAX_TAPS = 16;
constexpr int MAX_FIR = 32;
constexpr int MAX_SYMBOLS = 16;
constexpr int MAX_TABLE = 16;
constexpr int STATS = 10;

__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// uniform (0, 1) from the top 24 bits, never 0 (fused_synth.py::_u01)
__device__ __forceinline__ float u01(uint32_t w) {
  return __fadd_rn(__fmul_rn(static_cast<float>(w >> 8), 0x1p-24f), 0x1p-25f);
}

__device__ __forceinline__ float2 box_muller(float u1, float u2) {
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.2831855f * u2, &s, &c);   // float32(2 pi) * u2
  return make_float2(r * c, r * s);
}

__global__ void __launch_bounds__(THREADS)
fused_synth_kernel(SynthArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int S = a.nsymbol, P = a.sps, D = a.frame_size;
  const int L = S * P, L4 = L / 4;
  const int pad = a.fir_u - 1, LP = L + 2 * pad;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.n_frames - row0);
  const uint32_t k0 = static_cast<uint32_t>(a.seeds[0]);
  const uint32_t k1 = static_cast<uint32_t>(a.seeds[1]);
  const int ncls = a.n_classes, taps = a.taps, fir_u = a.fir_u;

  // shared memory: padded TX planes, then small tables
  float* xr = smem;                          // [R][LP]
  float* xi = xr + R * LP;                   // [R][LP]
  float2* tab = reinterpret_cast<float2*>(xi + R * LP);   // [16]
  float2* zs = tab + MAX_TABLE;              // [R][MAX_TAPS] taps
  float2* gts = zs + R * MAX_TAPS;           // [R][MAX_FIR] FIR kernels
  float* coef = reinterpret_cast<float*>(gts + R * MAX_FIR);  // [P][taps]
  float* alph = coef + MAX_CLASSES * MAX_TAPS;    // [P][taps][fir_u]
  float* gb = alph + MAX_CLASSES * MAX_TAPS * MAX_FIR;  // [P][fir_u]
  int* sstart = reinterpret_cast<int*>(gb + MAX_CLASSES * MAX_FIR);
  uint8_t* idxs = reinterpret_cast<uint8_t*>(sstart + MAX_SYMBOLS + 1);  // [R][D]

  // --- constants, zero pads ------------------------------------------------
  for (int e = tid; e < (1 << a.nbits); e += THREADS) tab[e] = a.sym_tab[e];
  for (int e = tid; e <= S; e += THREADS) sstart[e] = a.sym_start[e];
  for (int e = tid; e < ncls * taps; e += THREADS) coef[e] = a.coeff[e];
  for (int e = tid; e < ncls * taps * fir_u; e += THREADS)
    alph[e] = a.alpha[e];
  for (int e = tid; e < ncls * fir_u; e += THREADS) gb[e] = a.gbias[e];
  for (int e = tid; e < R * 2 * pad; e += THREADS) {
    const int r = e / (2 * pad), c = e % (2 * pad);
    const int col = c < pad ? c : L + c;     // [0, pad) and [pad+L, LP)
    xr[r * LP + col] = 0.f;
    xi[r * LP + col] = 0.f;
  }

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

  // --- 2. TX: per-symbol operator into the padded planes --------------------
  // thread (t, g): sample t of every symbol for rows g, g+4, g+8, g+12
  {
    const int ngrp = THREADS / P;       // sps <= THREADS
    const int t = tid % P, g = tid / P;
    if (g < ngrp) {
      for (int s = 0; s < S; ++s) {
        const int d0 = sstart[s], d1 = sstart[s + 1];
        for (int rb = g; rb < nrows; rb += 4 * ngrp) {
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
              const int r = rb + i * ngrp;
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
            const int r = rb + i * ngrp;
            if (r < nrows) {
              xr[r * LP + pad + s * P + t] = ar[i] + bias.x;
              xi[r * LP + pad + s * P + t] = ai[i] + bias.y;
            }
          }
        }
      }
    }
  }

  // --- 3. taps (streams 1, 2) and each row's FIR kernel --------------------
  if (a.do_fir) {
    for (int e = tid; e < nrows * taps; e += THREADS) {
      const int r = e / taps, t = e % taps;
      const int row = row0 + r;
      const uint4 w1 = philox(t / 4, 1u, row, 0u, k0, k1);
      const uint4 w2 = philox(t / 4, 2u, row, 0u, k0, k1);
      const float2 g = box_muller(u01(lane(w1, t % 4)), u01(lane(w2, t % 4)));
      zs[r * MAX_TAPS + t] = make_float2(g.x * 0.70710677f, g.y * 0.70710677f);
    }
    __syncthreads();
    for (int e = tid; e < nrows * fir_u; e += THREADS) {
      const int r = e / fir_u, k = e % fir_u;
      const int cls = (row0 + r) % ncls;
      float gr = gb[cls * fir_u + k], gi = 0.f;
      for (int t = 0; t < taps; ++t) {
        const float2 z = zs[r * MAX_TAPS + t];
        const float c = coef[cls * taps + t];
        const float al = alph[(cls * taps + t) * fir_u + k];
        gr += (z.x * c) * al;
        gi += (z.y * c) * al;
      }
      gts[r * MAX_FIR + k] = make_float2(gr, gi);
    }
  }
  __syncthreads();

  // --- 4. FIR, noise (streams 3, 4), outputs; 5. partial sums --------------
  // thread (c4, h): columns 4*c4 .. 4*c4+3 of the rows r = h, h+2, ...
  float acc[STATS][4];
#pragma unroll
  for (int k = 0; k < STATS; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
  const int c4 = tid % L4, h = tid / L4;
  const bool active = tid < 2 * L4;
  if (active) {
    const int col = 4 * c4;
    for (int r = h; r < nrows; r += 2) {
      const int row = row0 + r;
      float yv[2][4];
      if (a.do_fir) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          yv[0][q] = 0.f;
          yv[1][q] = 0.f;
        }
        // out[t] = sum_k x[t + off_u - k] * gt[k]
        for (int k = 0; k < fir_u; ++k) {
          const float2 g = gts[r * MAX_FIR + k];
          const int base = r * LP + pad + col + a.off_u - k;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float sr = xr[base + q], si = xi[base + q];
            yv[0][q] = yv[0][q] + sr * g.x - si * g.y;
            yv[1][q] = yv[1][q] + sr * g.y + si * g.x;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          yv[0][q] = xr[r * LP + pad + col + q];
          yv[1][q] = xi[r * LP + pad + col + q];
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
      *reinterpret_cast<float4*>(a.yr + o) =
          make_float4(yv[0][0], yv[0][1], yv[0][2], yv[0][3]);
      *reinterpret_cast<float4*>(a.yi + o) =
          make_float4(yv[1][0], yv[1][1], yv[1][2], yv[1][3]);
      *reinterpret_cast<float4*>(a.nr + o) =
          make_float4(nv[0][0], nv[0][1], nv[0][2], nv[0][3]);
      *reinterpret_cast<float4*>(a.ni + o) =
          make_float4(nv[1][0], nv[1][1], nv[1][2], nv[1][3]);
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
  }
  __syncthreads();               // the planes are free: reuse them below
  float* part = smem;            // [10][L] sums of the odd rows
  if (active && h == 1)
#pragma unroll
    for (int k = 0; k < STATS; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[k * L + 4 * c4 + q] = acc[k][q];
  __syncthreads();
  if (active && h == 0) {
    float* out = a.stats + static_cast<size_t>(blockIdx.x) * STATS * L;
#pragma unroll
    for (int k = 0; k < STATS; ++k)
      *reinterpret_cast<float4*>(out + k * L + 4 * c4) = make_float4(
          acc[k][0] + part[k * L + 4 * c4], acc[k][1] + part[k * L + 4 * c4 + 1],
          acc[k][2] + part[k * L + 4 * c4 + 2],
          acc[k][3] + part[k * L + 4 * c4 + 3]);
  }
}

size_t smem_bytes(const SynthArgs& a) {
  const int L = a.nsymbol * a.sps, LP = L + 2 * (a.fir_u - 1);
  // the planes' region also holds [10][L] partial sums at the end (R > 5)
  return static_cast<size_t>(2) * R * LP * sizeof(float) + MAX_TABLE * sizeof(float2) +
         R * (MAX_TAPS + MAX_FIR) * sizeof(float2) +
         (MAX_CLASSES * MAX_TAPS + MAX_CLASSES * MAX_TAPS * MAX_FIR +
          MAX_CLASSES * MAX_FIR) * sizeof(float) +
         (MAX_SYMBOLS + 1) * sizeof(int) +
         static_cast<size_t>(R) * a.frame_size;
}

}  // namespace

extern "C" int fused_synth_f32(const SynthArgs* args, void* stream) {
  const SynthArgs& a = *args;
  const int L = a.nsymbol * a.sps;
  if (a.n_frames <= 0 || a.n_classes > MAX_CLASSES || a.taps > MAX_TAPS ||
      a.fir_u > MAX_FIR || a.nsymbol > MAX_SYMBOLS || a.nbits < 1 ||
      a.nbits > 4 || a.sps > THREADS || L % 4 || L / 4 > THREADS / 2 ||
      a.sps % 4 || a.stats_blocks != (a.n_frames + R - 1) / R)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(
      fused_synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.n_frames + R - 1) / R;
  fused_synth_kernel<<<blocks, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
