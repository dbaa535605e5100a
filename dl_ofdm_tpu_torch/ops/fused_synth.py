"""The training step's data plane in one kernel: bits -> OFDM TX -> Rayleigh
FIR -> AWGN -> per-position partial sums for the normalization.

Port of `dl_ofdm_tpu/ops/fused_synth.py` (the TPU kernel `_p1_kernel`,
`pallas_call` at `fused_synth.py:763`).  For each frame the kernel draws the
symbol indices, runs the per-symbol TX operator (placement, IDFT and CP in
one constant matrix, `ofdm.tx._symbol_tx_operator`), draws Box-Muller
Rayleigh taps, builds the frame's FIR kernel from its profile class
(pre-shifted alpha matrices, so mixed profiles share one 'same' offset),
convolves, draws the AWGN at the frame's std, and writes the signal and
noise planes, the indices and 10 per-position partial sums.  Doppler
frames (`spec.mobile`, the rows whose global index falls on an 'on' entry
of `spec.dop_cycle`) take Jakes sum-of-sinusoids gains per OFDM symbol and
a per-symbol FIR with n_taps look-back; `want_h` adds the true channel DFT.
XLA's part, `_combine_stats` and the affine epilogue, is plain tensor code
here.

  * `fused_synthesize_kernel` launches the CUDA kernel
    (`csrc/fused_synth.cu`) and counts its launches;
  * `fused_synthesize_ref` is the plain version: the same math in torch,
    on random words it makes with the same Philox4x32-10 counter layout as
    the kernel (`philox_words`), or on words the caller injects (`words=`,
    the pattern of JAX's `emulate_fused_synthesize`, `:823-947`);
  * `fused_synthesize` draws the two seed words from a `torch.Generator`
    and runs the kernel on a CUDA device, the plain version on the CPU.

Random words.  The TPU's hardware PRNG does not exist here.  Word j of
stream `st` for frame row `row` is lane j % 4 of Philox4x32-10 with key
(seed0, seed1) and counter (j // 4, st, row, 0).  Streams: 0 symbol indices
(frame_size words), 1 and 2 the taps' two uniforms (taps words each), 3 and
4 the noise's two uniforms (S*sps words each), 5 and 6 the Jakes phases
(SS*taps words each, word n*taps + t for sinusoid n and tap t; drawn only
by Doppler rows).  A row's draws depend only on its global index, so the
result does not depend on how rows are cut into blocks.  Uniforms are
`_u01` of a word, as in JAX.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dl_ofdm_tpu_torch.channel.doppler import SS, jakes_bases
from dl_ofdm_tpu_torch.ofdm.constellation import _table_np
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan
from dl_ofdm_tpu_torch.ofdm.tx import _symbol_tx_operator
from dl_ofdm_tpu_torch.ops import cuda_build

_SQRT_HALF = float(np.sqrt(0.5))

# the plans the kernel takes: at most 16-QAM, the [frame_size, sps] TX
# operator pair within 2 MiB
MAX_NBITS = 4
TX_OP_MAX_BYTES = 2 * 2**20

# Philox streams (see the module docstring)
(STREAM_IDX, STREAM_TAP1, STREAM_TAP2, STREAM_NOISE1, STREAM_NOISE2,
 STREAM_JAKES1, STREAM_JAKES2) = range(7)


@dataclasses.dataclass(frozen=True, eq=False)
class SynthSpec:
    """Constants of the fused synthesize chain (numpy, built once)."""
    nbits: int
    nsymbol: int
    sps: int                 # samples per symbol (nfft + cp)
    nfft: int
    frame_size: int
    counts: tuple            # data subcarriers per OFDM symbol
    w_r: np.ndarray          # [frame_size, sps] per-data-SC IDFT rows
    w_i: np.ndarray
    bias_r: np.ndarray       # [nsymbol, sps] the pilots' waveform
    bias_i: np.ndarray
    sym_table: np.ndarray    # [2^nbits, 2] float32 symbol of each index
    do_fir: bool
    n_classes: int           # P: frame i takes profile class i % P
    taps: int                # max tap count (zero-padded)
    fir_u: int               # unified (pre-shifted) kernel length
    off_u: int               # unified 'same' alignment offset
    coeff_cls: np.ndarray    # [P, taps] tap weights (0 for passthrough)
    alpha_cls: np.ndarray    # [P, taps, fir_u] pre-shifted alpha matrices
    gbias_cls: np.ndarray    # [P, fir_u] delta kernel of passthrough rows
    hb_r: np.ndarray         # [P, taps, nfft] alpha @ DFT (true channel)
    hb_i: np.ndarray
    hbias_cls: np.ndarray    # [P, nfft] H of the passthrough delta
    # Doppler (None / 0 when mobile is False)
    mobile: bool = False
    dop_cycle: np.ndarray = None   # [C] bool: frame i takes the Jakes path
                                   # iff dop_cycle[i % C]
    fd_cls: np.ndarray = None      # [P] Doppler shift per profile class (Hz)
    t_sym: float = 0.0             # OFDM symbol duration (s)
    jakes_base_r: np.ndarray = None  # [SS, taps] cos(n_vec + alpha_k)
    jakes_base_i: np.ndarray = None  # [SS, taps] cos(n_vec - alpha_k)

    @property
    def length(self) -> int:
        return self.nsymbol * self.sps


def _sym_table(nbits: int) -> np.ndarray:
    """Symbol of each index, as JAX's `_symbols_from_idx` evaluates it in
    float32: BPSK is t0 + idx*(t1 - t0), higher orders a table lookup."""
    table = _table_np(nbits)
    out = np.stack([table.real, table.imag], -1).astype(np.float32)
    if nbits == 1:
        for k in range(2):      # real, imag
            t0, t1 = (float(v) for v in out[:, k])
            idx = np.arange(2, dtype=np.float32)
            out[:, k] = np.float32(t0) + idx * np.float32(t1 - t0)
    return out


class ProfileClasses(NamedTuple):
    """The FIR constants of a channel's profile classes, every class's
    kernel pre-shifted to one 'same' offset (`fused_synth.py:162`)."""
    taps: int                # max tap count (zero-padded)
    fir_u: int               # unified (pre-shifted) kernel length
    off_u: int               # unified 'same' alignment offset
    coeff: np.ndarray        # [P, taps] tap weights (0 for passthrough)
    alpha: np.ndarray        # [P, taps, fir_u] pre-shifted alpha matrices
    gbias: np.ndarray        # [P, fir_u] delta kernel of passthrough rows


def profile_classes(profiles) -> ProfileClasses:
    """`profiles`: a sequence of `channel.profiles.TapProfile`, frame i
    taking entry i % P, None entries AWGN passthrough frames."""
    p_n = len(profiles)
    live = [p for p in profiles if p is not None]
    taps = max([p.n_taps for p in live], default=1)
    off_u = max([p.same_offset for p in live], default=0)
    fir_u = max([p.n_fir + off_u - p.same_offset for p in live], default=1)
    coeff = np.zeros((p_n, taps), np.float32)
    alpha = np.zeros((p_n, taps, fir_u), np.float32)
    gbias = np.zeros((p_n, fir_u), np.float32)
    for c_idx, prof in enumerate(profiles):
        if prof is None:
            gbias[c_idx, off_u] = 1.0     # delta at the unified offset
            continue
        shift = off_u - prof.same_offset
        coeff[c_idx, :prof.n_taps] = prof.ch_coeff
        alpha[c_idx, :prof.n_taps, shift:shift + prof.n_fir] = \
            prof.alpha_matrix
    return ProfileClasses(taps, fir_u, off_u, coeff, alpha, gbias)


def build_synth_spec(plan: SubcarrierPlan, profiles=None, nbits: int = 1,
                     fd=None, dop_cycle=None) -> SynthSpec:
    """`profiles`: one `channel.profiles.TapProfile`, a sequence of them
    cycled per frame (None entries are AWGN passthrough frames), or None for
    a pure AWGN passthrough channel (`fused_synth.py:162`).

    Doppler: `fd` [P] is the Doppler shift of each profile class (Hz) and
    `dop_cycle` the static cycle of frames that take the Jakes path
    (`RayleighChannel.frame_layout`)."""
    counts, w_sym_r, w_sym_i, bias = _symbol_tx_operator(plan)
    w_r = np.concatenate([w_sym_r[s, :c] for s, c in enumerate(counts)])
    w_i = np.concatenate([w_sym_i[s, :c] for s, c in enumerate(counts)])
    if profiles is None or not isinstance(profiles, (list, tuple)):
        profiles = [profiles]
    p_n = len(profiles)
    live = [p for p in profiles if p is not None]
    taps, fir_u, off_u, coeff, alpha, gbias = profile_classes(profiles)
    nfft = plan.nfft
    hb_r = np.zeros((p_n, taps, nfft), np.float32)
    hb_i = np.zeros((p_n, taps, nfft), np.float32)
    hbias = np.zeros((p_n, nfft), np.float32)
    for c_idx, prof in enumerate(profiles):
        if prof is None:
            hbias[c_idx] = 1.0            # fft(delta) = 1
            continue
        # H basis: DFT of the unshifted kernel (the pre-shift is an
        # alignment device and must not reach H)
        dft = np.exp(-2j * np.pi * np.outer(np.arange(prof.n_fir),
                                            np.arange(nfft)) / nfft)
        hb = prof.alpha_matrix.astype(np.complex64) @ dft
        hb_r[c_idx, :prof.n_taps] = hb.real
        hb_i[c_idx, :prof.n_taps] = hb.imag
    mobile = fd is not None and bool(np.any(np.asarray(fd) > 0.1)) \
        and dop_cycle is not None and bool(np.any(dop_cycle))
    dop = {}
    if mobile:
        jb_r, jb_i = jakes_bases(taps)
        dop = dict(mobile=True,
                   dop_cycle=np.asarray(dop_cycle, bool).reshape(-1),
                   fd_cls=np.asarray(fd, np.float32).reshape(p_n),
                   jakes_base_r=jb_r, jakes_base_i=jb_i)
    return SynthSpec(
        nbits=nbits, nsymbol=plan.nsymbol, sps=plan.samples_per_symbol,
        nfft=nfft, frame_size=plan.frame_size,
        counts=tuple(int(c) for c in counts),
        w_r=w_r.astype(np.float32), w_i=w_i.astype(np.float32),
        bias_r=bias[..., 0].astype(np.float32),
        bias_i=bias[..., 1].astype(np.float32),
        sym_table=_sym_table(nbits), do_fir=bool(live), n_classes=p_n,
        taps=taps, fir_u=fir_u, off_u=off_u, coeff_cls=coeff,
        alpha_cls=alpha, gbias_cls=gbias, hb_r=hb_r, hb_i=hb_i,
        hbias_cls=hbias, t_sym=plan.samples_per_symbol / plan.sample_rate,
        **dop)


def synth_spec_for(plan: SubcarrierPlan, channel, nbits: int):
    """The spec of `channel`'s frames (a `channel.rayleigh.RayleighChannel`,
    its `frame_layout`), or None where the kernel does not take the plan
    (`loop.py:113-143`): more than MAX_NBITS bits a symbol, a TX operator
    over TX_OP_MAX_BYTES, or an OFDM symbol without data subcarriers
    (block pilots)."""
    tx_op_bytes = 2 * 4 * plan.frame_size * plan.samples_per_symbol
    counts = np.bincount(plan.data_sc // plan.nfft, minlength=plan.nsymbol)
    if nbits > MAX_NBITS or tx_op_bytes > TX_OP_MAX_BYTES or counts.min() == 0:
        return None
    profiles, fd, dop_cycle = channel.frame_layout()
    return build_synth_spec(plan, profiles, nbits, fd=fd, dop_cycle=dop_cycle)


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 tensor arithmetic (values kept in [0, 2^32))
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a*b for a constant a and b < 2^32, without
    overflowing int64: b is split into 16-bit halves."""
    p1 = a * (b & 0xFFFF)
    p2 = a * (b >> 16)
    t = p1 + ((p2 & 0xFFFF) << 16)
    return (t >> 32) + (p2 >> 16), t & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11): four counter words and two key
    words (int64 tensors or ints in [0, 2^32), broadcast together) -> the
    four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(seeds: torch.Tensor, rows: torch.Tensor, stream: int,
                 n_words: int) -> torch.Tensor:
    """[len(rows), n_words] int64 words of `stream` for the given global
    frame rows, under the key `seeds` (int64 [2])."""
    nb = -(-n_words // 4)
    dev = rows.device
    ctr0 = torch.arange(nb, dtype=torch.int64, device=dev)[None, :]
    ctr2 = rows.to(torch.int64)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    k0 = seeds[0].to(dev)
    k1 = seeds[1].to(dev)
    outs = philox4x32(ctr0 + zero * ctr2, zero + stream, ctr2 + zero * ctr0,
                      zero, k0, k1)
    return torch.stack(outs, -1).reshape(len(rows), nb * 4)[:, :n_words]


def _u01(words: torch.Tensor) -> torch.Tensor:
    """Random words -> uniform (0, 1) float32 from their top 24 bits, never
    0 (`fused_synth.py::_u01`)."""
    return (words >> 8).to(torch.float32) * (2.0 ** -24) + 2.0 ** -25


def _box_muller(u1: torch.Tensor, u2: torch.Tensor):
    """Two independent N(0, 1) planes from two uniform planes."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = (2.0 * math.pi) * u2
    return r * torch.cos(ang), r * torch.sin(ang)


def noise_std(snr_db: torch.Tensor) -> torch.Tensor:
    """Per-frame AWGN std per component, float32 [B]."""
    return _SQRT_HALF * torch.pow(
        10.0, -snr_db.reshape(-1).to(torch.float32) / 20.0)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def draw_words(spec: SynthSpec, n_frames: int, seeds: torch.Tensor,
               device=None) -> dict:
    """Every word the kernel draws for `n_frames` rows, by stream name (the
    Jakes phases for every row; the kernel draws them for Doppler rows
    only, and a row's words do not depend on which others are drawn)."""
    rows = torch.arange(n_frames, device=device)
    l = spec.length
    words = {"idx": philox_words(seeds, rows, STREAM_IDX, spec.frame_size),
             "noise_u1": philox_words(seeds, rows, STREAM_NOISE1, l),
             "noise_u2": philox_words(seeds, rows, STREAM_NOISE2, l)}
    if spec.do_fir:
        words["tap_u1"] = philox_words(seeds, rows, STREAM_TAP1, spec.taps)
        words["tap_u2"] = philox_words(seeds, rows, STREAM_TAP2, spec.taps)
    if spec.mobile:
        n = SS * spec.taps
        words["jakes_u1"] = philox_words(seeds, rows, STREAM_JAKES1, n)
        words["jakes_u2"] = philox_words(seeds, rows, STREAM_JAKES2, n)
    return words


def doppler_rows(spec: SynthSpec, n_frames: int) -> np.ndarray:
    """[B] bool: which rows take the Jakes path (`dop_cycle` by global
    row index)."""
    if not spec.mobile:
        return np.zeros(n_frames, bool)
    cyc = spec.dop_cycle
    return cyc[np.arange(n_frames) % len(cyc)]


def _sym_window_masks(spec: SynthSpec) -> np.ndarray:
    """[fir_u, sps] 0/1: the per-symbol window in unified-offset
    coordinates (`fused_synth.py:360`).  Output m of a symbol reads
    x[m + off_u - k] of that symbol, valid iff -taps <= m + off_u - k < sps
    (n_taps look-back, zero future)."""
    m = np.arange(spec.sps)
    masks = np.zeros((spec.fir_u, spec.sps), np.float32)
    for k in range(spec.fir_u):
        r = m + spec.off_u - k
        masks[k] = ((r >= -spec.taps) & (r < spec.sps)).astype(np.float32)
    return masks


def _jakes_sym_gains(th_re, th_im, fvec_re, fvec_im, t_s: float, taps: int):
    """Jakes gains of one symbol time from flat [B, SS*taps] phase and
    frequency planes (`fused_synth.py:375`): z(t_s) = sqrt(1/SS) *
    sum_n cos(2 pi t_s f + theta), the sum over n in ascending order.
    Returns (zr, zi) [B, taps]."""
    c = 2 * np.pi * t_s
    ar = torch.cos(c * fvec_re + th_re)
    ai = torch.cos(c * fvec_im + th_im)
    zr, zi = ar[:, :taps], ai[:, :taps]
    for n in range(1, SS):
        zr = zr + ar[:, n * taps:(n + 1) * taps]
        zi = zi + ai[:, n * taps:(n + 1) * taps]
    c1 = float(np.sqrt(1.0 / SS))
    return c1 * zr, c1 * zi


def _tap_gt(zr, zi, coeff, alpha, gbias, taps: int):
    """Per-row FIR kernel gt = gbias + sum_t z_t coeff_t alpha_t
    (`fused_synth.py::_tap_gt`)."""
    gt_r, gt_i = gbias, torch.zeros_like(gbias)
    for t in range(taps):
        gt_r = gt_r + (zr[:, t:t + 1] * coeff[:, t:t + 1]) * alpha[:, t]
        gt_i = gt_i + (zi[:, t:t + 1] * coeff[:, t:t + 1]) * alpha[:, t]
    return gt_r, gt_i


def _tap_h(zr, zi, coeff, hb_r, hb_i, hbias, taps: int):
    """True channel DFT h = hbias + sum_t (z_t coeff_t) hb_t, complex
    products (`fused_synth.py::_tap_h`).  Returns [B, nfft, 2]."""
    h_r, h_i = hbias, torch.zeros_like(hbias)
    for t in range(taps):
        cr = zr[:, t:t + 1] * coeff[:, t:t + 1]
        ci = zi[:, t:t + 1] * coeff[:, t:t + 1]
        br, bi = hb_r[:, t], hb_i[:, t]
        h_r = h_r + cr * br - ci * bi
        h_i = h_i + cr * bi + ci * br
    return torch.stack([h_r, h_i], -1)


def _fir_same_unified(x_r, x_i, gt_r, gt_i, spec: SynthSpec):
    """'same' convolution in the unified offset: out[t] = sum_k
    x[t + off_u - k] * gt[k]."""
    p, l = spec.fir_u - 1, spec.length
    xp_r = torch.nn.functional.pad(x_r, (p, p))
    xp_i = torch.nn.functional.pad(x_i, (p, p))
    y_r = torch.zeros_like(x_r)
    y_i = torch.zeros_like(x_i)
    for k in range(spec.fir_u):
        o = spec.off_u - k + p
        sr, si = xp_r[:, o:o + l], xp_i[:, o:o + l]
        hr, hi = gt_r[:, k:k + 1], gt_i[:, k:k + 1]
        y_r = y_r + sr * hr - si * hi
        y_i = y_i + sr * hi + si * hr
    return y_r, y_i


def _fir_sym_unified(x_r, x_i, gts_r, gts_i, spec: SynthSpec):
    """Per-symbol windowed FIR in the unified offset (`fused_synth.py:394`):
    x planes [B, L], per-symbol kernels gts [B, S, fir_u] -> [B, L]."""
    p, sps = spec.fir_u - 1, spec.sps
    masks = torch.from_numpy(_sym_window_masks(spec)).to(x_r.device)
    xp_r = torch.nn.functional.pad(x_r, (p, p))
    xp_i = torch.nn.functional.pad(x_i, (p, p))
    segs_r, segs_i = [], []
    for s in range(spec.nsymbol):
        y_r = torch.zeros(x_r.shape[0], sps, device=x_r.device)
        y_i = torch.zeros_like(y_r)
        for k in range(spec.fir_u):
            pos = p + s * sps + spec.off_u - k
            sr, si = xp_r[:, pos:pos + sps], xp_i[:, pos:pos + sps]
            hr, hi = gts_r[:, s, k:k + 1], gts_i[:, s, k:k + 1]
            mk = masks[k:k + 1]
            y_r = y_r + (sr * hr - si * hi) * mk
            y_i = y_i + (sr * hi + si * hr) * mk
        segs_r.append(y_r)
        segs_i.append(y_i)
    return torch.cat(segs_r, 1), torch.cat(segs_i, 1)


def fused_synthesize_ref(spec: SynthSpec, n_frames: int, std: torch.Tensor,
                         seeds: torch.Tensor | None = None,
                         words: dict | None = None, want_h: bool = False):
    """The plain version of the kernel: (idx [B, frame_size] int32, yr, yi,
    nr, ni [B, S*sps] float32, stats [1, 10, S*sps] float32), and with
    `want_h` the true channel DFT h, [B, nfft, 2] float32, or
    [B, S, nfft, 2] when the spec is mobile.

    `std` [B] is the per-frame noise std (`noise_std`).  Random words come
    from `words` (int64 tensors by stream name, as `draw_words` returns
    them) or are made from `seeds` with the kernel's Philox layout.  The
    math is that of JAX's `emulate_fused_synthesize` (`:823-947`)."""
    dev = std.device
    if words is None:
        words = draw_words(spec, n_frames, seeds, dev)
    words = {k: torch.as_tensor(v, device=dev).to(torch.int64)
             for k, v in words.items()}
    idx = (words["idx"] & (2 ** spec.nbits - 1)).to(torch.int32)
    table = torch.from_numpy(spec.sym_table).to(dev)
    sym = table[idx.to(torch.int64)]                     # [B, D, 2]
    sym_r, sym_i = sym[..., 0], sym[..., 1]
    w_r = torch.from_numpy(spec.w_r).to(dev)
    w_i = torch.from_numpy(spec.w_i).to(dev)
    bias_r = torch.from_numpy(spec.bias_r).to(dev)
    bias_i = torch.from_numpy(spec.bias_i).to(dev)
    outs_r, outs_i = [], []
    start = 0
    for s, c in enumerate(spec.counts):
        sr, si = sym_r[:, start:start + c], sym_i[:, start:start + c]
        wr, wi = w_r[start:start + c], w_i[start:start + c]
        outs_r.append(sr @ wr - si @ wi + bias_r[s])
        outs_i.append(sr @ wi + si @ wr + bias_i[s])
        start += c
    x_r, x_i = torch.cat(outs_r, 1), torch.cat(outs_i, 1)
    h = None
    if spec.do_fir:
        g0, g1 = _box_muller(_u01(words["tap_u1"]), _u01(words["tap_u2"]))
        zr, zi = g0 * _SQRT_HALF, g1 * _SQRT_HALF          # CN(0, 1) taps
        cls = torch.arange(n_frames, device=dev) % spec.n_classes

        def rows(arr):
            return torch.from_numpy(arr).to(dev)[cls]

        coeff, alpha, gbias = (rows(spec.coeff_cls), rows(spec.alpha_cls),
                               rows(spec.gbias_cls))
        hb = (rows(spec.hb_r), rows(spec.hb_i), rows(spec.hbias_cls))
        gt_r, gt_i = _tap_gt(zr, zi, coeff, alpha, gbias, spec.taps)
        y_r, y_i = _fir_same_unified(x_r, x_i, gt_r, gt_i, spec)
        if want_h:
            h = _tap_h(zr, zi, coeff, *hb, spec.taps)
        if spec.mobile:
            # Doppler rows: per-symbol Jakes gains, kernels and H; the
            # windowed per-symbol FIR; static rows keep their draws
            thr = (2.0 * math.pi) * _u01(words["jakes_u1"])
            thi = (2.0 * math.pi) * _u01(words["jakes_u2"])
            dop = torch.from_numpy(doppler_rows(spec, n_frames)).to(dev)
            fd = rows(spec.fd_cls) * dop
            fvr = fd[:, None] * torch.from_numpy(
                spec.jakes_base_r.reshape(1, -1)).to(dev)
            fvi = fd[:, None] * torch.from_numpy(
                spec.jakes_base_i.reshape(1, -1)).to(dev)
            dop = dop[:, None]
            gts_r, gts_i, hs = [], [], []
            for s in range(spec.nsymbol):
                zrs, zis = _jakes_sym_gains(thr, thi, fvr, fvi,
                                            s * spec.t_sym, spec.taps)
                zsr = torch.where(dop, zrs, zr)
                zsi = torch.where(dop, zis, zi)
                g_r, g_i = _tap_gt(zsr, zsi, coeff, alpha, gbias, spec.taps)
                gts_r.append(g_r)
                gts_i.append(g_i)
                if want_h:
                    hs.append(_tap_h(zsr, zsi, coeff, *hb, spec.taps))
            yd_r, yd_i = _fir_sym_unified(x_r, x_i, torch.stack(gts_r, 1),
                                          torch.stack(gts_i, 1), spec)
            y_r = torch.where(dop, yd_r, y_r)
            y_i = torch.where(dop, yd_i, y_i)
            if want_h:
                h = torch.stack(hs, 1)                   # [B, S, nfft, 2]
    else:
        y_r, y_i = x_r, x_i
        if want_h:
            h = torch.zeros(n_frames, spec.nfft, 2, device=dev)
            h[..., 0] = 1.0
    un_r, un_i = _box_muller(_u01(words["noise_u1"]),
                             _u01(words["noise_u2"]))
    std = std.reshape(-1, 1).to(torch.float32)
    n_r, n_i = std * un_r, std * un_i
    stats = torch.stack([
        y_r.sum(0), y_i.sum(0), (y_r * y_r).sum(0), (y_i * y_i).sum(0),
        n_r.sum(0), n_i.sum(0), (n_r * n_r).sum(0), (n_i * n_i).sum(0),
        (y_r * n_r).sum(0), (y_i * n_i).sum(0)])[None]
    out = (idx, y_r, y_i, n_r, n_i, stats)
    return out + (h,) if want_h else out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class _SynthArgs(ctypes.Structure):
    """`SynthArgs` of csrc/fused_synth.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "seeds", "std", "w_iq", "bias_iq", "sym_tab", "sym_start", "coeff",
        "alpha", "gbias", "hb_iq", "hbias", "fd_cls", "dop_cycle",
        "jakes_base", "sym_phase", "idx", "yr", "yi", "nr", "ni", "h",
        "stats")] + [("jakes_c1", ctypes.c_float)] + [
        (n, ctypes.c_int) for n in (
            "n_frames", "nbits", "nsymbol", "sps", "frame_size",
            "n_classes", "taps", "fir_u", "off_u", "do_fir", "nfft",
            "mobile", "cyc_len", "ss", "want_h", "real_tab", "cp", "rows",
            "threads", "halves", "smem", "grid")]


@functools.cache
def _synth_lib():
    lib = cuda_build.load("fused_synth")
    lib.fused_synth_f32.argtypes = [ctypes.POINTER(_SynthArgs),
                                    ctypes.c_void_p]
    lib.fused_synth_f32.restype = ctypes.c_int
    lib.fused_synth_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p]
    lib.fused_synth_blocks_per_sm.restype = ctypes.c_int
    return lib


_CONSTS: dict = {}


def _spec_consts(spec: SynthSpec, device: torch.device) -> dict:
    """The spec's constants as tensors on `device`, built once."""
    key = (id(spec), str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        starts = np.concatenate([[0], np.cumsum(spec.counts)]).astype(np.int32)
        arrs = {"w_iq": np.stack([spec.w_r, spec.w_i], -1),
                "bias_iq": np.stack([spec.bias_r, spec.bias_i], -1),
                "sym_tab": spec.sym_table, "sym_start": starts,
                "coeff": spec.coeff_cls, "alpha": spec.alpha_cls,
                "gbias": spec.gbias_cls,
                "hb_iq": np.stack([spec.hb_r, spec.hb_i], -1),
                "hbias": spec.hbias_cls}
        if spec.mobile:
            arrs.update(
                fd_cls=spec.fd_cls,
                dop_cycle=spec.dop_cycle.astype(np.int32),
                jakes_base=np.stack([spec.jakes_base_r.reshape(-1),
                                     spec.jakes_base_i.reshape(-1)], -1),
                # float32(2 pi t_s), as `_jakes_sym_gains` rounds it
                sym_phase=np.asarray([2 * np.pi * (s * spec.t_sym)
                                      for s in range(spec.nsymbol)],
                                     np.float32))
        hit = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in arrs.items()}
        hit["spec"] = spec         # keeps id(spec) from being reused
        hit["cp"] = _cyclic_prefix(spec)
        _CONSTS[key] = hit
    return hit


def _cyclic_prefix(spec: SynthSpec) -> int:
    """The symbol's first sps - nfft samples where the TX operator's and
    the pilots' columns repeat its last ones exactly (the kernel then
    copies them), else 0."""
    cp, n = spec.sps - spec.nfft, spec.nfft
    same = cp > 0 and all(np.array_equal(m[:, :cp], m[:, n:n + cp]) for m in (
        spec.w_r, spec.w_i, spec.bias_r, spec.bias_i))
    return cp if same else 0


def _synth_args(spec: SynthSpec, n_frames: int, want_h: bool) -> _SynthArgs:
    """The kernel's arguments without their pointers and plan."""
    return _SynthArgs(
        jakes_c1=float(np.sqrt(1.0 / SS)), n_frames=n_frames,
        nbits=spec.nbits, nsymbol=spec.nsymbol, sps=spec.sps,
        frame_size=spec.frame_size, n_classes=spec.n_classes,
        taps=spec.taps, fir_u=spec.fir_u, off_u=spec.off_u,
        do_fir=int(spec.do_fir), nfft=spec.nfft, mobile=int(spec.mobile),
        cyc_len=len(spec.dop_cycle) if spec.mobile else 0, ss=SS,
        want_h=int(want_h), real_tab=int(not spec.sym_table[:, 1].any()))


# the kernel's layout (csrc/fused_synth.cu), which its plan sizes
SYNTH_THREADS = 288           # a block's, two a SM
SYNTH_ROWS = (8, 4, 2, 1)     # rows a group, the most that fit
SYNTH_FIR_CHUNK = 8           # FIR taps a window of the padded row
SYNTH_SMEM_MAX = 232448       # shared memory a Hopper block can have
SYNTH_SMEM_TWO = 115712       # what lets two blocks share an SM's 228 KB


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def _halves(spec: SynthSpec, rows: int, threads: int) -> int:
    """Ways stage 4 splits a group's rows: as many as the block's threads
    hold the frame's column quads."""
    return max(1, min(rows, threads // -(-spec.length // 4)))


def synth_smem(spec: SynthSpec, rows: int,
               threads: int = SYNTH_THREADS) -> int:
    """Shared bytes of a block that takes `rows` rows a group: `layout` of
    csrc/fused_synth.cu, region by region (the planes at the padded pitch,
    or a mobile group's Jakes phases and bases if larger; the decoded
    symbols' two planes for whole row quads; each thread half's [10, L]
    sums; static and per-symbol gains, FIR kernels, the profile constants,
    symbol starts)."""
    s, length = spec.nsymbol, spec.length
    l4c = -(-length // 4)
    nch = -(-spec.fir_u // SYNTH_FIR_CHUNK)
    pitch = 4 * l4c + SYNTH_FIR_CHUNK * nch
    nsst, s1 = SS * spec.taps, (s if spec.mobile else 1)
    p, taps, fir_u = spec.n_classes, spec.taps, spec.fir_u
    mob = int(spec.mobile)
    planes = max(2 * rows * pitch, mob * (2 * rows * nsst + 2 * nsst))
    sizes = [4 * planes, 4 * 2 * -(-rows // 4) * 4 * spec.frame_size,
             4 * _halves(spec, rows, threads) * 10 * length,
             8 * rows * taps, 8 * mob * rows * s * taps,
             8 * rows * s1 * fir_u, 8 * 16, 4 * p * taps,
             4 * p * taps * fir_u, 4 * p * fir_u, 4 * (s + 1)]
    return sum(_align16(n) for n in sizes)


class SynthPlan(NamedTuple):
    rows: int                  # frame rows a group
    threads: int               # a block's
    halves: int                # stage 4 splits a group's rows this many ways
    smem_bytes: int
    groups: int
    grid: int                  # blocks, and the partials' leading dimension


@functools.lru_cache(maxsize=64)
def synth_plan(spec: SynthSpec, n_frames: int, sms: int = 132,
               blocks_per_sm: int | None = None) -> SynthPlan:
    """The kernel's plan for `n_frames` rows of `spec`: 288 threads (more
    for frames past 1,152 samples, one a column quad), the most rows a
    group (8, 4, 2, 1) whose shared memory lets two blocks share an SM, or
    failing that fits one block; the rows split between as many thread
    halves as the column quads allow; a grid of as many blocks as the card
    holds (`blocks_per_sm`: two where the shared memory allows, unless
    given), no more than the groups.  Raises where one row does not fit."""
    l4c = -(-spec.length // 4)
    threads = max(SYNTH_THREADS, -(-l4c // 32) * 32)
    if threads > 1024:
        raise ValueError(f"fused_synthesize_kernel: frames of {spec.length} "
                         "samples exceed 4,096")
    sizes = {r: synth_smem(spec, r, threads) for r in SYNTH_ROWS}
    two = [r for r in SYNTH_ROWS if sizes[r] <= SYNTH_SMEM_TWO]
    one = [r for r in SYNTH_ROWS if sizes[r] <= SYNTH_SMEM_MAX]
    if threads == SYNTH_THREADS and two:
        rows = two[0]
    elif one:
        rows = one[0]
    else:
        raise ValueError("fused_synthesize_kernel: one frame row of this "
                         "spec does not fit in a block's shared memory")
    halves = _halves(spec, rows, threads)
    groups = -(-max(n_frames, 1) // rows)
    if blocks_per_sm is None:
        blocks_per_sm = 2 if (threads == SYNTH_THREADS
                              and sizes[rows] <= SYNTH_SMEM_TWO) else 1
    return SynthPlan(rows, threads, halves, sizes[rows], groups,
                     min(groups, sms * blocks_per_sm))


@functools.cache
def _synth_occupancy(device: int, threads: int, smem: int) -> tuple[int, int]:
    """(SMs, blocks a SM holds) of the kernel at `threads` threads and
    `smem` shared bytes on CUDA device `device`."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = _synth_lib().fused_synth_blocks_per_sm(threads, smem, out)
    if err != 0 or out[0] < 1:
        raise RuntimeError(f"fused_synth occupancy query failed: CUDA error "
                           f"{err}, {out[0]} blocks a SM")
    return out[1], out[0]


def synth_launch_plan(spec: SynthSpec, n_frames: int,
                      device: int) -> SynthPlan:
    """The plan `fused_synthesize_kernel` launches on CUDA device `device`
    (its stats hold `grid` partials)."""
    plan = synth_plan(spec, n_frames)
    return synth_plan(spec, n_frames, *_synth_occupancy(
        device, plan.threads, plan.smem_bytes))


def fused_synthesize_kernel(spec: SynthSpec, seeds: torch.Tensor,
                            std: torch.Tensor, want_h: bool = False):
    """Launch the CUDA kernel for `len(std)` frames: seeds int64 [2] and std
    float32 [B] on one CUDA device.  Returns what `fused_synthesize_ref`
    returns, with stats [grid, 10, S*sps] per-block partial sums (`grid`
    of `synth_launch_plan`)."""
    if not (seeds.is_cuda and std.device == seeds.device):
        raise ValueError("fused_synthesize_kernel: seeds and std must be on "
                         "one CUDA device")
    if seeds.dtype != torch.int64 or seeds.shape != (2,) \
            or std.dtype != torch.float32 or std.dim() != 1 \
            or not (seeds.is_contiguous() and std.is_contiguous()):
        raise ValueError("fused_synthesize_kernel takes contiguous int64 "
                         "seeds [2] and float32 std [B]")
    b, l, d = std.shape[0], spec.length, spec.frame_size
    if b >= 2**31 // max(l, spec.nsymbol * spec.nfft, 1):
        raise ValueError("fused_synthesize_kernel: B*S*sps must fit in "
                         "int32")
    dev = std.device
    f32 = dict(device=dev, dtype=torch.float32)
    c = _spec_consts(spec, dev)
    plan = synth_launch_plan(spec, b, dev.index)
    idx = torch.empty(b, d, device=dev, dtype=torch.int32)
    yr, yi, nr, ni = (torch.empty(b, l, **f32) for _ in range(4))
    stats = torch.empty(plan.grid if b else 0, 10, l, **f32)
    h = None
    if want_h:
        h = torch.empty((b, spec.nsymbol, spec.nfft, 2) if spec.mobile
                        else (b, spec.nfft, 2), **f32)
    out = (idx, yr, yi, nr, ni, stats) + ((h,) if want_h else ())
    if b == 0:
        return out
    args = _synth_args(spec, b, want_h)
    for name in ("w_iq", "bias_iq", "sym_tab", "sym_start", "coeff", "alpha",
                 "gbias", "hb_iq", "hbias", "fd_cls", "dop_cycle",
                 "jakes_base", "sym_phase"):
        if name in c:
            setattr(args, name, c[name].data_ptr())
    for name, t in (("seeds", seeds), ("std", std), ("idx", idx), ("yr", yr),
                    ("yi", yi), ("nr", nr), ("ni", ni), ("h", h),
                    ("stats", stats)):
        setattr(args, name, None if t is None else t.data_ptr())
    args.cp = c["cp"]
    args.rows, args.threads, args.halves = plan.rows, plan.threads, \
        plan.halves
    args.smem, args.grid = plan.smem_bytes, plan.grid
    with torch.cuda.device(dev):
        err = _synth_lib().fused_synth_f32(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_synth kernel launch failed: CUDA error "
                           f"{err}")
    fused_synthesize_kernel.launches += 1
    return out


fused_synthesize_kernel.launches = 0


# ---------------------------------------------------------------------------
# around the kernel (XLA's part in JAX)
# ---------------------------------------------------------------------------


def _combine_stats(sums: torch.Tensor, n_frames: int, eps: float = 1e-9):
    """[10, L] partial sums -> (a, c [6, L], noise_power, sig_pwr): the
    AWGN normalizer a and the per-position affine x = y*c0 + n*c1 - c2 (and
    c3..c5 for the imaginary plane) that is batch_norm_ref of a*y + n."""
    syr, syi, syyr, syyi, snr_, sni, snnr, snni, synr, syni = sums
    count = n_frames * sums.shape[-1]
    sig_pwr = (syyr.sum() + syyi.sum()) / count
    a = torch.rsqrt(sig_pwr)
    noise_power = (snnr.sum() + snni.sum()) / count

    def plane(sy, syy, sn, snn, syn):
        m = (a * sy + sn) / n_frames
        ex2 = (a * a * syy + 2.0 * a * syn + snn) / n_frames
        scale = torch.rsqrt(ex2 - m * m + eps) / math.sqrt(2.0)
        return a * scale, scale, m * scale

    c = torch.stack([*plane(syr, syyr, snr_, snnr, synr),
                     *plane(syi, syyi, sni, snni, syni)])
    return a, c, noise_power, sig_pwr


def _bits_from_idx(idx: torch.Tensor, nbits: int) -> torch.Tensor:
    """[...] symbol indices -> [..., nbits] int32 bits, MSB first."""
    shifts = torch.arange(nbits - 1, -1, -1, dtype=torch.int32,
                          device=idx.device)
    return ((idx[..., None] >> shifts) & 1).to(torch.int32)


def fused_synthesize(spec: SynthSpec, n_frames: int, generator,
                     snr_db: torch.Tensor, want_h: bool = False,
                     raw: bool = False, words: dict | None = None):
    """The training step's data plane (`fused_synth.py:667`).

    Draws two seed words from `generator` (on snr_db's device) and runs the
    kernel where snr_db lies on a CUDA device, the plain version where it
    lies on the CPU.  `words=` replaces the draws (plain version only: the
    kernel draws its own).

    Returns (bits [B, frame, nbits] int32, rx_in [B, S, sps, 2], noise
    power), with `want_h` also h_freq [B, S, nfft, 2] (a static row's H
    broadcast over the symbols); `raw=True` returns (idx, yr, yi, nr, ni,
    stats), and h as the kernel writes it with `want_h`, for
    `ops.fused_model.dccn_fused_grads`."""
    dev = snr_db.device
    std = noise_std(snr_db)
    if std.shape[0] != n_frames:
        raise ValueError(f"snr_db holds {std.shape[0]} frames, not "
                         f"{n_frames}")
    if words is not None:
        if dev.type != "cpu":
            raise ValueError("words= feeds the plain version; the CUDA "
                             "kernel draws its own words")
        out = fused_synthesize_ref(spec, n_frames, std, words=words,
                                   want_h=want_h)
    else:
        seeds = torch.randint(0, 2**32, (2,), dtype=torch.int64,
                              generator=generator, device=dev)
        if dev.type == "cpu":
            out = fused_synthesize_ref(spec, n_frames, std, seeds=seeds,
                                       want_h=want_h)
        else:
            out = fused_synthesize_kernel(spec, seeds, std, want_h=want_h)
    if raw:
        return out
    idx, yr, yi, nr, ni, stats = out[:6]
    _, c, noise_power, _ = _combine_stats(stats.sum(0), n_frames)
    rxr = yr * c[0] + nr * c[1] - c[2]
    rxi = yi * c[3] + ni * c[4] - c[5]
    rx = torch.stack([rxr, rxi], -1).reshape(n_frames, spec.nsymbol,
                                             spec.sps, 2)
    ret = (_bits_from_idx(idx, spec.nbits), rx, noise_power)
    if not want_h:
        return ret
    h = out[6]
    if not spec.mobile:
        h = h[:, None].expand(n_frames, spec.nsymbol, spec.nfft, 2)
    return ret + (h,)
