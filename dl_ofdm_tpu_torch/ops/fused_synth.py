"""The training step's data plane in one kernel: bits -> OFDM TX -> Rayleigh
FIR -> AWGN -> per-position partial sums for the normalization.

Port of `dl_ofdm_tpu/ops/fused_synth.py` (the TPU kernel `_p1_kernel`,
`pallas_call` at `fused_synth.py:763`).  For each frame the kernel draws the
symbol indices, runs the per-symbol TX operator (placement, IDFT and CP in
one constant matrix, `ofdm.tx._symbol_tx_operator`), draws Box-Muller
Rayleigh taps, builds the frame's FIR kernel from its profile class
(pre-shifted alpha matrices, so mixed profiles share one 'same' offset),
convolves, draws the AWGN at the frame's std, and writes the signal and
noise planes, the indices and 10 per-position partial sums.  XLA's part,
`_combine_stats` and the affine epilogue, is plain tensor code here.

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
4 the noise's two uniforms (S*sps words each).  A row's draws depend only
on its global index, so the result does not depend on how rows are cut
into blocks.  Uniforms are `_u01` of a word, as in JAX.

Jakes Doppler (`mobile`) and the ground-truth channel (`want_h`) are a
later slice (ROADMAP Queue A 4); both raise `NotImplementedError`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from dl_ofdm_tpu_torch.ofdm.constellation import _table_np
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan
from dl_ofdm_tpu_torch.ofdm.tx import _symbol_tx_operator
from dl_ofdm_tpu_torch.ops import cuda_build

_SQRT_HALF = float(np.sqrt(0.5))
_LATER = ("is not ported yet: ROADMAP.md Queue A item 4 (Jakes Doppler and "
          "the ground-truth channel in the fused synthesize kernel)")

# Philox streams (see the module docstring)
STREAM_IDX, STREAM_TAP1, STREAM_TAP2, STREAM_NOISE1, STREAM_NOISE2 = range(5)


@dataclasses.dataclass(frozen=True, eq=False)
class SynthSpec:
    """Constants of the fused synthesize chain (numpy, built once)."""
    nbits: int
    nsymbol: int
    sps: int                 # samples per symbol (nfft + cp)
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


def build_synth_spec(plan: SubcarrierPlan, profiles=None, nbits: int = 1,
                     fd=None, dop_cycle=None) -> SynthSpec:
    """`profiles`: one `channel.profiles.TapProfile`, a sequence of them
    cycled per frame (None entries are AWGN passthrough frames), or None for
    a pure AWGN passthrough channel (`fused_synth.py:162`)."""
    if fd is not None or dop_cycle is not None:
        raise NotImplementedError(f"Jakes Doppler (mobile) {_LATER}")
    counts, w_sym_r, w_sym_i, bias = _symbol_tx_operator(plan)
    w_r = np.concatenate([w_sym_r[s, :c] for s, c in enumerate(counts)])
    w_i = np.concatenate([w_sym_i[s, :c] for s, c in enumerate(counts)])
    if profiles is None or not isinstance(profiles, (list, tuple)):
        profiles = [profiles]
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
    return SynthSpec(
        nbits=nbits, nsymbol=plan.nsymbol, sps=plan.samples_per_symbol,
        frame_size=plan.frame_size, counts=tuple(int(c) for c in counts),
        w_r=w_r.astype(np.float32), w_i=w_i.astype(np.float32),
        bias_r=bias[..., 0].astype(np.float32),
        bias_i=bias[..., 1].astype(np.float32),
        sym_table=_sym_table(nbits), do_fir=bool(live), n_classes=p_n,
        taps=taps, fir_u=fir_u, off_u=off_u, coeff_cls=coeff,
        alpha_cls=alpha, gbias_cls=gbias)


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
    """Every word the kernel draws for `n_frames` rows, by stream name."""
    rows = torch.arange(n_frames, device=device)
    l = spec.length
    words = {"idx": philox_words(seeds, rows, STREAM_IDX, spec.frame_size),
             "noise_u1": philox_words(seeds, rows, STREAM_NOISE1, l),
             "noise_u2": philox_words(seeds, rows, STREAM_NOISE2, l)}
    if spec.do_fir:
        words["tap_u1"] = philox_words(seeds, rows, STREAM_TAP1, spec.taps)
        words["tap_u2"] = philox_words(seeds, rows, STREAM_TAP2, spec.taps)
    return words


def fused_synthesize_ref(spec: SynthSpec, n_frames: int, std: torch.Tensor,
                         seeds: torch.Tensor | None = None,
                         words: dict | None = None):
    """The plain version of the kernel: (idx [B, frame_size] int32, yr, yi,
    nr, ni [B, S*sps] float32, stats [1, 10, S*sps] float32).

    `std` [B] is the per-frame noise std (`noise_std`).  Random words come
    from `words` (int64 tensors by stream name, as `draw_words` returns
    them) or are made from `seeds` with the kernel's Philox layout."""
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
    if spec.do_fir:
        g0, g1 = _box_muller(_u01(words["tap_u1"]), _u01(words["tap_u2"]))
        zr, zi = g0 * _SQRT_HALF, g1 * _SQRT_HALF          # CN(0, 1) taps
        cls = torch.arange(n_frames, device=dev) % spec.n_classes
        coeff = torch.from_numpy(spec.coeff_cls).to(dev)[cls]
        alpha = torch.from_numpy(spec.alpha_cls).to(dev)[cls]
        gt_r = torch.from_numpy(spec.gbias_cls).to(dev)[cls]
        gt_i = torch.zeros_like(gt_r)
        for t in range(spec.taps):
            gt_r = gt_r + (zr[:, t:t + 1] * coeff[:, t:t + 1]) * alpha[:, t]
            gt_i = gt_i + (zi[:, t:t + 1] * coeff[:, t:t + 1]) * alpha[:, t]
        # 'same' convolution in the unified offset: out[t] = sum_k
        # x[t + off_u - k] * gt[k]
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
    else:
        y_r, y_i = x_r, x_i
    un_r, un_i = _box_muller(_u01(words["noise_u1"]),
                             _u01(words["noise_u2"]))
    std = std.reshape(-1, 1).to(torch.float32)
    n_r, n_i = std * un_r, std * un_i
    stats = torch.stack([
        y_r.sum(0), y_i.sum(0), (y_r * y_r).sum(0), (y_i * y_i).sum(0),
        n_r.sum(0), n_i.sum(0), (n_r * n_r).sum(0), (n_i * n_i).sum(0),
        (y_r * n_r).sum(0), (y_i * n_i).sum(0)])[None]
    return idx, y_r, y_i, n_r, n_i, stats


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

ROWS_PER_CTA = 16           # frame rows per block of the CUDA kernel (`R`
                            # in the .cu, which checks the stats buffer)


class _SynthArgs(ctypes.Structure):
    """`SynthArgs` of csrc/fused_synth.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "seeds", "std", "w_iq", "bias_iq", "sym_tab", "sym_start", "coeff",
        "alpha", "gbias", "idx", "yr", "yi", "nr", "ni", "stats")] + [
        (n, ctypes.c_int) for n in (
            "n_frames", "nbits", "nsymbol", "sps", "frame_size",
            "n_classes", "taps", "fir_u", "off_u", "do_fir",
            "stats_blocks")]


@functools.cache
def _synth_fn():
    fn = cuda_build.load("fused_synth").fused_synth_f32
    fn.argtypes = [ctypes.POINTER(_SynthArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
                "gbias": spec.gbias_cls}
        hit = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in arrs.items()}
        hit["spec"] = spec         # keeps id(spec) from being reused
        _CONSTS[key] = hit
    return hit


def fused_synthesize_kernel(spec: SynthSpec, seeds: torch.Tensor,
                            std: torch.Tensor):
    """Launch the CUDA kernel for `len(std)` frames: seeds int64 [2] and std
    float32 [B] on one CUDA device.  Returns what `fused_synthesize_ref`
    returns, with stats [ceil(B / ROWS_PER_CTA), 10, S*sps] per-block
    partial sums."""
    if not (seeds.is_cuda and std.device == seeds.device):
        raise ValueError("fused_synthesize_kernel: seeds and std must be on "
                         "one CUDA device")
    if seeds.dtype != torch.int64 or seeds.shape != (2,) \
            or std.dtype != torch.float32 or std.dim() != 1 \
            or not (seeds.is_contiguous() and std.is_contiguous()):
        raise ValueError("fused_synthesize_kernel takes contiguous int64 "
                         "seeds [2] and float32 std [B]")
    b, l, d = std.shape[0], spec.length, spec.frame_size
    if l % 4 or spec.sps % 4 or b >= 2**31 // max(l, 1):
        raise ValueError("fused_synthesize_kernel: S*sps and sps must be "
                         "multiples of 4 and B*S*sps fit in int32")
    dev = std.device
    f32 = dict(device=dev, dtype=torch.float32)
    idx = torch.empty(b, d, device=dev, dtype=torch.int32)
    yr, yi, nr, ni = (torch.empty(b, l, **f32) for _ in range(4))
    stats = torch.empty(-(-b // ROWS_PER_CTA), 10, l, **f32)
    if b == 0:
        return idx, yr, yi, nr, ni, stats
    c = _spec_consts(spec, dev)
    args = _SynthArgs(
        seeds.data_ptr(), std.data_ptr(), c["w_iq"].data_ptr(),
        c["bias_iq"].data_ptr(), c["sym_tab"].data_ptr(),
        c["sym_start"].data_ptr(), c["coeff"].data_ptr(),
        c["alpha"].data_ptr(), c["gbias"].data_ptr(), idx.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), nr.data_ptr(), ni.data_ptr(),
        stats.data_ptr(), b, spec.nbits, spec.nsymbol, spec.sps, d,
        spec.n_classes, spec.taps, spec.fir_u, spec.off_u, int(spec.do_fir),
        stats.shape[0])
    with torch.cuda.device(dev):
        err = _synth_fn()(ctypes.byref(args),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_synth kernel launch failed: CUDA error "
                           f"{err}")
    fused_synthesize_kernel.launches += 1
    return idx, yr, yi, nr, ni, stats


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
    power); `raw=True` returns (idx, yr, yi, nr, ni, stats) for
    `ops.fused_model.dccn_fused_grads`."""
    if want_h:
        raise NotImplementedError(f"want_h {_LATER}")
    dev = snr_db.device
    std = noise_std(snr_db)
    if std.shape[0] != n_frames:
        raise ValueError(f"snr_db holds {std.shape[0]} frames, not "
                         f"{n_frames}")
    if words is not None:
        if dev.type != "cpu":
            raise ValueError("words= feeds the plain version; the CUDA "
                             "kernel draws its own words")
        out = fused_synthesize_ref(spec, n_frames, std, words=words)
    else:
        seeds = torch.randint(0, 2**32, (2,), dtype=torch.int64,
                              generator=generator, device=dev)
        if dev.type == "cpu":
            out = fused_synthesize_ref(spec, n_frames, std, seeds=seeds)
        else:
            out = fused_synthesize_kernel(spec, seeds, std)
    if raw:
        return out
    idx, yr, yi, nr, ni, stats = out
    _, c, noise_power, _ = _combine_stats(stats.sum(0), n_frames)
    rxr = yr * c[0] + nr * c[1] - c[2]
    rxi = yi * c[3] + ni * c[4] - c[5]
    rx = torch.stack([rxr, rxi], -1).reshape(n_frames, spec.nsymbol,
                                             spec.sps, 2)
    return _bits_from_idx(idx, spec.nbits), rx, noise_power
