"""The plain data plane of a static channel as a chain of two CUDA kernels.

`Trainer.synthesize` (TX, `RayleighChannel`, `awgn_channel`,
`batch_norm_ref`) takes ~80 launches a call on a card and copies per-frame
tables from pageable host memory, and the host sets the call's pace.  For a
call whose frames all take a static FIR (one static profile, the AWGN
passthrough, a static mix; no Doppler frame) on a CUDA device, this module
runs the same work in two launches of `csrc/synth_chain.cu` on the same
draws, with every constant on the device once:

  * kernel 1: bits -> symbols -> each symbol's inverse DFT (an in-shared-
    memory radix-2 FFT) and cyclic prefix -> the frame's FIR, built from
    its tap gains and its profile class -> the 'same' convolution; the
    true channel's DFT; each block's sum of |y|^2;
  * kernel 2: the AWGN (`y rsqrt(power) + std u`), the noise power, the
    normalization's moments (per group where `norm_groups` is given, with
    `batch_norm_ref`'s one-pass variance; else over the batch) and the
    normalization, in place.

The draws stay the caller's: bits (`randint`, unless given), the tap gains
(`randn [B, max_taps, 2]`, drawn on every call as the channel draws them)
and the bf16 unit noise's 7-bit indices (unless `unit_noise=` is given),
from the caller's generator in today's order and shapes, so the generator
stands where today's path leaves it.  Kernel 2 looks the indices up in the
bf16 table (`channel.awgn.bf16_normal_table`).

  * `chain_for` decides from what a call can observe (the device, the
    channel's `frame_layout`, the plan, the groups) whether the chain takes
    it, and counts the CUDA calls it leaves to today's path in
    `synth_chain_kernel.fallbacks`;
  * `synth_chain_kernel` launches the kernels and counts them in
    `synth_chain_kernel.launches` (two a call);
  * `synth_chain_ref` is the plain version: the same arithmetic in PyTorch
    operations, which the tests hold to today's path and to the kernels;
  * `synthesize` draws and runs the kernels on a card, the plain version on
    the CPU, and returns what `Trainer.synthesize` returns.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dl_ofdm_tpu_torch.channel.awgn import (bf16_normal_indices,
                                            bf16_normal_table)
from dl_ofdm_tpu_torch.ofdm.constellation import indices_from_bits
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan
from dl_ofdm_tpu_torch.ops import cuda_build
from dl_ofdm_tpu_torch.ops.fused_synth import (_fir_same_unified, _sym_table,
                                               _tap_gt, noise_std,
                                               profile_classes)

MAX_NBITS = 4
THREADS = 256                 # kernel 1's block; kernel 2's at most
TX_ROWS = (8, 4, 2, 1)        # kernel 1's frame rows a block
TX_SAMPLES = 2560             # kernel 1's samples a block, at most
NORM_COLS = (32, 16, 8, 4)    # kernel 2's float columns a block
SMEM_MAX = 232448             # shared memory a Hopper block can have
SMEM_THREE = 76800            # what lets three blocks share an SM's 228 KB
NORM_EPS = 1e-9               # `ops.norms.batch_norm_ref`'s
NOISE_TAB = 128               # the bf16 unit normals' table
_SQRT_HALF = float(np.sqrt(0.5))


@dataclasses.dataclass(frozen=True, eq=False)
class ChainConsts:
    """What the chain needs of a plan, a channel's static profile classes
    and a modulation (numpy, built once)."""
    nbits: int
    nsymbol: int
    nfft: int
    cp: int
    sps: int                 # samples per symbol (nfft + cp)
    frame_size: int
    data_sc: np.ndarray      # [frame_size] grid cells of the data symbols
    pilot_sc: np.ndarray     # the pilots' grid cells
    pilot: tuple             # the pilot value (re, im)
    gmap: np.ndarray         # [S * nfft] int32: data index, -1 empty, -2 pilot
    tw: np.ndarray           # [nfft / 2, 2] e^{+2 pi i k / nfft}
    sym_table: np.ndarray    # [2^nbits, 2] symbol of each index
    passthrough: np.ndarray  # [P] bool: frame i of class i % P passes through
    taps: int                # max tap count
    fir_u: int               # unified (pre-shifted) kernel length
    off_u: int               # unified 'same' offset
    coeff: np.ndarray        # [P, taps]
    alpha: np.ndarray        # [P, taps, fir_u]
    shift: np.ndarray        # [P] int32: off_u - the class's own offset
    nfir: np.ndarray         # [P] int32: the class's own kernel length

    @property
    def length(self) -> int:
        return self.nsymbol * self.sps

    @property
    def log2n(self) -> int:
        return self.nfft.bit_length() - 1

    @property
    def fade(self) -> bool:
        return not bool(self.passthrough.all())

    @property
    def n_classes(self) -> int:
        return len(self.passthrough)


def build_chain_consts(plan: SubcarrierPlan, profiles, nbits: int
                       ) -> ChainConsts:
    """`profiles`: the channel's profile classes (`frame_layout()[0]`:
    frame i takes class i % P, None a passthrough class)."""
    n, s_n = plan.nfft, plan.nsymbol
    gmap = np.full(s_n * n, -1, np.int32)
    gmap[plan.pilot_sc] = -2
    gmap[plan.data_sc] = np.arange(plan.frame_size, dtype=np.int32)
    ang = 2 * np.pi * np.arange(n // 2) / n
    cls = profile_classes(profiles)
    return ChainConsts(
        nbits=nbits, nsymbol=s_n, nfft=n, cp=plan.cp_len,
        sps=plan.samples_per_symbol, frame_size=plan.frame_size,
        data_sc=plan.data_sc, pilot_sc=plan.pilot_sc,
        pilot=(float(plan.pilot_value.real), float(plan.pilot_value.imag)),
        gmap=gmap,
        tw=np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32),
        sym_table=_sym_table(nbits),
        passthrough=np.asarray([p is None for p in profiles]),
        taps=cls.taps, fir_u=cls.fir_u, off_u=cls.off_u, coeff=cls.coeff,
        alpha=cls.alpha,
        shift=np.asarray([0 if p is None else cls.off_u - p.same_offset
                          for p in profiles], np.int32),
        nfir=np.asarray([1 if p is None else p.n_fir for p in profiles],
                        np.int32))


def tx_smem(c: ChainConsts, rows: int) -> int:
    """Kernel 1's shared bytes at `rows` rows a block: `tx_layout` of
    csrc/synth_chain.cu (the grids, one pad entry in 16; where a row fades
    the zero-padded time planes; the FIR kernels; the power tree; the
    symbol table; the rows' groups)."""
    fp = c.nfft + c.nfft // 16
    sizes = (8 * rows * c.nsymbol * fp,
             8 * rows * (c.length + c.fir_u - 1) * c.fade,
             8 * rows * c.fir_u, 4 * THREADS, 8 * 2 ** MAX_NBITS, 4 * rows)
    return sum(-(-b // 16) * 16 for b in sizes)


def norm_smem(cols: int, slices: int, n_groups: int, normalize: bool) -> int:
    """Kernel 2's shared bytes: `norm_layout` of csrc/synth_chain.cu (the
    tree, the noise table; where it normalizes the slices' sums, the
    columns' shifts (then means) and scales, the groups' counts and first
    frames)."""
    ge, z = max(1, n_groups), int(normalize)
    sizes = (4 * cols * slices, 4 * NOISE_TAB, 4 * z * 2 * slices * ge * cols,
             4 * z * 2 * ge * cols, 4 * z * ge, 4 * z * ge)
    return sum(-(-b // 16) * 16 for b in sizes)


class ChainPlan(NamedTuple):
    rows: int          # kernel 1: frame rows a block
    tx_smem: int
    tx_grid: int       # blocks, and power partials
    cols: int          # kernel 2: float columns of [B, 2L] a block
    slices: int        # frame slices a block (cols x slices threads)
    norm_smem: int
    norm_grid: int


def _tx_rows(c: ChainConsts) -> int | None:
    """The most rows a kernel-1 block takes within TX_SAMPLES samples and
    with three blocks an SM, else one row if it fits a block; None where
    one does not.  (An H100 at the sweep cells' calls: 4 rows of 560
    samples took 30.6 µs, 8 took 33.7 and 1 took 41.0; one row of 4,480
    took 74 µs, 2 took 94.)"""
    for rows in TX_ROWS:
        if rows * c.length <= TX_SAMPLES and tx_smem(c, rows) <= SMEM_THREE:
            return rows
    return 1 if tx_smem(c, 1) <= SMEM_MAX else None


@functools.lru_cache(maxsize=256)
def chain_plan(c: ChainConsts, n_frames: int, n_groups: int,
               normalize: bool, sms: int = 132) -> ChainPlan | None:
    """Both kernels' plan for `n_frames` frames in `n_groups` groups (0:
    moments over the batch), None where it does not fit.  Kernel 1:
    `_tx_rows`.  Kernel 2: the widest column tile (32, 16, 8, 4 floats)
    that still gives a block an SM, with 256 / W frame slices, halved
    while the slices' sums exceed a block's shared memory.  (An H100 at
    the ETU call: 8 columns 38 µs, 4 59, 16 99; at the nfft-512 call 32
    columns 97 µs, 16 119.)"""
    rows = _tx_rows(c)
    if rows is None:
        return None
    n_cols = 2 * c.length
    cols = next((w for w in NORM_COLS if -(-n_cols // w) >= sms),
                NORM_COLS[-1])
    slices = THREADS // cols
    while norm_smem(cols, slices, n_groups, normalize) > SMEM_MAX - 16:
        if slices == 1:
            return None
        slices //= 2
    return ChainPlan(rows, tx_smem(c, rows), -(-n_frames // rows), cols,
                     slices, norm_smem(cols, slices, n_groups, normalize),
                     -(-n_cols // cols))


_CONSTS: dict = {}


def chain_consts_for(plan: SubcarrierPlan, channel, nbits: int
                     ) -> ChainConsts | None:
    """The chain's constants for `channel`'s frames (built once a plan,
    profile set and modulation), or None where the chain does not take
    them: a channel without `frame_layout` or with Doppler frames, more
    than MAX_NBITS bits a symbol, an FFT size not a power of two, a class
    kernel longer than nfft, or a frame row beyond a block's shared
    memory."""
    layout = getattr(channel, "frame_layout", None)
    if layout is None:
        return None
    profiles, fd, _ = layout()
    if fd is not None:
        return None
    key = (id(plan), nbits, tuple(None if p is None else id(p)
                                  for p in profiles))
    hit = _CONSTS.get(key)
    if hit is None:
        n, c = plan.nfft, None
        if (1 <= nbits <= MAX_NBITS and n >= 2 and n & (n - 1) == 0
                and all(p is None or p.n_fir <= n for p in profiles)):
            c = build_chain_consts(plan, list(profiles), nbits)
            if _tx_rows(c) is None:
                c = None
        # the plan and profiles are cached objects; holding them here
        # keeps their ids from being reused
        hit = _CONSTS[key] = (c, plan, tuple(profiles))
    return hit[0]


def chain_for(plan: SubcarrierPlan, channel, nbits: int,
              device: torch.device, n_frames: int,
              norm_groups: torch.Tensor | None, normalize: bool):
    """(consts, plan) where the chain takes a `Trainer.synthesize` call on
    `device`, else None; a CUDA call it leaves to today's path counts in
    `synth_chain_kernel.fallbacks`."""
    if device.type != "cuda":
        return None
    c = chain_consts_for(plan, channel, nbits)
    p = None
    if c is not None and n_frames > 0:
        g = 0 if norm_groups is None else int(norm_groups.shape[-1])
        p = chain_plan(c, n_frames, g, bool(normalize), _sm_count(device))
    if p is None:
        synth_chain_kernel.fallbacks += 1
        return None
    return c, p


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _group_ids(onehot: torch.Tensor) -> torch.Tensor:
    """[B] the first column of each row that is not 0, -1 for none."""
    nz = onehot != 0
    first = nz.to(torch.int64).argmax(dim=1)
    return torch.where(nz.any(dim=1), first, torch.full_like(first, -1))


def _moments(v: torch.Tensor, norm_groups: torch.Tensor | None):
    """Per-frame (mean, var) [B, 2L] of v [B, 2L] over the frame's group
    (without groups one group of all frames; a frame in no group 0, 0):
    the one-pass E[d^2] - E[d]^2 of d = v - K, K the group's first frame's
    values."""
    b = v.shape[0]
    g = (torch.zeros(b, dtype=torch.int64, device=v.device)
         if norm_groups is None else _group_ids(norm_groups))
    n_g = 1 if norm_groups is None else norm_groups.shape[-1]
    ok = g >= 0
    gi = g.clamp(min=0)
    rows = torch.arange(b, device=v.device)
    first = torch.full((n_g,), b, dtype=torch.int64, device=v.device)
    first = first.scatter_reduce(0, gi[ok], rows[ok], "amin")
    shift = torch.where((first < b)[:, None], v[first.clamp(max=b - 1)],
                        torch.zeros_like(v[:1]))
    d = v - shift[gi]
    cnt = torch.zeros(n_g, dtype=v.dtype, device=v.device).index_add_(
        0, gi[ok], torch.ones_like(gi[ok], dtype=v.dtype))
    s1 = torch.zeros(n_g, v.shape[1], dtype=v.dtype,
                     device=v.device).index_add_(0, gi[ok], d[ok])
    s2 = torch.zeros_like(s1).index_add_(0, gi[ok], d[ok] * d[ok])
    m1 = s1 / cnt[:, None]
    mean, var = shift + m1, s2 / cnt[:, None] - m1 * m1
    zero = torch.zeros_like(v)
    return (torch.where(ok[:, None], mean[gi], zero),
            torch.where(ok[:, None], var[gi], zero))


def synth_chain_ref(c: ChainConsts, bits: torch.Tensor, zck: torch.Tensor,
                    unit_noise: torch.Tensor, snr_db: torch.Tensor,
                    norm_groups: torch.Tensor | None = None,
                    normalize: bool = True):
    """The chain's arithmetic in PyTorch operations, on any device: bits
    [B, frame_size, nbits], zck [B, >= taps, 2] the tap draws before the
    1 / sqrt 2, unit_noise [B, S, sps, 2] float32, snr_db [B] ->
    (rx_in or, without `normalize`, the noisy waveform [B, S, sps, 2],
    h [B, nfft, 2], noise power, waveform [B, S, sps, 2])."""
    dev = bits.device
    b, s_n, n, length = bits.shape[0], c.nsymbol, c.nfft, c.length
    idx = indices_from_bits(bits) & (2 ** c.nbits - 1)
    sym = torch.from_numpy(c.sym_table).to(dev)[idx]           # [B, D, 2]
    grid = torch.zeros(b, s_n * n, 2, device=dev)
    grid[:, torch.from_numpy(c.data_sc).to(dev)] = sym
    grid[:, torch.from_numpy(c.pilot_sc).to(dev)] = torch.tensor(
        c.pilot, device=dev)
    time = torch.fft.ifft(torch.view_as_complex(grid.reshape(b, s_n, n, 2)),
                          dim=-1)
    time = torch.cat([time[..., n - c.cp:], time], dim=-1)    # [B, S, sps]
    wf = torch.view_as_real(time).contiguous()
    x_r, x_i = wf[..., 0].reshape(b, length), wf[..., 1].reshape(b, length)
    cls = torch.arange(b, device=dev) % c.n_classes
    pas = torch.from_numpy(c.passthrough).to(dev)[cls]
    h = torch.zeros(b, n, 2, device=dev)
    h[..., 0] = 1.0
    y_r, y_i = x_r, x_i
    if c.fade:
        def rows(arr):
            return torch.from_numpy(arr).to(dev)[cls]
        zr = zck[:, :c.taps, 0] * _SQRT_HALF
        zi = zck[:, :c.taps, 1] * _SQRT_HALF
        gt_r, gt_i = _tap_gt(zr, zi, rows(c.coeff), rows(c.alpha),
                             torch.zeros(b, c.fir_u, device=dev), c.taps)
        f_r, f_i = _fir_same_unified(x_r, x_i, gt_r, gt_i, c)
        y_r = torch.where(pas[:, None], x_r, f_r)
        y_i = torch.where(pas[:, None], x_i, f_i)
        # h[k] = sum_j gt[shift + j] e^{-2 pi i j k / nfft}, j < nfir
        j = torch.arange(c.fir_u, device=dev)
        pos = j[None, :] - rows(c.shift)[:, None]                 # [B, F]
        valid = (pos >= 0) & (pos < rows(c.nfir)[:, None])
        m = (pos.clamp(min=0)[:, :, None] * torch.arange(n, device=dev)
             ) % n                                                # [B, F, n]
        ang = 2 * math.pi * m.to(torch.float64) / n
        cs = torch.cos(ang).to(torch.float32) * valid[..., None]
        sn = torch.sin(ang).to(torch.float32) * valid[..., None]
        hr = (gt_r[..., None] * cs + gt_i[..., None] * sn).sum(1)
        hi = (gt_i[..., None] * cs - gt_r[..., None] * sn).sum(1)
        h = torch.where(pas[:, None, None], h, torch.stack([hr, hi], -1))
    y = torch.stack([y_r, y_i], -1).reshape(b, 2 * length)
    scale = torch.rsqrt((y * y).sum() / (b * length))
    noise = noise_std(snr_db)[:, None] * unit_noise.reshape(b, 2 * length)
    v = y * scale + noise
    noise_power = (noise * noise).sum() / (b * length)
    if normalize:
        mean, var = _moments(v, norm_groups)
        v = (v - mean) * torch.rsqrt(var + NORM_EPS) * _SQRT_HALF
    shape = (b, s_n, c.sps, 2)
    return v.reshape(shape), h, noise_power, wf


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_PTRS = ("gmap", "dpos", "tw", "sym_tab", "coeff", "alpha", "cls_pass",
         "cls_shift", "cls_nfir", "noise_tab", "bits", "zck", "snr",
         "onehot", "noise", "noise_idx", "wf", "y", "h", "pwr_part", "stdv",
         "grp", "np_part", "noise_power", "done")
_INTS = ("n_frames", "nbits", "nsymbol", "nfft", "log2n", "cp", "sps",
         "frame_size", "n_classes", "taps", "zstride", "fir_u", "off_u",
         "fade", "n_groups", "normalize", "rows", "tx_smem", "tx_grid",
         "cols", "slices", "norm_smem", "norm_grid")


class _ChainArgs(ctypes.Structure):
    """`ChainArgs` of csrc/synth_chain.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [("pilot_re", ctypes.c_float), ("pilot_im", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in _INTS])


@functools.cache
def _chain_lib():
    lib = cuda_build.load("synth_chain")
    lib.synth_chain_f32.argtypes = [ctypes.POINTER(_ChainArgs),
                                    ctypes.c_void_p]
    lib.synth_chain_f32.restype = ctypes.c_int
    return lib


_DEVICE_CONSTS: dict = {}


def _consts_on(c: ChainConsts, device: torch.device) -> dict:
    """The constants as tensors on `device`, made once; with the bf16
    noise table and kernel 2's block counter (zero between calls)."""
    key = (id(c), str(device))
    hit = _DEVICE_CONSTS.get(key)
    if hit is None:
        arrs = {"gmap": c.gmap, "dpos": c.data_sc.astype(np.int32),
                "tw": c.tw, "sym_tab": c.sym_table,
                "coeff": c.coeff, "alpha": c.alpha,
                "cls_pass": c.passthrough.astype(np.int32),
                "cls_shift": c.shift, "cls_nfir": c.nfir}
        hit = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in arrs.items()}
        hit["noise_tab"] = bf16_normal_table(device).to(torch.float32)
        hit["done"] = torch.zeros(1, dtype=torch.int32, device=device)
        hit["consts"] = c          # keeps id(c) from being reused
        _DEVICE_CONSTS[key] = hit
    return hit


def synth_chain_kernel(c: ChainConsts, plan: ChainPlan, bits: torch.Tensor,
                       zck: torch.Tensor, snr: torch.Tensor,
                       norm_groups: torch.Tensor | None = None,
                       unit_noise: torch.Tensor | None = None,
                       noise_idx: torch.Tensor | None = None,
                       normalize: bool = True):
    """Launch both kernels: bits int32 [B, frame_size, nbits], zck float32
    [B, >= taps, 2], snr float32 [B], norm_groups float32 [B, G] or None,
    and the unit noise as float32 normals [B, S, sps, 2] or as int32 table
    indices of that shape, all contiguous on one CUDA device.  Returns
    what `synth_chain_ref` returns; the noise power a 0-dim view."""
    dev = bits.device
    b, length = bits.shape[0], c.length
    noise = unit_noise if unit_noise is not None else noise_idx
    ts = [t for t in (bits, zck, snr, norm_groups, noise) if t is not None]
    if not (dev.type == "cuda" and all(t.device == dev for t in ts)):
        raise ValueError("synth_chain_kernel: inputs must be on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("synth_chain_kernel takes contiguous inputs")
    wants = [(bits, torch.int32, (b, c.frame_size, c.nbits)),
             (snr, torch.float32, (b,)),
             (noise, torch.float32 if unit_noise is not None else torch.int32,
              (b, c.nsymbol, c.sps, 2))]
    if norm_groups is not None:
        wants.append((norm_groups, torch.float32,
                      (b, norm_groups.shape[-1])))
    if any(t.dtype != dt or tuple(t.shape) != sh for t, dt, sh in wants) \
            or noise is None or zck.dtype != torch.float32 \
            or zck.dim() != 3 or zck.shape[0] != b or zck.shape[2] != 2 \
            or zck.shape[1] < c.taps:
        raise ValueError("synth_chain_kernel: inputs of other types or "
                         "shapes than it takes")
    if b == 0 or b * 2 * length >= 2**31:
        raise ValueError("synth_chain_kernel takes one frame or more, and "
                         "B * S * sps * 2 within int32")
    f32 = dict(device=dev, dtype=torch.float32)
    wf = torch.empty(b, c.nsymbol, c.sps, 2, **f32)
    y = torch.empty_like(wf)
    h = torch.empty(b, c.nfft, 2, **f32)
    work = torch.empty(plan.tx_grid + plan.norm_grid + 1 + b, **f32)
    grp = torch.empty(b if norm_groups is not None else 0, device=dev,
                      dtype=torch.int32)
    noise_power = work[-1 - b]
    k = _consts_on(c, dev)
    args = _ChainArgs(pilot_re=c.pilot[0], pilot_im=c.pilot[1], n_frames=b,
                      nbits=c.nbits, nsymbol=c.nsymbol, nfft=c.nfft,
                      log2n=c.log2n, cp=c.cp, sps=c.sps,
                      frame_size=c.frame_size, n_classes=c.n_classes,
                      taps=c.taps, zstride=zck.shape[1], fir_u=c.fir_u,
                      off_u=c.off_u, fade=int(c.fade),
                      n_groups=0 if norm_groups is None
                      else norm_groups.shape[-1],
                      normalize=int(normalize), **plan._asdict())
    for name in ("gmap", "dpos", "tw", "sym_tab", "coeff", "alpha", "cls_pass",
                 "cls_shift", "cls_nfir", "noise_tab", "done"):
        setattr(args, name, k[name].data_ptr())
    for name, t in (("bits", bits), ("zck", zck), ("snr", snr),
                    ("onehot", norm_groups), ("noise", unit_noise),
                    ("noise_idx", noise_idx), ("wf", wf), ("y", y), ("h", h),
                    ("grp", grp if norm_groups is not None else None)):
        setattr(args, name, None if t is None else t.data_ptr())
    args.pwr_part = work.data_ptr()
    args.np_part = work[plan.tx_grid:].data_ptr()
    args.noise_power = noise_power.data_ptr()
    args.stdv = work[-b:].data_ptr()
    with torch.cuda.device(dev):
        err = _chain_lib().synth_chain_f32(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"synth_chain kernel launch failed: CUDA error "
                           f"{err}")
    synth_chain_kernel.launches += 2
    return y, h, noise_power, wf


synth_chain_kernel.launches = 0
synth_chain_kernel.fallbacks = 0


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def synthesize(chain, n_frames: int, snr_db: torch.Tensor, generator,
               norm_groups: torch.Tensor | None, bits: torch.Tensor | None,
               unit_noise: torch.Tensor | None, normalize: bool,
               dev: torch.device, max_taps: int):
    """`Trainer.synthesize` through the chain (`chain`: what `chain_for`
    returned): the draws in today's order from `generator` (bits unless
    given, the tap gains [B, max_taps, 2], the unit noise's indices unless
    given), then the kernels on a CUDA device or the plain version on the
    CPU.  Returns (bits, rx_in, h_freq [B, S, nfft, 2], noise_power,
    waveform)."""
    c, plan = chain
    if bits is None:
        bits = torch.randint(0, 2, (n_frames, c.frame_size, c.nbits),
                             generator=generator, device=dev,
                             dtype=torch.int32)
    b = bits.shape[0]
    zck = torch.randn(b, max_taps, 2, device=dev, generator=generator)
    shape = (b, c.nsymbol, c.sps, 2)
    idx = None
    if unit_noise is None:
        idx = bf16_normal_indices(shape, dev, generator).reshape(shape)
    snr = snr_db.reshape(-1).to(dev, torch.float32)
    if snr.shape[0] != b:
        snr = snr.expand(b)
    snr = snr.contiguous()
    groups = None if norm_groups is None else \
        norm_groups.to(dev, torch.float32).contiguous()
    if dev.type == "cuda":
        rx, h, npwr, wf = synth_chain_kernel(
            c, plan, bits.to(torch.int32).contiguous(), zck, snr, groups,
            None if unit_noise is None
            else unit_noise.to(dev, torch.float32).contiguous(), idx,
            normalize)
    else:
        unit = (bf16_normal_table(dev)[idx.to(torch.int64)]
                if unit_noise is None else unit_noise).to(torch.float32)
        rx, h, npwr, wf = synth_chain_ref(c, bits, zck, unit, snr, groups,
                                          normalize)
    return (bits, rx, h[:, None].expand(b, c.nsymbol, c.nfft, 2), npwr, wf)
