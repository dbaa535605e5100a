"""The hand-written Hopper kernels that replace the JAX package's Pallas
kernels, each beside its plain PyTorch version.

Port of `dl_ofdm_tpu/ops/pallas_kernels.py` (the module keeps its name so
its counterpart is easy to find).  It holds both of that module's kernels.

`complex_dense`, the learned-DFT complex matmul y = x @ (wr + i wi) of the
DCCN's `fft_like` layer and of the equalizer's `ToFreq`, `CorrT` and
`ToTime`:

  * `complex_dense_kernel` launches the CUDA kernel
    (`csrc/complex_dense.cu`, built by `ops/cuda_build.py`) on a CUDA
    tensor and counts its launches in `complex_dense_kernel.launches`;
  * `complex_dense_ref` is the plain version: four `torch.matmul`s and the
    recombination;
  * `complex_dense` is the differentiable op (`ComplexDenseFn`): the kernel
    for CUDA tensors, the plain version for CPU tensors, and the backward
    pass of `_cdense_bwd` (`pallas_kernels.py:108-119`) as plain matmuls,
    as in JAX.

Each takes `compute_dtype`: None (float32 products) or 'bfloat16', the
TPU kernel fed bf16 operands with float32 sums (`complex_ops.py:108-115`):
x, wr and wi are rounded to bf16 (`bf16_round`) and the products summed
in float32 (the kernel rounds as it loads, the plain version rounds
first), and the backward pass rounds dx, dwr and dwi to bf16 as
`_cdense_bwd` casts its cotangents to the primal dtype
(`pallas_kernels.py:116-119`).

`fir_shift_accum`, the channel's per-row complex FIR over pre-aligned rows
out[b, n] = sum_k h[b, k] xa[b, n + F - 1 - k] (`pallas_kernels.py:141-188`),
which `channel.fir.fir_same_iq` runs on every static-fading frame:

  * `fir_shift_accum_kernel` launches the CUDA kernel
    (`csrc/fir_shift_accum.cu`) on planes on a CUDA device and counts its
    launches in `fir_shift_accum_kernel.launches`;
  * `fir_shift_accum_ref` is the plain version, the shift-and-accumulate
    loop of `fir_same_iq` (`dl_ofdm_tpu/channel/fir.py:160-170`);
  * `fir_shift_accum` is JAX's `fir_shift_accum` on split re/im planes
    and picks one of the two by the tensors' device.  Neither package
    differentiates the channel, so it has no backward pass and the kernel
    refuses inputs that require a gradient.

There is no fallback: a CUDA tensor goes through the kernel, and a failed
build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dl_ofdm_tpu_torch.ops import cuda_build


COMPUTE_DTYPES = (None, "bfloat16", "float32")


def is_bf16(compute_dtype: str | None) -> bool:
    """Whether `compute_dtype` asks for bf16 operands; raises on a dtype
    the port does not know ('float32' computes as None does)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not one of "
                         f"{COMPUTE_DTYPES}")
    return compute_dtype == "bfloat16"


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to bf16 (nearest even) and back to its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def complex_dense_ref(x_iq: torch.Tensor, wr: torch.Tensor,
                      wi: torch.Tensor,
                      compute_dtype: str | None = None) -> torch.Tensor:
    """[..., K, 2] x ([K, F], [K, F]) -> [..., F, 2], plain PyTorch; with
    'bfloat16' the operands are rounded to bf16 first."""
    if is_bf16(compute_dtype):
        x_iq, wr, wi = bf16_round(x_iq), bf16_round(wr), bf16_round(wi)
    xr, xi = x_iq[..., 0], x_iq[..., 1]
    yr = torch.matmul(xr, wr) - torch.matmul(xi, wi)
    yi = torch.matmul(xr, wi) + torch.matmul(xi, wr)
    return torch.stack([yr, yi], dim=-1)


@functools.cache
def _complex_dense_fn():
    fn = cuda_build.load("complex_dense").complex_dense_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# the persistent kernel's layout (csrc/complex_dense.cu), which its plan
# sizes: 64 features a work item, a ring of 3 x tiles of up to 32 rows
# behind 128 bytes of mbarriers, at most 220 KB of shared memory a block;
# past the ring's K, one [32, 192] buffer of x streamed in K chunks
CD_FT, CD_NST, CD_BAR_BYTES = 64, 3, 128
CD_SMEM_BUDGET = 220 * 1024
CD_KC_MAX = 192             # weight rows a block holds (96 KB)
CD_RT_STREAMED = 32         # rows of a tile in the streamed mode


class ComplexDensePlan(NamedTuple):
    rows_per_tile: int
    k_chunk: int            # weight rows staged at once (K when resident)
    stage_elems: int        # IQ pairs a ring stage holds (streamed: the
                            # one buffer's, rows_per_tile x k_chunk)
    smem_bytes: int
    f_tiles: int
    row_tiles: int
    grid: int
    streamed: bool          # x in K chunks, not whole tiles in a ring


@functools.cache
def _cd_stage(k: int) -> tuple[int, int, int, int]:
    """(rows per item, weight rows staged at once, IQ pairs a stage, shared
    bytes) for K = k: the largest of 32..2 rows whose ring of 3 x tiles
    fits beside the weight; past that (K > 2,642), 32-row tiles streamed
    in K chunks through one [32, 192] buffer."""
    kc = min(k, CD_KC_MAX)
    for rt in (32, 16, 8, 4, 2):
        stage = (rt * k + 1) // 2 * 2
        smem = CD_BAR_BYTES + 8 * kc * CD_FT + 8 * CD_NST * stage
        if smem <= CD_SMEM_BUDGET:
            return rt, kc, stage, smem
    stage = CD_RT_STREAMED * kc
    return (CD_RT_STREAMED, kc, stage,
            CD_BAR_BYTES + 8 * kc * CD_FT + 8 * stage)


@functools.lru_cache(maxsize=64)
def complex_dense_plan(m: int, k: int, f: int, sms: int = 132,
                       blocks_per_sm: int = 2) -> ComplexDensePlan:
    """The persistent kernel's plan for x [m, k, 2] and w [k, f] on a card
    of `sms` SMs holding `blocks_per_sm` blocks each: `_cd_stage`'s tile,
    and a grid no larger than the card holds, cut to a multiple of the
    feature tiles so a block keeps its weight."""
    rt, kc, stage, smem = _cd_stage(k)
    f_tiles = -(-f // CD_FT)
    row_tiles = -(-m // rt)
    grid = min(sms * blocks_per_sm, row_tiles * f_tiles)
    if grid >= f_tiles:
        grid -= grid % f_tiles
    return ComplexDensePlan(rt, kc, stage, smem, f_tiles, row_tiles, grid,
                            stage < rt * k)


@functools.cache
def _cd_occupancy(device: int, k_odd: bool, streamed: bool, bf16: bool,
                  smem: int) -> tuple[int, int]:
    """(SMs, blocks a SM holds) of the kernel for K's parity and modes at
    `smem` shared bytes on CUDA device `device`."""
    fn = cuda_build.load("complex_dense").complex_dense_f32_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = fn(int(k_odd), int(streamed), int(bf16), smem, out)
    if err != 0 or out[0] < 1:
        raise RuntimeError(f"complex_dense occupancy query failed: CUDA "
                           f"error {err}, {out[0]} blocks a SM")
    return out[1], out[0]


def complex_dense_launch_plan(m: int, k: int, f: int, device: int,
                              bf16: bool = False) -> ComplexDensePlan:
    """The plan `complex_dense_kernel` launches for x [m, k, 2] and w
    [k, f] (m, k, f > 0) on CUDA device `device`, in the bf16 mode or
    not."""
    rt, _, stage, smem = _cd_stage(k)
    return complex_dense_plan(m, k, f, *_cd_occupancy(
        device, k % 2 == 1, stage < rt * k, bf16, smem))


def complex_dense_kernel(x_iq: torch.Tensor, wr: torch.Tensor,
                         wi: torch.Tensor,
                         compute_dtype: str | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: x [M, K, 2], wr/wi [K, F] -> y [M, F, 2], all
    contiguous float32 on one CUDA device; with 'bfloat16' the kernel
    rounds every operand to bf16 as it reads it.  Raises on anything
    else."""
    bf16 = is_bf16(compute_dtype)
    if not (x_iq.is_cuda and wr.device == x_iq.device
            and wi.device == x_iq.device):
        raise ValueError("complex_dense_kernel: x, wr and wi must be on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in (x_iq, wr, wi)):
        raise TypeError("complex_dense_kernel takes float32 tensors")
    if x_iq.dim() != 3 or x_iq.shape[2] != 2 or wr.dim() != 2 \
            or wr.shape != wi.shape or wr.shape[0] != x_iq.shape[1]:
        raise ValueError(
            f"complex_dense_kernel: shapes x {tuple(x_iq.shape)}, wr "
            f"{tuple(wr.shape)}, wi {tuple(wi.shape)}; want [M, K, 2], "
            "[K, F], [K, F]")
    if not (x_iq.is_contiguous() and wr.is_contiguous()
            and wi.is_contiguous()):
        raise ValueError("complex_dense_kernel takes contiguous tensors")
    if x_iq.data_ptr() % 16:
        raise ValueError("complex_dense_kernel: x must start on a 16-byte "
                         "boundary (its row tiles arrive by bulk copies)")
    m, k, _ = x_iq.shape
    f = wr.shape[1]
    if max(m, k, f) >= 2**31:
        raise ValueError("complex_dense_kernel: sizes overflow int32")
    y = torch.empty(m, f, 2, device=x_iq.device, dtype=torch.float32)
    if m == 0 or f == 0:    # an empty grid is an invalid launch
        return y
    if k == 0:              # an empty sum
        return y.zero_()
    dev = x_iq.device.index
    plan = complex_dense_launch_plan(m, k, f, dev, bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _complex_dense_fn()(x_iq.data_ptr(), wr.data_ptr(),
                                  wi.data_ptr(), y.data_ptr(), m, k, f,
                                  plan.rows_per_tile, plan.k_chunk,
                                  plan.stage_elems, plan.smem_bytes,
                                  plan.grid, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"complex_dense kernel launch failed: CUDA error "
                           f"{err}")
    if bf16:
        complex_dense_kernel.launches_bf16 += 1
    else:
        complex_dense_kernel.launches += 1
    return y


# launches of the float32 mode and of the bf16 mode
complex_dense_kernel.launches = 0
complex_dense_kernel.launches_bf16 = 0


class ComplexDenseFn(torch.autograd.Function):
    """y = x @ (wr + i wi) on [M, K, 2]; the backward pass is `_cdense_bwd`
    (`dl_ofdm_tpu/ops/pallas_kernels.py:108-119`), four real-pair products
    (on the bf16-rounded operands in the bf16 mode, each result rounded to
    bf16)."""

    @staticmethod
    def forward(ctx, x_iq, wr, wi, compute_dtype):
        ctx.save_for_backward(x_iq, wr, wi)
        ctx.bf16 = is_bf16(compute_dtype)
        if x_iq.device.type == "cpu":
            return complex_dense_ref(x_iq, wr, wi, compute_dtype)
        return complex_dense_kernel(x_iq, wr, wi, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x_iq, wr, wi = ctx.saved_tensors
        if ctx.bf16:
            x_iq, wr, wi = bf16_round(x_iq), bf16_round(wr), bf16_round(wi)
        xr, xi = x_iq[..., 0], x_iq[..., 1]
        gr, gi = g[..., 0], g[..., 1]
        dx = torch.stack([gr @ wr.T + gi @ wi.T, -gr @ wi.T + gi @ wr.T],
                         dim=-1)
        dwr = xr.T @ gr + xi.T @ gi
        dwi = xr.T @ gi - xi.T @ gr
        if ctx.bf16:
            dx, dwr, dwi = bf16_round(dx), bf16_round(dwr), bf16_round(dwi)
        return dx, dwr, dwi, None


def complex_dense(x_iq: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                  compute_dtype: str | None = None) -> torch.Tensor:
    """[..., K, 2] x ([K, F], [K, F]) -> [..., F, 2], differentiable: the
    counterpart of JAX's `complex_dense_iq` (fed bf16 operands where
    `compute_dtype` is 'bfloat16')."""
    lead = x_iq.shape[:-2]
    k = x_iq.shape[-2]
    x = x_iq.reshape(-1, k, 2).contiguous()
    if x.is_cuda and x.data_ptr() % 16:    # an offset view: the kernel's
        x = x.clone()                      # bulk copies need 16 bytes
    y = ComplexDenseFn.apply(x, wr, wi, compute_dtype)
    return y.reshape(*lead, wr.shape[1], 2)


# ---------------------------------------------------------------------------
# FIR shift-accumulate: out[b, n] = sum_k h[b, k] * xa[b, n + F - 1 - k]
# ---------------------------------------------------------------------------

def fir_shift_accum_ref(xar: torch.Tensor, xai: torch.Tensor,
                        hr: torch.Tensor, hi: torch.Tensor, l_out: int):
    """Planes xa [B, L+F-1] and taps h [B, F] -> (yr, yi) [B, L], plain
    PyTorch: taps ascending, (acc + sr*hr) - si*hi and (acc + sr*hi) +
    si*hr."""
    f = hr.shape[1]
    out_r = xar.new_zeros(xar.shape[0], l_out)
    out_i = xar.new_zeros(xar.shape[0], l_out)
    for k in range(f):
        s = f - 1 - k
        sr = xar[:, s:s + l_out]
        si = xai[:, s:s + l_out]
        tr = hr[:, k:k + 1]
        ti = hi[:, k:k + 1]
        out_r = out_r + sr * tr - si * ti
        out_i = out_i + sr * ti + si * tr
    return out_r, out_i


class _FirArgs(ctypes.Structure):
    """`FirArgs` of csrc/fir_shift_accum.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p)
                for n in ("xar", "xai", "hr", "hi", "yr", "yi")] + [
        (n, ctypes.c_int) for n in ("B", "L", "F", "tile", "rows", "threads",
                                    "row_stride", "smem", "grid")]


@functools.cache
def _fir_lib():
    lib = cuda_build.load("fir_shift_accum")
    lib.fir_shift_accum_f32.argtypes = [ctypes.POINTER(_FirArgs),
                                        ctypes.c_void_p]
    lib.fir_shift_accum_f32.restype = ctypes.c_int
    lib.fir_shift_accum_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_void_p]
    lib.fir_shift_accum_blocks_per_sm.restype = ctypes.c_int
    return lib


# the kernel's layout (csrc/fir_shift_accum.cu), which its plan sizes: 8
# outputs a thread, rows staged from 8 samples before a unit's first
# output, skewed (sample c at c + c // 8), a ring of two units a block
FIR_V, FIR_PRE, FIR_NBUF = 8, 8, 2
FIR_TILE_MAX = 2048            # outputs of a row a unit takes
FIR_THREADS_MAX = 384
FIR_ROWS_MAX = 64
FIR_SMEM_MAX = 232448          # shared memory a Hopper block can have
FIR_SMEM_TWO = 115712          # what lets two blocks share an SM's 228 KB


class FirPlan(NamedTuple):
    tile: int                  # outputs of a row a unit takes
    rows: int                  # rows a unit takes
    threads: int               # a block's: rows x ceil(tile / 8), to warps
    row_stride: int            # floats of a staged (skewed) row
    smem_bytes: int
    units: int                 # row groups x chunks of a row
    grid: int


def _fir_row_stride(tile: int, f: int) -> int:
    """Floats of one staged row: its samples skewed (c -> c + c // 8), the
    pitch rounded up to 9 G (mod 32) for G = ceil(tile / 8) threads a
    row, so that a warp's loads hit 32 banks."""
    g = -(-tile // FIR_V)
    width = FIR_PRE + FIR_V * g + f - 1
    skewed = width + (width - 1) // 8
    return skewed + (9 * g - skewed) % 32


def _fir_smem(rows: int, row_stride: int, f: int) -> int:
    return FIR_NBUF * 4 * (2 * rows * row_stride + 2 * rows * f)


@functools.lru_cache(maxsize=64)
def fir_plan(b: int, l_out: int, f: int, sms: int = 132,
             blocks_per_sm: int = 2) -> FirPlan:
    """The kernel's plan for B rows of L outputs and F taps on a card of
    `sms` SMs holding `blocks_per_sm` blocks each: the rows a unit takes
    that leave the fewest of a block's threads idle (the most on a tie)
    within 384 threads and half the shared memory, and a grid no larger
    than the card holds.  Raises if one row's unit does not fit a block."""
    tile = min(l_out, FIR_TILE_MAX)
    g = -(-tile // FIR_V)
    stride = _fir_row_stride(tile, f)
    best = None
    for rows in range(1, FIR_ROWS_MAX + 1):
        threads = -(-rows * g // 32) * 32
        smem = _fir_smem(rows, stride, f)
        if threads > FIR_THREADS_MAX or (rows > 1 and smem > FIR_SMEM_TWO):
            break
        key = (rows * g / threads, rows)
        if best is None or key > best[0]:
            best = (key, rows, threads, smem)
    _, rows, threads, smem = best
    if smem > FIR_SMEM_MAX:
        raise ValueError(f"fir_shift_accum_kernel: {f} taps do not fit a "
                         "block's shared memory")
    units = -(-b // rows) * -(-l_out // tile)
    return FirPlan(tile, rows, threads, stride, smem, units,
                   max(1, min(units, sms * blocks_per_sm)))


@functools.cache
def _fir_occupancy(device: int, threads: int, smem: int) -> tuple[int, int]:
    """(SMs, blocks a SM holds) of the kernel at `threads` threads and
    `smem` shared bytes on CUDA device `device`."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = _fir_lib().fir_shift_accum_blocks_per_sm(threads, smem, out)
    if err != 0 or out[0] < 1:
        raise RuntimeError(f"fir_shift_accum occupancy query failed: CUDA "
                           f"error {err}, {out[0]} blocks a SM")
    return out[1], out[0]


def fir_launch_plan(b: int, l_out: int, f: int, device: int) -> FirPlan:
    """The plan `fir_shift_accum_kernel` launches on CUDA device
    `device`."""
    plan = fir_plan(b, l_out, f)
    return fir_plan(b, l_out, f, *_fir_occupancy(device, plan.threads,
                                                 plan.smem_bytes))


def fir_shift_accum_kernel(xar: torch.Tensor, xai: torch.Tensor,
                           hr: torch.Tensor, hi: torch.Tensor, l_out: int):
    """Launch the CUDA kernel: planes xa [B, L+F-1] and taps h [B, F], all
    contiguous float32 on one CUDA device, none requiring a gradient ->
    (yr, yi) [B, L].  Raises on anything else."""
    ts = (xar, xai, hr, hi)
    if not all(t.is_cuda and t.device == xar.device for t in ts):
        raise ValueError("fir_shift_accum_kernel: xa and h planes must be on "
                         "one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("fir_shift_accum_kernel takes float32 tensors")
    if any(t.requires_grad for t in ts):
        raise ValueError("fir_shift_accum_kernel has no backward pass; the "
                         "channel is not differentiated")
    b, f = hr.shape if hr.dim() == 2 else (-1, -1)
    if not (xar.dim() == 2 and xar.shape == xai.shape and hr.shape == hi.shape
            and xar.shape[0] == b and f >= 1 and l_out >= 1
            and xar.shape[1] == l_out + f - 1):
        raise ValueError(
            f"fir_shift_accum_kernel: shapes xa {tuple(xar.shape)}, h "
            f"{tuple(hr.shape)}, l_out {l_out}; want [B, L+F-1] and [B, F]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fir_shift_accum_kernel takes contiguous planes")
    if b * xar.shape[1] >= 2**31 or b * l_out >= 2**31:
        raise ValueError("fir_shift_accum_kernel: sizes overflow int32")
    yr = torch.empty(b, l_out, device=xar.device, dtype=torch.float32)
    yi = torch.empty_like(yr)
    if b == 0:                  # an empty grid is an invalid launch
        return yr, yi
    plan = fir_launch_plan(b, l_out, f, xar.device.index)
    args = _FirArgs(*(t.data_ptr() for t in (xar, xai, hr, hi, yr, yi)),
                    b, l_out, f, plan.tile, plan.rows, plan.threads,
                    plan.row_stride, plan.smem_bytes, plan.grid)
    with torch.cuda.device(xar.device):
        err = _fir_lib().fir_shift_accum_f32(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fir_shift_accum kernel launch failed: CUDA "
                           f"error {err}")
    fir_shift_accum_kernel.launches += 1
    return yr, yi


fir_shift_accum_kernel.launches = 0


def fir_shift_accum(xar: torch.Tensor, xai: torch.Tensor, hr: torch.Tensor,
                    hi: torch.Tensor, l_out: int):
    """(yr, yi) [B, L] from pre-aligned rows xa [B, L+F-1] and kernels
    h [B, F] as re/im planes (alignment is the caller's, see
    `channel.fir.fir_same_iq`): the kernel for planes on a CUDA device,
    the plain version for planes on the CPU."""
    if xar.device.type == "cpu":
        return fir_shift_accum_ref(xar, xai, hr, hi, l_out)
    return fir_shift_accum_kernel(*(t.contiguous() for t in (xar, xai, hr, hi)),
                                  l_out)
