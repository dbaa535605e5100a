"""The equalizers' one-channel complex convolution on the card
(`csrc/complex_conv2d.cu`): `ComplexConv2d(1, 1, (kh, kw),
padding="same")` over the (symbol, subcarrier) map, forward and both
gradients, in float32 on the CUDA cores.

Every mode of the layer is one real 2-in/2-out tap a kernel position,
w [kh, kw, 2, 2] (W[a, b, ci, co]: input plane ci to output plane co), and
one bias [2], which `ComplexConv2d.tap_weight` / `.tap_bias` build from
the layer's parameters; x and y are IQ-last [B, S, K, 2].  The pads are
XLA's 'same' at stride 1 (`same_pads`): (kh - 1) // 2 rows
and (kw - 1) // 2 columns before, the odd one after.

  * `complex_conv2d` is the autograd function: on a CUDA tensor the
    kernels (the forward, the input gradient as the same kernel with the
    taps flipped, each 2x2 transposed and the pads swapped, the weight and
    bias gradients as a second kernel whose blocks' partials a third
    launch adds in block order, so a repeat is bit for bit); on a CPU
    tensor the plain versions, with the same autograd wiring;
  * `complex_conv2d_kernel` launches the forward / input-gradient kernel,
    `complex_conv2d_wgrad_kernel` the gradients' two; both count their
    launches in `complex_conv2d_kernel.launches` (and by pass in
    `.launches_fwd`, `.launches_dgrad`, `.launches_wgrad`);
  * `complex_conv2d_ref` and `complex_conv2d_wgrad_ref` are the plain
    versions: the kernels' taps in PyTorch operations, what the tests and
    `chip_smoke.py` hold the kernels to;
  * `fwd_plan` and `wgrad_plan` are the launch plans (frames a block,
    shared bytes, grids), made here and checked by the source.

A kernel takes S <= 8 rows and a layout that fits a block's shared memory
(at K = kw: up to ~1,024 subcarriers); it raises on anything else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dl_ofdm_tpu_torch.ops import cuda_build

# the source's THREADS, MAX_S and SMEM_MAX
THREADS, MAX_S, SMEM_MAX = 256, 8, 232448
WARPS = THREADS // 32
FWD_BLOCKS_PER_SM = 3         # the forward's frames a block: 3 blocks fit
WGRAD_BLOCKS_PER_SM = 2       # the weight gradient's grid: 2 blocks a SM


def same_pads(size: int, k: int, stride: int = 1) -> tuple[int, int]:
    """XLA's 'SAME' padding of one axis: (before, after), the odd pixel
    after (`jax.lax.padtype_to_pads`)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def reach(pt: int, s: int, kh: int) -> tuple[int, int]:
    """Tap rows [lo, hi) that touch a map of s rows padded by pt before."""
    return max(0, pt - (s - 1)), min(kh, pt + s)


class FwdPlan(NamedTuple):
    frames: int               # frames a block
    smem: int                 # dynamic shared bytes
    grid: int


class WgradPlan(NamedTuple):
    frames: int               # frames staged at a time (one a frame slot)
    chunks: int               # tap chunks of 32 columns a block
    grid_x: int               # blocks along the frames
    grid_y: int               # blocks along the tap chunks
    smem: int
    sum_grid: int             # blocks of the partials' sum


def fwd_plan(b: int, s: int, k: int, kh: int, kw: int, pt: int) -> FwdPlan:
    """The forward's (and the input gradient's) plan: the most frames a
    block (8, 4, 2 or 1) at which FWD_BLOCKS_PER_SM blocks fit a SM, the
    taps in reach and the frames' zero-padded rows in shared memory."""
    if not 1 <= s <= MAX_S:
        raise ValueError(f"complex_conv2d_kernel takes 1 to {MAX_S} rows, "
                         f"not {s}")
    lo, hi = reach(pt, s, kh)
    for frames in (8, 4, 2, 1):
        smem = 16 * (hi - lo) * kw + 8 * frames * s * (k + kw - 1)
        if smem <= SMEM_MAX // FWD_BLOCKS_PER_SM:
            break
    if smem > SMEM_MAX:
        raise ValueError(f"complex_conv2d_kernel: a ({kh}, {kw}) kernel "
                         f"over {s} x {k} does not fit a block's shared "
                         "memory")
    return FwdPlan(frames, smem, -(-b // frames))


def wgrad_plan(b: int, s: int, k: int, kh: int, kw: int,
               sms: int) -> WgradPlan:
    """The weight gradient's plan: each warp one tap chunk (32 columns) and
    one frame slot, as many chunks a block as divide its warps and are
    there; a fixed split of the frames over WGRAD_BLOCKS_PER_SM blocks a
    SM, so a repeat on the same card sums in the same order."""
    if not 1 <= s <= MAX_S:
        raise ValueError(f"complex_conv2d_wgrad_kernel takes 1 to {MAX_S} "
                         f"rows, not {s}")
    tap_chunks = -(-kw // 32)
    chunks = max(c for c in (1, 2, 4, 8) if c <= min(tap_chunks, WARPS))
    frames = WARPS // chunks
    tiles = 8 * frames * s * (2 * k + kw - 1)
    smem = max(tiles, 16 * WARPS * 32 * (2 * s - 1) + 8 * WARPS)
    if smem > SMEM_MAX:
        raise ValueError(f"complex_conv2d_wgrad_kernel: a ({kh}, {kw}) "
                         f"kernel over {s} x {k} does not fit a block's "
                         "shared memory")
    grid_x = max(1, min(-(-b // frames), WGRAD_BLOCKS_PER_SM * sms))
    return WgradPlan(frames, chunks, grid_x, -(-tap_chunks // chunks), smem,
                     -(-(kh * kw * 4 + 2) // 32))


def partial_stride(kh: int, kw: int) -> int:
    """Floats a block's partials take: dW's, then db's two, 16-byte
    aligned."""
    return kh * kw * 4 + 4


def _flipped(w: torch.Tensor) -> torch.Tensor:
    """The input gradient's taps: flipped in both axes, each 2x2
    transposed."""
    return w.flip(0, 1).transpose(2, 3)


def complex_conv2d_ref(x: torch.Tensor, w: torch.Tensor,
                       bias: torch.Tensor | None = None,
                       flip: bool = False) -> torch.Tensor:
    """The kernel's forward in PyTorch operations: x [B, S, K, 2] padded as
    'same', each tap in reach of the map a [2, 2] product summed in tap
    order, then the bias.  `flip`: the input gradient's form (taps
    `_flipped`, pads swapped), with x the output's gradient."""
    s, k = x.shape[1], x.shape[2]
    kh, kw = w.shape[0], w.shape[1]
    (pt, pb), (pl, pr) = same_pads(s, kh), same_pads(k, kw)
    if flip:
        (pt, pb), (pl, pr), w = (pb, pt), (pr, pl), _flipped(w)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    y = torch.zeros_like(x)
    for a in range(*reach(pt, s, kh)):
        for b in range(*reach(pl, k, kw)):
            y = y + torch.matmul(xp[:, a:a + s, b:b + k], w[a, b])
    return y if bias is None else y + bias


def complex_conv2d_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, kh: int,
                             kw: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients' kernels in PyTorch operations: dW [kh, kw, 2, 2], each
    tap in reach the sum over frames and positions of the padded input's
    window times dy (zero elsewhere), and db [2] the sum of dy."""
    s, k = x.shape[1], x.shape[2]
    (pt, pb), (pl, pr) = same_pads(s, kh), same_pads(k, kw)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    dw = x.new_zeros(kh, kw, 2, 2)
    for a in range(*reach(pt, s, kh)):
        for b in range(*reach(pl, k, kw)):
            dw[a, b] = torch.einsum("nskc,nskd->cd", xp[:, a:a + s, b:b + k],
                                    dy)
    return dw, dy.sum(dim=(0, 1, 2))


class _ConvArgs(ctypes.Structure):
    """`ConvArgs` of csrc/complex_conv2d.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "w", "bias", "y")]
                + [(n, ctypes.c_int) for n in (
                    "B", "S", "K", "kh", "kw", "pt", "pl", "flip", "frames",
                    "smem", "grid")])


class _WgradArgs(ctypes.Structure):
    """`WgradArgs` of csrc/complex_conv2d.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "dy", "partials", "dw",
                                                "db")]
                + [(n, ctypes.c_int) for n in (
                    "B", "S", "K", "kh", "kw", "pt", "pl", "frames",
                    "chunks", "grid_x", "grid_y", "smem", "sum_grid")])


@functools.cache
def _lib():
    lib = cuda_build.load("complex_conv2d")
    lib.complex_conv2d_fwd.argtypes = [ctypes.POINTER(_ConvArgs),
                                       ctypes.c_void_p]
    lib.complex_conv2d_wgrad.argtypes = [ctypes.POINTER(_WgradArgs),
                                         ctypes.c_void_p]
    lib.complex_conv2d_fwd.restype = lib.complex_conv2d_wgrad.restype = \
        ctypes.c_int
    return lib


@functools.cache
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, maps, w: torch.Tensor | None = None,
           bias: torch.Tensor | None = None) -> None:
    """Raise unless every map is a contiguous float32 [B, S, K, 2] of one
    shape on one CUDA device with w [kh, kw, 2, 2] and bias [2] beside
    them."""
    x = maps[0]
    ts = [t for t in (*maps, w, bias) if t is not None]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"{name}: tensors must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name} takes float32 tensors")
    if not (x.dim() == 4 and x.shape[-1] == 2 and x.shape[0] >= 1
            and all(t.shape == x.shape for t in maps)):
        raise ValueError(f"{name}: maps {[tuple(t.shape) for t in maps]}; "
                         "want [B, S, K, 2] alike")
    if w is not None and not (w.dim() == 4 and w.shape[2:] == (2, 2)):
        raise ValueError(f"{name}: taps {tuple(w.shape)}; want "
                         "[kh, kw, 2, 2]")
    if bias is not None and bias.shape != (2,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)}; want [2]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    if x.numel() // 2 >= 2 ** 30:
        raise ValueError(f"{name}: sizes overflow int32")


def complex_conv2d_kernel(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          flip: bool = False) -> torch.Tensor:
    """Launch the forward kernel, or with `flip` the input gradient (x the
    output's gradient, no bias): x [B, S, K, 2], w [kh, kw, 2, 2], bias [2]
    or None, contiguous float32 on one CUDA device -> y [B, S, K, 2].
    Raises on anything else."""
    _check("complex_conv2d_kernel", [x], w, bias)
    b, s, k, _ = x.shape
    kh, kw = w.shape[0], w.shape[1]
    (pt, pb), (pl, pr) = same_pads(s, kh), same_pads(k, kw)
    if flip:
        pt, pl = pb, pr
    plan = fwd_plan(b, s, k, kh, kw, pt)
    y = torch.empty_like(x)
    args = _ConvArgs(x.data_ptr(), w.data_ptr(),
                     None if bias is None else bias.data_ptr(), y.data_ptr(),
                     b, s, k, kh, kw, pt, pl, int(flip), plan.frames,
                     plan.smem, plan.grid)
    with torch.cuda.device(x.device):
        err = _lib().complex_conv2d_fwd(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"complex_conv2d kernel launch failed: CUDA "
                           f"error {err}")
    complex_conv2d_kernel.launches += 1
    if flip:
        complex_conv2d_kernel.launches_dgrad += 1
    else:
        complex_conv2d_kernel.launches_fwd += 1
    return y


def complex_conv2d_wgrad_kernel(x: torch.Tensor, dy: torch.Tensor, kh: int,
                                kw: int, with_bias: bool = True):
    """Launch the weight gradient's two kernels (the blocks' partials, their
    sum in block order): x and dy [B, S, K, 2] contiguous float32 on one
    CUDA device -> (dW [kh, kw, 2, 2], db [2] or None)."""
    _check("complex_conv2d_wgrad_kernel", [x, dy])
    b, s, k, _ = x.shape
    pt, pl = same_pads(s, kh)[0], same_pads(k, kw)[0]
    plan = wgrad_plan(b, s, k, kh, kw, _sms(x.device.index))
    partials = torch.empty(plan.grid_x * partial_stride(kh, kw),
                           device=x.device)
    dw = torch.empty(kh, kw, 2, 2, device=x.device)
    db = torch.empty(2, device=x.device) if with_bias else None
    args = _WgradArgs(x.data_ptr(), dy.data_ptr(), partials.data_ptr(),
                      dw.data_ptr(), None if db is None else db.data_ptr(),
                      b, s, k, kh, kw, pt, pl, plan.frames, plan.chunks,
                      plan.grid_x, plan.grid_y, plan.smem, plan.sum_grid)
    with torch.cuda.device(x.device):
        err = _lib().complex_conv2d_wgrad(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"complex_conv2d weight-gradient launch failed: "
                           f"CUDA error {err}")
    complex_conv2d_kernel.launches += 2
    complex_conv2d_kernel.launches_wgrad += 2
    return dw, db


complex_conv2d_kernel.launches = 0
complex_conv2d_kernel.launches_fwd = 0
complex_conv2d_kernel.launches_dgrad = 0
complex_conv2d_kernel.launches_wgrad = 0


class _Conv(torch.autograd.Function):
    """The kernels on a CUDA tensor, the plain versions on a CPU one."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.with_bias = bias is not None
        if x.is_cuda:
            return complex_conv2d_kernel(x, w, bias)
        return complex_conv2d_ref(x, w, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.contiguous()
        kh, kw = w.shape[0], w.shape[1]
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = (complex_conv2d_kernel(gy, w, flip=True) if gy.is_cuda
                  else complex_conv2d_ref(gy, w, flip=True))
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            if gy.is_cuda:
                gw, gb = complex_conv2d_wgrad_kernel(x, gy, kh, kw,
                                                     ctx.with_bias)
            else:
                gw, gb = complex_conv2d_wgrad_ref(x, gy, kh, kw)
        return gx, gw, gb if ctx.needs_input_grad[2] else None


def complex_conv2d(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """y [B, S, K, 2] = the 'same' convolution of x [B, S, K, 2] with taps
    w [kh, kw, 2, 2], plus bias [2] (or none), differentiable in all
    three: on a CUDA tensor through the kernels (contiguous copies of x
    and w are made where they are not), on a CPU one through the plain
    versions."""
    return _Conv.apply(x.contiguous(), w.contiguous(),
                       None if bias is None else bias.contiguous())
