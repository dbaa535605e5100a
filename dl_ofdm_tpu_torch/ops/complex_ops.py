"""Complex-valued NN layers as (re, im) real-pair algebra.

Port of `dl_ofdm_tpu/ops/complex_ops.py` (reference `dev/py/complex.py`):
`ComplexDense`, `ComplexConv2d` and `ComplexConvTranspose2d`.  The
reference's "(1, K) complex convolution" is a complex dense transform
K -> F on the second-to-last axis.  Layer modes:

  * 'exact'   — complex arithmetic; `recombine` selects the imaginary part:
      - 'true'      — im = re*wi + im*wr, the complex product.  In
                      `ComplexDense` on a CUDA device this always runs the
                      hand-written kernel (`ops.pallas_kernels.complex_dense`),
                      the configuration the JAX package selects with
                      `set_use_pallas(True)`;
      - 'reference' — im = re*wi - im*wr, the reference's sign quirk
                      (`complex.py:187-188`), with its shared bias (+b, -b);
  * 'vector'  — an unconstrained real map of the stacked (re, im) planes
                (`complex.py:199-255`): one weight `w`, one bias `b`;
  * 'streams' — independent real maps of re and im (`complex.py:258-356`).

`ComplexDense(compute_dtype='bfloat16')` feeds its products bf16 operands
with float32 sums and output, as JAX's (`complex_ops.py:108-115`): the
'exact' 'true' layer passes the flag to the kernel; 'exact' 'reference'
runs `torch.matmul` on bf16-rounded operands (exact products, float32
sums) and rounds each product's gradients to bf16, as the `astype` VJP
does; 'vector' and 'streams' ignore it, as JAX's do (`:155-170`).

Parameters keep the flax names and layouts, so
`train.checkpoint.params_from_flax` maps a flax tree onto `state_dict()`
keys one to one: dense weights [K, F] (vector [2K, 2F]), convolution
weights HWIO [kh, kw, C, F] (permuted to PyTorch's OIHW inside `forward`).
Both convolutions pad as XLA does ('same' puts the odd pixel after; the
transposed convolution dilates its input by the strides, pads by JAX's
`_conv_transpose_padding` and does not flip the kernel).  A
`ComplexConv2d` of one channel in and one out with 'same' padding (the
equalizers' block, cascade and refinement convolutions) runs on a CUDA
device through the hand-written kernels of `ops/complex_conv2d.py`
(forward, input gradient, a deterministic weight gradient), fed the one
real 2-in/2-out tap a position that every mode comes to (`tap_weight`,
`tap_bias`); on the CPU, and for every other convolution (more channels,
'valid', the transposed one), the layers run as `F.conv2d`, as the JAX
package leaves them to XLA.  Both paths compute in full float32: cuDNN's
TF32 is off in the forward and in both gradients (`conv2d_float32`), as
the port's products are (`ops/cfloat.py`), and the kernels use the CUDA
cores' float32 FMA.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

# the complex-pair primitives live in ops.cfloat; the layer module's public
# names alias them (`complex_ops.py:74-76`)
from dl_ofdm_tpu_torch.ops.cfloat import (  # noqa: F401
    cmul_iq as complex_mul, from_complex as complex_to_iq,
    to_complex as iq_to_complex)
from dl_ofdm_tpu_torch.ops.complex_conv2d import complex_conv2d, same_pads
from dl_ofdm_tpu_torch.ops.pallas_kernels import (bf16_round, complex_dense,
                                                  is_bf16)

MODES = ("exact", "vector", "streams")


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's `lecun_normal` in place: a normal truncated at 2 std, scaled
    so that the truncated draw has variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def _bias_names(mode: str, recombine: str, use_bias: bool) -> tuple:
    if not use_bias:
        return ()
    if mode == "vector" or (mode == "exact" and recombine == "reference"):
        return ("b",)
    return ("br", "bi")


class _ComplexLayer(nn.Module):
    """Weights and biases by flax's names; `reset_parameters` draws the
    weights with flax's `lecun_normal` (fan-in: every axis but the last)
    and zeroes the biases."""

    def _make(self, mode, recombine, use_bias, w_shape, f):
        if mode not in MODES:
            raise ValueError(f"Unknown mode {mode!r}")
        if recombine not in ("true", "reference"):
            raise ValueError(f"Unknown recombine {recombine!r}")
        self.mode, self.recombine, self.use_bias = mode, recombine, use_bias
        if mode == "vector":
            w_shape = w_shape[:-2] + (2 * w_shape[-2], 2 * w_shape[-1])
            self.w = nn.Parameter(torch.empty(w_shape))
        else:
            self.wr = nn.Parameter(torch.empty(w_shape))
            self.wi = nn.Parameter(torch.empty(w_shape))
        self._biases = _bias_names(mode, recombine, use_bias)
        for name in self._biases:
            n = 2 * f if mode == "vector" else f
            self.register_parameter(name, nn.Parameter(torch.zeros(n)))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        for name in ("w",) if self.mode == "vector" else ("wr", "wi"):
            w = getattr(self, name)
            lecun_normal_(w, w.numel() // w.shape[-1], generator)
        for name in self._biases:
            nn.init.zeros_(getattr(self, name))

    def _recombine(self, op, xr, xi):
        """(yr, yi) from a real linear `op(x, w)` of each plane."""
        if self.mode == "vector":
            y = op(torch.cat([xr, xi], dim=-1), self.w)
            if self.use_bias:
                y = y + self.b
            f = y.shape[-1] // 2
            return y[..., :f], y[..., f:]
        if self.mode == "streams":
            yr, yi = op(xr, self.wr), op(xi, self.wi)
        else:
            yr = op(xr, self.wr) - op(xi, self.wi)
            if self.recombine == "true":
                yi = op(xr, self.wi) + op(xi, self.wr)
            else:
                yi = op(xr, self.wi) - op(xi, self.wr)
        if not self.use_bias:
            return yr, yi
        if self._biases == ("b",):
            return yr + self.b, yi - self.b
        return yr + self.br, yi + self.bi


class _Bf16Round(torch.autograd.Function):
    """`bf16_round` whose gradient is rounded to bf16 too: a float32 value
    cast to bf16 for one product, with the cast's VJP."""

    @staticmethod
    def forward(ctx, t):
        return bf16_round(t)

    @staticmethod
    def backward(ctx, g):
        return bf16_round(g)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """JAX's `matmul(a.astype(bf16), b.astype(bf16),
    preferred_element_type=float32)` in float32: operands rounded to bf16
    (exact products, float32 sums), each operand's gradient rounded to
    bf16."""
    return torch.matmul(_Bf16Round.apply(a), _Bf16Round.apply(b))


class ComplexDense(_ComplexLayer):
    """[..., K, 2] -> [..., F, 2].  Parameters: wr, wi [K, F] with br, bi
    [F] ('exact' 'true', 'streams') or b [F] ('exact' 'reference');
    w [2K, 2F] and b [2F] ('vector').  `compute_dtype`: None, 'float32'
    (the same) or 'bfloat16' (see the module note)."""

    def __init__(self, in_features: int, features: int, mode: str = "exact",
                 recombine: str = "true", use_bias: bool = True,
                 compute_dtype: str | None = None):
        super().__init__()
        self.bf16 = is_bf16(compute_dtype)
        self.compute_dtype = compute_dtype
        self._make(mode, recombine, use_bias, (in_features, features),
                   features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 2:
            raise ValueError("ComplexDense expects IQ-last input [..., K, 2]")
        if self.mode == "exact" and self.recombine == "true":
            y = complex_dense(x, self.wr, self.wi, self.compute_dtype)
            if self.use_bias:
                y = y + torch.stack([self.br, self.bi], dim=-1)
            return y
        mm = (bf16_matmul if self.bf16 and self.mode == "exact"
              else torch.matmul)
        yr, yi = self._recombine(mm, x[..., 0], x[..., 1])
        return torch.stack([yr, yi], dim=-1)


def conv_transpose_pads(k: int, s: int, padding: str) -> tuple[int, int]:
    """JAX's `_conv_transpose_padding` for one axis: (before, after)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"Invalid padding mode: {padding!r}")
    return pad_a, pad_len - pad_a


@contextlib.contextmanager
def _cudnn_without_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv2dFloat32(torch.autograd.Function):
    """`F.conv2d(x, w)` with cuDNN's TF32 off in the forward and in the
    backward's products, which autograd would run later under whatever
    setting the caller then has (`torch.backends.cudnn.allow_tf32` is True
    by default)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _cudnn_without_tf32():
            return F.conv2d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _cudnn_without_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw


def conv2d_float32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Real 2D convolution, NCHW x OIHW, stride 1, no padding, every
    product in float32 (see the module note)."""
    return _Conv2dFloat32.apply(x, w)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                padding: str) -> torch.Tensor:
    """Real 2D convolution, NHWC x HWIO -> NHWC, stride 1, XLA's padding
    (`complex_ops.py:_conv2d`)."""
    padding = padding.upper()
    xn = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(xn.shape[2], w.shape[0]),
                          same_pads(xn.shape[3], w.shape[1]))
        xn = F.pad(xn, (l, r, t, b))
    elif padding != "VALID":
        raise ValueError(f"Invalid padding mode: {padding!r}")
    return conv2d_float32(xn, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def conv_transpose2d_nhwc(x: torch.Tensor, w: torch.Tensor, strides,
                          padding: str) -> torch.Tensor:
    """`jax.lax.conv_transpose(x, w, strides, padding,
    ('NHWC', 'HWIO', 'NHWC'))` with `transpose_kernel=False`: a stride-1
    convolution of the input dilated by `strides`, padded by JAX's rule,
    with the kernel as it is (not flipped)."""
    padding = padding.upper()
    sh, sw = strides
    kh, kw = w.shape[0], w.shape[1]
    xn = x.permute(0, 3, 1, 2)
    if (sh, sw) != (1, 1):
        b, c, h, wd = xn.shape
        xd = xn.new_zeros(b, c, (h - 1) * sh + 1, (wd - 1) * sw + 1)
        xd[:, :, ::sh, ::sw] = xn
        xn = xd
    (t, bt), (l, r) = (conv_transpose_pads(kh, sh, padding),
                       conv_transpose_pads(kw, sw, padding))
    xn = F.pad(xn, (l, r, t, bt))
    return conv2d_float32(xn, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def _split_channels(x: torch.Tensor):
    """[B, S, K, C, 2] or [B, S, K, 2] -> (xr, xi) [B, S, K, C], squeeze."""
    if x.dim() == 4:
        return x[..., None, 0], x[..., None, 1], True
    return x[..., 0], x[..., 1], False


class ComplexConv2d(_ComplexLayer):
    """Complex 2D convolution over the (symbol, subcarrier) axes,
    [B, S, K, C, 2] -> [B, S', K', F, 2] (a [B, S, K, 2] input is one
    channel, and with F == 1 the channel axis is dropped again).  Weights
    HWIO: wr, wi [kh, kw, C, F]; vector w [kh, kw, 2C, 2F]."""

    def __init__(self, in_channels: int, features: int, kernel,
                 padding: str = "same", mode: str = "exact",
                 recombine: str = "true", use_bias: bool = True):
        super().__init__()
        self.kernel, self.padding = tuple(kernel), padding
        self._make(mode, recombine, use_bias,
                   (*self.kernel, in_channels, features), features)

    def tap_weight(self) -> torch.Tensor:
        """[kh, kw, 2, 2]: each position's real map of (re, im) in to
        (re, im) out, W[a, b, ci, co], of a one-channel layer."""
        if self.mode == "vector":
            return self.w
        wr, wi = self.wr[:, :, 0, 0], self.wi[:, :, 0, 0]
        zero = torch.zeros_like(wr)
        if self.mode == "streams":
            rows = ((wr, zero), (zero, wi))
        elif self.recombine == "true":
            rows = ((wr, wi), (-wi, wr))
        else:
            rows = ((wr, wi), (-wi, -wr))
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    def tap_bias(self) -> torch.Tensor | None:
        """[2]: the bias of the re and im outputs, or None."""
        if not self.use_bias:
            return None
        if self.mode == "vector":
            return self.b
        if self._biases == ("b",):
            return torch.cat([self.b, -self.b])
        return torch.cat([self.br, self.bi])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        vector = self.mode == "vector"
        one = (self.w if vector else self.wr).shape[2:] == (
            (2, 2) if vector else (1, 1))
        if x.is_cuda and one and self.padding.upper() == "SAME":
            y = complex_conv2d(x.reshape(*x.shape[:3], 2), self.tap_weight(),
                               self.tap_bias())
            return y.reshape(x.shape)
        xr, xi, squeeze = _split_channels(x)
        yr, yi = self._recombine(
            lambda v, w: conv2d_nhwc(v, w, self.padding), xr, xi)
        out = torch.stack([yr, yi], dim=-1)
        if squeeze and out.shape[3] == 1:
            out = out[:, :, :, 0, :]
        return out


class ComplexConvTranspose2d(_ComplexLayer):
    """Complex transposed 2D convolution (reference
    `layers_conv2d_transpose_complex`, `dev/py/complex.py:95-136,359-415`),
    [B, S, K, C, 2] or [B, S, K, 2] in; weights wr, wi [kh, kw, C, F],
    biases br, bi [F]."""

    def __init__(self, in_channels: int, features: int, kernel,
                 strides=(1, 1), padding: str = "same",
                 use_bias: bool = True):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.padding = padding
        self._make("exact", "true", use_bias,
                   (*self.kernel, in_channels, features), features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xr, xi, squeeze = _split_channels(x)
        yr, yi = self._recombine(
            lambda v, w: conv_transpose2d_nhwc(v, w, self.strides,
                                               self.padding), xr, xi)
        out = torch.stack([yr, yi], dim=-1)
        if squeeze and out.shape[3] == 1:
            out = out[:, :, :, 0, :]
        return out
