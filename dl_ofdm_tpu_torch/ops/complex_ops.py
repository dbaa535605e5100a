"""Complex-valued dense layer as (re, im) real-pair algebra.

Port of `ComplexDense` in exact mode from `dl_ofdm_tpu/ops/complex_ops.py`
(reference `dev/py/complex.py:140-196`): the reference's "(1, K) complex
convolution" is a complex dense transform K -> F on the second-to-last
axis.  `recombine` selects the imaginary-part convention:

  * 'true'      — im = re*wi + im*wr, the complex product.  On a CUDA device
                  this always runs the hand-written kernel
                  (`ops.pallas_kernels.complex_dense`), the configuration
                  the JAX package selects with `set_use_pallas(True)`;
  * 'reference' — im = re*wi - im*wr, the reference's sign quirk
                  (`complex.py:187-188`), with its shared bias (+b, -b);
                  plain matmuls, as in JAX.

The 'vector' and 'streams' ablation modes, and `use_bias=False` (no caller
in the JAX package), come with a later slice.
"""
from __future__ import annotations

import torch
from torch import nn

from dl_ofdm_tpu_torch.ops.pallas_kernels import complex_dense


class ComplexDense(nn.Module):
    """[..., K, 2] -> [..., F, 2].  Parameters keep the flax names and
    layouts: wr, wi [K, F]; br, bi [F] ('true') or b [F] ('reference')."""

    def __init__(self, in_features: int, features: int,
                 recombine: str = "true"):
        super().__init__()
        if recombine not in ("true", "reference"):
            raise ValueError(f"Unknown recombine {recombine!r}")
        self.recombine = recombine
        self.wr = nn.Parameter(torch.empty(in_features, features))
        self.wi = nn.Parameter(torch.empty(in_features, features))
        # flax's lecun_normal: a normal truncated at 2 std, fan-in variance
        std = (1.0 / in_features) ** 0.5 / 0.87962566
        for w in (self.wr, self.wi):
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
        for name in ("br", "bi") if recombine == "true" else ("b",):
            self.register_parameter(name, nn.Parameter(torch.zeros(features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 2:
            raise ValueError("ComplexDense expects IQ-last input [..., K, 2]")
        if self.recombine == "true":
            y = complex_dense(x, self.wr, self.wi)
            return y + torch.stack([self.br, self.bi], dim=-1)
        xr, xi = x[..., 0], x[..., 1]
        yr = xr @ self.wr - xi @ self.wi
        yi = xr @ self.wi - xi @ self.wr
        return torch.stack([yr + self.b, yi - self.b], dim=-1)
