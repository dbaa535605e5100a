"""Normalization and activation with reference-exact semantics.

Port of `dl_ofdm_tpu/ops/norms.py` (`frame_layer_norm`, `batch_norm_ref`,
`leaky_relu`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def frame_layer_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-example layer norm over every non-batch axis, no learned affine
    (`tf.contrib.layers.layer_norm(x, center=False, scale=False,
    begin_norm_axis=1)`, reference `dev/py/model.py:363`): the population
    variance, as `jnp.var` takes it."""
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              eps: float = 1e-9) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) / sqrt(2): the receiver's input
    normalization with given moments."""
    return (x - mean) * torch.rsqrt(var + eps) / math.sqrt(2.0)


def batch_norm_ref(x: torch.Tensor, eps: float = 1e-9,
                   group_onehot: torch.Tensor | None = None) -> torch.Tensor:
    """The reference receiver's input normalization (`ofdmreceiver_np.py:128-129`):
    batch moments over axis 0 (per position), normalize, then divide by
    sqrt(2).

    `group_onehot` [B, G]: the moments per frame-group instead of over the
    whole batch (the interleaved-SNR sweep), with the JAX module's one-pass
    variance E[x^2] - E[x]^2."""
    if group_onehot is None:
        mean = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, unbiased=False, keepdim=True)
        return normalize(x, mean, var, eps)
    counts = group_onehot.sum(dim=0)                          # [G]
    flat = x.reshape(x.shape[0], -1)                          # [B, P]
    g_mean = (group_onehot.T @ flat) / counts[:, None]        # [G, P]
    g_var = (group_onehot.T @ (flat * flat)) / counts[:, None] - g_mean**2
    mean = (group_onehot @ g_mean).reshape(x.shape)
    var = (group_onehot @ g_var).reshape(x.shape)
    return normalize(x, mean, var, eps)


# 0.2 rounded to bf16, the slope `jax.nn.leaky_relu` multiplies a bf16
# array by (its weakly typed `negative_slope * x` takes the array's dtype)
SLOPE_BF16 = 0.2001953125


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """TF-default leaky relu: slope 0.2 (torch's default is 0.01).  On a
    bf16 tensor, `where(x >= 0, x, bf16(0.2) * x)` with the product rounded
    once to bf16, as JAX computes it (the product of two bf16 values is
    exact in float32)."""
    if x.dtype == torch.bfloat16:
        return torch.where(x >= 0, x, x * SLOPE_BF16)
    return F.leaky_relu(x, negative_slope=0.2)
