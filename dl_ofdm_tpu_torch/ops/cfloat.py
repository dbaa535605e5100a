"""Real-pair complex arithmetic and matmul DFTs.

Port of `dl_ofdm_tpu/ops/cfloat.py`.  Complex data is a trailing axis of
size 2 holding (re, im) in float32, and the DFT is a product with cached
cos/sin matrices, as in the JAX package.  The products run in full float32:
the port leaves `torch.backends.cuda.matmul.allow_tf32` at its default
(False), which the JAX module asks for with `default_matmul_precision`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def cmul_iq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


@functools.lru_cache(maxsize=None)
def _dft_mats_np(k_in: int, n_out: int, inverse: bool):
    """cos/sin matrices for X[m] = sum_t x[t] e^(-+ 2*pi*i*t*m / n_out)."""
    t = np.arange(k_in)[:, None]
    m = np.arange(n_out)[None, :]
    theta = 2 * np.pi * t * m / n_out
    c = np.cos(theta)
    s = np.sin(theta)
    if inverse:
        c, s = c / n_out, s / n_out
    return (np.asarray(c, np.float32), np.asarray(s, np.float32))


def _dft_mats(k_in: int, n_out: int, inverse: bool, device):
    c, s = _dft_mats_np(k_in, n_out, inverse)
    return (torch.from_numpy(c).to(device), torch.from_numpy(s).to(device))


def dft_iq(x: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """DFT along the second-to-last axis of an IQ tensor [..., K, 2]
    (np.fft.fft(x_complex, n=n_out) parity for K <= n_out)."""
    k = x.shape[-2]
    c, s = _dft_mats(k, n_out or k, False, x.device)
    xr, xi = x[..., 0], x[..., 1]
    # e^{-i theta}: Xr = xr.c + xi.s ; Xi = xi.c - xr.s
    return torch.stack([xr @ c + xi @ s, xi @ c - xr @ s], dim=-1)


def idft_iq(x: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """Inverse DFT along the second-to-last axis (np.fft.ifft parity,
    including the 1/N normalization)."""
    k = x.shape[-2]
    c, s = _dft_mats(k, n_out or k, True, x.device)
    xr, xi = x[..., 0], x[..., 1]
    # e^{+i theta}/N: yr = xr.c - xi.s ; yi = xr.s + xi.c
    return torch.stack([xr @ c - xi @ s, xr @ s + xi @ c], dim=-1)
