"""Real-pair complex arithmetic and matmul DFTs.

Port of `dl_ofdm_tpu/ops/cfloat.py`.  Complex data is a trailing axis of
size 2 holding (re, im) in float32, and the DFT is a product with cached
cos/sin matrices, as in the JAX package.  The products run in full float32:
the port leaves `torch.backends.cuda.matmul.allow_tf32` at its default
(False), which the JAX module asks for with `default_matmul_precision`.
The DFT matrices are made once per size and device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def conj_iq(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 0], -x[..., 1]], dim=-1)


def abs2_iq(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] ** 2 + x[..., 1] ** 2


def abs_iq(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return torch.sqrt(abs2_iq(x) + eps)


def cmul_iq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def to_complex(x: torch.Tensor) -> torch.Tensor:
    """IQ pair [..., 2] -> complex64 [...] (CPU/tests only: the port keeps
    complex data IQ-last on its paths)."""
    return torch.complex(x[..., 0].to(torch.float32),
                         x[..., 1].to(torch.float32))


def from_complex(x: torch.Tensor) -> torch.Tensor:
    """Complex [...] -> float32 IQ pairs [..., 2]."""
    return torch.stack([x.real.to(torch.float32),
                        x.imag.to(torch.float32)], dim=-1)


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


@functools.lru_cache(maxsize=None)
def _dft_mats(k_in: int, n_out: int, inverse: bool, device: torch.device,
              dtype: torch.dtype = torch.float32):
    """The cos/sin matrices on `device` in `dtype` (from their float32
    values, as JAX promotes them), copied there once: a copy from the host
    waits for the card, which the classical receiver's batch loop would
    pay several times a batch."""
    return tuple(torch.from_numpy(m).to(device=device, dtype=dtype)
                 for m in _dft_mats_np(k_in, n_out, inverse))


def dft_iq(x: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """DFT along the second-to-last axis of an IQ tensor [..., K, 2]
    (np.fft.fft(x_complex, n=n_out) parity for K <= n_out)."""
    k = x.shape[-2]
    c, s = _dft_mats(k, n_out or k, False, x.device, x.dtype)
    xr, xi = x[..., 0], x[..., 1]
    # e^{-i theta}: Xr = xr.c + xi.s ; Xi = xi.c - xr.s
    return torch.stack([xr @ c + xi @ s, xi @ c - xr @ s], dim=-1)


def idft_iq(x: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """Inverse DFT along the second-to-last axis (np.fft.ifft parity,
    including the 1/N normalization)."""
    k = x.shape[-2]
    c, s = _dft_mats(k, n_out or k, True, x.device, x.dtype)
    xr, xi = x[..., 0], x[..., 1]
    # e^{+i theta}/N: yr = xr.c - xi.s ; yi = xr.s + xi.c
    return torch.stack([xr @ c - xi @ s, xr @ s + xi @ c], dim=-1)


def cmatvec_iq(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Complex matrix-vector product in real pairs
    (`dl_ofdm_tpu/ops/cfloat.py:90-100`).

    w: [n, m, 2] complex matrix (IQ-last); x: [..., m, 2].
    Returns [..., n, 2] = W @ x.
    """
    wr, wi = w[..., 0], w[..., 1]
    xr, xi = x[..., 0], x[..., 1]
    yr = xr @ wr.T - xi @ wi.T
    yi = xr @ wi.T + xi @ wr.T
    return torch.stack([yr, yi], dim=-1)


def solve_iq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the complex system A x = b in block-real form
    (`dl_ofdm_tpu/ops/cfloat.py:103-116`): the real embedding
    [[Ar, -Ai], [Ai, Ar]] [xr; xi] = [br; bi].

    a: [..., n, n, 2]; b: [..., n, 2].  `solve_ex` without its error
    check: `torch.linalg.solve` also reads the factorization's status on
    the host, and a singular system gives non-finite values, as
    `jnp.linalg.solve` does.  (On a card the host still waits for the
    card once a call, with triangular solves in place of `getrs` too:
    `scripts/torch_baseline_trace.py`.)
    """
    ar, ai = a[..., 0], a[..., 1]
    big = torch.cat([torch.cat([ar, -ai], dim=-1),
                     torch.cat([ai, ar], dim=-1)], dim=-2)   # [..., 2n, 2n]
    rhs = torch.cat([b[..., 0], b[..., 1]], dim=-1)[..., None]
    sol = torch.linalg.solve_ex(big, rhs, check_errors=False)[0][..., 0]
    n = a.shape[-2]
    return torch.stack([sol[..., :n], sol[..., n:]], dim=-1)
