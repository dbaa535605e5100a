"""CP-enhanced channel estimation (Quadeer 2010) — `dev/m/cpenhanced.m`.

Port of `dl_ofdm_tpu/baselines/cp_enhanced.py`.  Per frame: for each OFDM
symbol, the cyclic-prefix samples are re-used to LS-estimate the
time-domain channel taps h (via a comb matrix mixing the previous and
current symbol's CP-region data), then the data grid X is jointly
re-estimated from the stacked system

    B = [diag(Gls); H_L @ Q_NL],   C = [Rx_Freq; ycp - Xcp_u @ h]

solved in least squares.  The normal equations B^H B = diag(|g|^2) + M^H M
(M = H_L Q, rank <= L) are solved with the Woodbury identity: an L x L
solve (L = CP length) instead of MATLAB's N x N inverse.

JAX's `vmap` over frames is the leading batch axis of every tensor here,
and its `lax.scan` over the symbols a Python loop that carries the
previous symbol's CP-region samples; the two L x L solves of a symbol are
`cfloat.solve_iq` on [B, L, L, 2].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dl_ofdm_tpu_torch.ops import cfloat

RIDGE = 1e-9


@functools.lru_cache(maxsize=None)
def _static(n: int, l: int):
    """Static index/mask/matrix constants, NumPy (`cp_enhanced.py:28-46`)."""
    # Q_NL: last L rows of conj(dftmtx(N))/N  (IDFT matrix rows N-L..N-1)
    t = np.arange(n)
    qinv = np.exp(2j * np.pi * np.outer(t, t) / n) / n
    qnl = qinv[n - l:, :]                                  # [L, N] complex
    qnl_iq = np.stack([qnl.real, qnl.imag], -1).astype(np.float32)
    # comb gather: mtx[i, j] = stacked[(L + i - j) mod 2L]
    i = np.arange(l)[:, None]
    j = np.arange(l)[None, :]
    comb_idx = ((l + i - j) % (2 * l)).astype(np.int32)
    tril_mask = (i >= j).astype(np.float32)                # lower-tri incl diag
    # Xcp_u mask: kept iff j >= i + 2 (col 0 zero, triu(k=1) of cols 1..L-1)
    upper_mask = (j >= i + 2).astype(np.float32)
    eye_l = np.eye(l, dtype=np.float32)
    return qnl_iq, comb_idx, tril_mask, upper_mask, eye_l


@functools.lru_cache(maxsize=None)
def _static_on(n: int, l: int, device: torch.device, dtype: torch.dtype):
    """`_static`'s constants on `device`, made once: (qnl_iq [L, N, 2],
    tril [L, L, 1], upper [L, L, 1], the ridge's I [L, L, 2] and I
    [L, L, 2] as complex IQ, in `dtype`; comb_idx [L, L] int64)."""
    qnl_iq, comb_idx, tril, upper, eye_l = _static(n, l)
    eye_iq = np.stack([eye_l, np.zeros_like(eye_l)], -1)
    ridge_iq = np.stack([np.float32(RIDGE) * eye_l, np.zeros_like(eye_l)], -1)
    consts = (torch.from_numpy(a).to(device=device, dtype=dtype) for a in (
        qnl_iq, tril[..., None], upper[..., None], ridge_iq, eye_iq))
    return (*consts, torch.from_numpy(comb_idx).to(device, torch.int64))


def _comb(prev: torch.Tensor, cur: torch.Tensor,
          comb_idx: torch.Tensor) -> torch.Tensor:
    """circshift_comb: [B, L, 2], [B, L, 2] -> [B, L, L, 2] with
    mtx[i, j] = cur[i-j] if i >= j else prev[L+i-j]."""
    stacked = torch.cat([prev, cur], dim=1)                # [B, 2L, 2]
    return stacked[:, comb_idx]


def _hermitian_matmul_iq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^H B for IQ matrices a [..., m, k, 2], b [..., m, n, 2] ->
    [..., k, n, 2]."""
    ar, ai = a[..., 0].mT, a[..., 1].mT
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar @ br + ai @ bi, ar @ bi - ai @ br], dim=-1)


def _cmatmul_iq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A B for IQ matrices [..., m, k, 2] x [..., k, n, 2] ->
    [..., m, n, 2]."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar @ br - ai @ bi, ar @ bi + ai @ br], dim=-1)


def _cdiv_iq(a: torch.Tensor, b: torch.Tensor,
             eps: float = 1e-12) -> torch.Tensor:
    d = cfloat.abs2_iq(b) + eps
    return cfloat.cmul_iq(a, cfloat.conj_iq(b)) / d[..., None]


def _matvec(a: torch.Tensor, v: torch.Tensor, hermitian: bool = False):
    """A v (or A^H v) for a [B, m, k, 2] and v [B, k, 2] (or [B, m, 2])."""
    fn = _hermitian_matmul_iq if hermitian else _cmatmul_iq
    return fn(a, v[:, :, None])[:, :, 0]


def cp_enhanced_frame(rx_freq: torch.Tensor, gls: torch.Tensor,
                      y_time: torch.Tensor, cp_len: int):
    """Batched CP-enhanced estimation (`cp_enhanced.py:78-134`).

    Args:
      rx_freq: [B, S, N, 2] frequency grid (scaled-FFT output);
      gls:     [B, S, N, 2] initial channel estimate;
      y_time:  [B, S, N+CP, 2] noisy time waveform (with CP);
      cp_len:  L.

    Returns (x_est [B, S, N, 2], g_est [B, S, N, 2]).
    """
    b, s, n, _ = rx_freq.shape
    l = cp_len
    qnl_iq, tril, upper, ridge_iq, eye_iq, comb_idx = _static_on(
        n, l, rx_freq.device, rx_freq.dtype)
    xls = _cdiv_iq(rx_freq, gls)                           # [B, S, N, 2]
    xls_time = cfloat.idft_iq(xls)                         # [B, S, N, 2]
    xcp_prev = rx_freq.new_zeros(b, l, 2)
    zeros = rx_freq.new_zeros(b, l, 2)
    xs = []
    for i in range(s):
        ycp_j = y_time[:, i, :l]                           # [B, L, 2]
        rx_j, g_j = rx_freq[:, i], gls[:, i]               # [B, N, 2]
        xcp_this = xls_time[:, i, n - l:]                  # [B, L, 2]
        xcp = _comb(xcp_prev, xcp_this, comb_idx)          # [B, L, L, 2]
        xcp_u = xcp * upper
        # h = (Xcp^H Xcp + ridge I)^-1 Xcp^H ycp
        ata = _hermitian_matmul_iq(xcp, xcp) + ridge_iq
        h = cfloat.solve_iq(ata, _matvec(xcp, ycp_j, hermitian=True))
        # H_L: lower-triangular Toeplitz of h
        h_l = _comb(zeros, h, comb_idx) * tril
        m = _cmatmul_iq(h_l, qnl_iq)                       # [B, L, N, 2]
        # C2 = ycp - Xcp_u h
        c2 = ycp_j - _matvec(xcp_u, h)
        # Solve (D + M^H M) x = conj(g) rx + M^H c2 via Woodbury
        d = (cfloat.abs2_iq(g_j) + RIDGE)[..., None]       # [B, N, 1]
        rhs = cfloat.cmul_iq(cfloat.conj_iq(g_j), rx_j) + _matvec(
            m, c2, hermitian=True)
        u = rhs / d
        # T = I + M D^-1 M^H
        m_h = torch.stack([m[..., 0].mT, -m[..., 1].mT], dim=-1)
        t_mat = _cmatmul_iq(m / d[:, None], m_h) + eye_iq
        z = cfloat.solve_iq(t_mat, _matvec(m, u))          # [B, L, 2]
        xs.append(u - _matvec(m, z, hermitian=True) / d)
        xcp_prev = xcp_this
    x_est = torch.stack(xs, dim=1)
    return x_est, _cdiv_iq(rx_freq, x_est)
