"""Batched 'same' FIR convolution for the fading channel, real-pair.

Port of the IQ-last path of `dl_ofdm_tpu/channel/fir.py:123-172`
(`_prealign_plane`, `fir_same_iq`): `np.convolve(x_b, h_b, 'same')` per row
(reference `dev/py/radio.py:436`) as a static shift-and-accumulate over the
F taps, with each row's 'same' offset applied by one slice per distinct
offset (on a CUDA device the accumulation is one launch of the
`fir_shift_accum` kernel, on the CPU the plain loop); and of
`fir_per_symbol_iq` (`fir.py:175-222`), the per-symbol
variant of the Doppler path.

The complex FFT-convolution variants (`fir.py:22-107`: `_fft_conv_full`,
`fir_same_batched`, `fir_same_varlen`, `fir_per_symbol` and the NumPy
oracle `np_convolve_same_reference`) take and return complex tensors, as
JAX's do; they run on `torch.fft`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dl_ofdm_tpu_torch.ops.pallas_kernels import fir_shift_accum


def _fft_conv_full(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full linear convolution along the last axis via FFT: x [..., L],
    h [..., F] (broadcastable leading dims) -> [..., L+F-1], complex."""
    n = x.shape[-1] + h.shape[-1] - 1
    return torch.fft.ifft(torch.fft.fft(x, n=n, dim=-1)
                          * torch.fft.fft(h, n=n, dim=-1), dim=-1)


def fir_same_batched(x: torch.Tensor, h: torch.Tensor,
                     same_offset: int) -> torch.Tensor:
    """np.convolve(x_i, h_i, 'same') for each batch row: x [..., L] and
    h [..., F] complex; `same_offset` is (F-1)//2 of the unpadded kernel.
    Returns [..., L] in x's dtype."""
    full = _fft_conv_full(x, h)
    return full[..., same_offset:same_offset + x.shape[-1]].to(x.dtype)


def fir_same_varlen(x: torch.Tensor, h: torch.Tensor,
                    same_offset: torch.Tensor) -> torch.Tensor:
    """`fir_same_batched` with a per-row offset (the mixed channel's
    zero-padded kernels, `dev/py/radio.py:450-490`): x [B, L], h [B, Fmax],
    same_offset [B] integers."""
    full = _fft_conv_full(x, h)                      # [B, L+Fmax-1]
    pos = (torch.arange(x.shape[-1], device=x.device)[None, :]
           + same_offset.to(x.device, torch.int64)[:, None])
    return torch.gather(full, -1, pos).to(x.dtype)


def fir_per_symbol(tx: torch.Tensor, h_sym: torch.Tensor, n_taps: int,
                   same_offset: torch.Tensor | int) -> torch.Tensor:
    """Per-symbol time-varying FIR with `n_taps` look-back history
    (`dev/py/radio.py:399-421`): symbol i's window is
    pre[n_sc i : n_taps + n_sc (i+1)] of the frame with `n_taps` leading
    zeros, convolved 'same' with that symbol's kernel, the first n_taps
    outputs dropped; the future beyond the symbol is zeros.

    Args:
      tx: [B, S, n_sc] complex; h_sym: [B, S, F] complex kernels;
      same_offset: an int or [B] integers ((F_orig-1)//2).
    Returns [B, S, n_sc] complex.
    """
    b, s, n_sc = tx.shape
    pre = F.pad(tx.reshape(b, s * n_sc), (n_taps, 0))
    idx = (torch.arange(s, device=tx.device)[:, None] * n_sc
           + torch.arange(n_taps + n_sc, device=tx.device)[None, :])
    windows = pre[:, idx]                            # [B, S, n_taps+n_sc]
    full = _fft_conv_full(windows, h_sym)            # [B, S, n_taps+n_sc+F-1]
    off = torch.as_tensor(same_offset, device=tx.device).to(torch.int64)
    off = off.expand(b) if off.dim() == 0 else off
    pos = (torch.arange(n_sc, device=tx.device)[None, None, :] + n_taps
           + off[:, None, None]).expand(b, s, n_sc)
    return torch.gather(full, -1, pos).to(tx.dtype)


def np_convolve_same_reference(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Host-side oracle for tests: NumPy semantics, one row."""
    return np.convolve(x, h, mode="same")


def _prealign_plane(xp: torch.Tensor, offsets: np.ndarray,
                    out_len: int) -> torch.Tensor:
    """xa[b, m] = xp[b, m + off_b] for a pre-padded plane xp [B, Lp]."""
    offsets = np.asarray(offsets)
    uniq = np.unique(offsets)
    if len(uniq) == 1:
        off = int(uniq[0])
        return xp[:, off:off + out_len]
    out = xp.new_zeros(xp.shape[0], out_len)
    for off in uniq:
        rows = torch.from_numpy(np.flatnonzero(offsets == off)).to(xp.device)
        out[rows] = xp[rows, int(off):int(off) + out_len]
    return out


def fir_same_iq(x: torch.Tensor, h: torch.Tensor,
                offsets: np.ndarray) -> torch.Tensor:
    """np.convolve(x_b, h_b, 'same') per row, real-pair, static offsets.

    The shift-and-accumulate over the taps runs as one `fir_shift_accum`
    kernel launch where x lies on a CUDA device, as its plain loop where x
    lies on the CPU.

    Args:
      x: [B, L, 2]; h: [B, F, 2] (zero-padded kernels of a common length);
      offsets: STATIC per-row (F_orig-1)//2 alignment (numpy int array).
    Returns [B, L, 2].
    """
    b, l, _ = x.shape
    f = h.shape[1]
    pad = f - 1
    xr = F.pad(x[..., 0], (pad, pad))
    xi = F.pad(x[..., 1], (pad, pad))
    xar = _prealign_plane(xr, offsets, l + f - 1)        # [B, L+F-1]
    xai = _prealign_plane(xi, offsets, l + f - 1)
    out_r, out_i = fir_shift_accum(xar, xai, h[..., 0], h[..., 1], l)
    return torch.stack([out_r, out_i], dim=-1)


def fir_per_symbol_iq(tx: torch.Tensor, h_sym: torch.Tensor, n_taps: int,
                      offsets: np.ndarray) -> torch.Tensor:
    """Per-symbol time-varying FIR, real-pair, static offsets
    (`dl_ofdm_tpu/channel/fir.py:175-222`, reference
    `dev/py/radio.py:399-421`): symbol i is convolved 'same' with its own
    kernel over a window of `n_taps` look-back samples from the previous
    symbols and zero future.

    Args:
      tx: [B, S, n_sc, 2]; h_sym: [B, S, F, 2]; offsets: static [B].
    Returns [B, S, n_sc, 2].
    """
    b, s, n_sc, _ = tx.shape
    f = h_sym.shape[2]
    wlen = n_taps + n_sc + f
    offsets = np.asarray(offsets)
    uniq = np.unique(offsets)

    def plane(p):
        pre = F.pad(p.reshape(b, s * n_sc), (n_taps, 0))
        win = torch.stack([pre[:, i * n_sc:i * n_sc + n_taps + n_sc]
                           for i in range(s)], dim=1)
        wpad = F.pad(win, (f, f))
        if len(uniq) == 1:
            off = int(uniq[0]) + 1
            return wpad[..., off:off + wlen]
        out = p.new_zeros(b, s, wlen)
        for off in uniq:
            rows = torch.from_numpy(np.flatnonzero(offsets == off)).to(
                p.device)
            out[rows] = wpad[rows, :, int(off) + 1:int(off) + 1 + wlen]
        return out

    war = plane(tx[..., 0])
    wai = plane(tx[..., 1])
    out_r = tx.new_zeros(b, s, n_sc)
    out_i = tx.new_zeros(b, s, n_sc)
    base = n_taps + f - 1
    for k in range(f):
        st = base - k
        sr = war[..., st:st + n_sc]
        si = wai[..., st:st + n_sc]
        hr = h_sym[:, :, k, 0:1]
        hi = h_sym[:, :, k, 1:2]
        out_r = out_r + sr * hr - si * hi
        out_i = out_i + sr * hi + si * hr
    return torch.stack([out_r, out_i], dim=-1)
