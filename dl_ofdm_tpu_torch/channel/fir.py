"""Batched 'same' FIR convolution for the fading channel, real-pair.

Port of the IQ-last path of `dl_ofdm_tpu/channel/fir.py:123-172`
(`_prealign_plane`, `fir_same_iq`): `np.convolve(x_b, h_b, 'same')` per row
(reference `dev/py/radio.py:436`) as a static shift-and-accumulate over the
F taps, with each row's 'same' offset applied by one slice per distinct
offset (on a CUDA device the accumulation is one launch of the
`fir_shift_accum` kernel, on the CPU the plain loop); and of
`fir_per_symbol_iq` (`fir.py:175-222`), the per-symbol
variant of the Doppler path.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dl_ofdm_tpu_torch.ops.pallas_kernels import fir_shift_accum


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
