"""Batched 'same' FIR convolution for the fading channel, real-pair.

Port of the IQ-last path of `dl_ofdm_tpu/channel/fir.py:123-172`
(`_prealign_plane`, `fir_same_iq`): `np.convolve(x_b, h_b, 'same')` per row
(reference `dev/py/radio.py:436`) as a static shift-and-accumulate over the
F taps, with each row's 'same' offset applied by one slice per distinct
offset.  The per-symbol (Doppler) variant comes with the Doppler slice.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
    out_r = x.new_zeros(b, l)
    out_i = x.new_zeros(b, l)
    for k in range(f):
        s = f - 1 - k
        sr = xar[:, s:s + l]
        si = xai[:, s:s + l]
        hr = h[:, k, 0:1]
        hi = h[:, k, 1:2]
        out_r = out_r + sr * hr - si * hi
        out_i = out_i + sr * hi + si * hr
    return torch.stack([out_r, out_i], dim=-1)
