"""PAPR clipping (complex clip-by-norm).

Port of `dl_ofdm_tpu/ofdm/papr.py:16-35`, the reference's two variants:

  * `clip_papr` (NumPy `Clip_by_norm_np`, `dev/py/ofdm.py:156-170`):
    samples whose instantaneous power exceeds `peak` x the mean power are
    scaled down to that threshold's amplitude.  It takes a complex tensor,
    as JAX's does: the one exception to the port's IQ-last rule;
  * `clip_papr_iq` (TF `complex_clip`, `dev/py/complex.py:21-27`): the
    IQ norm of each sample is capped at `peak` (an absolute amplitude, not
    PAPR-relative); returns the clipped pairs and their mean power.
"""
from __future__ import annotations

import torch


def clip_papr(x: torch.Tensor, peak: float = 8.0) -> torch.Tensor:
    """Clip a complex waveform to PAPR <= peak (relative to its mean power):
    a sample above `peak * mean power` becomes `sqrt(peak * avg) x / |x|`
    (the MATLAB link's per-symbol clip, `dev/m/OFDM_Benchmark_dev.m:260-267`)."""
    sig_pwr = x.abs() ** 2 + 1e-8
    avg_pwr = torch.mean(sig_pwr)
    clipped = torch.sqrt(peak * avg_pwr) * x / torch.sqrt(sig_pwr)
    return torch.where(sig_pwr < peak * avg_pwr, x, clipped)


def clip_papr_iq(x_iq: torch.Tensor, peak: float = 8.0):
    """Clip IQ pairs [..., 2] to norm <= peak; returns (clipped, mean power)."""
    norm = torch.sqrt(torch.sum(x_iq ** 2, dim=-1, keepdim=True) + 1e-12)
    scale = torch.clamp(peak / norm, max=1.0)
    clipped = x_iq * scale
    power_tx = torch.mean(torch.sum(clipped ** 2, dim=-1))
    return clipped, power_tx
