"""AWGN with per-frame SNR.

Port of `dl_ofdm_tpu/channel/awgn.py:14-38` (reference `dev/py/radio.py:
513-526`): the signal is normalized by the square root of its batch-wide
mean complex power, then white Gaussian noise with per-component std
sqrt(0.5)*10^(-SNR/20) is added.  Returns (noisy IQ, mean noise power).
"""
from __future__ import annotations

import math

import torch


def awgn_channel(x_iq: torch.Tensor, snr_db: torch.Tensor,
                 generator: torch.Generator | None = None,
                 noise_dtype: torch.dtype = torch.bfloat16,
                 unit_noise: torch.Tensor | None = None):
    """Args:
      x_iq: [B, S, T, 2] real IQ waveform.
      snr_db: [B] or [B, 1] per-frame SNR in dB.
      generator: draws the unit normals (the device's default generator
        when None).
      noise_dtype: dtype the unit normals are drawn in; arithmetic stays in
        x_iq's dtype.  bfloat16 by default, as in the JAX package.
      unit_noise: [B, S, T, 2] unit normals to use instead of drawing them
        (tests feed both packages the same draws); used as given.

    Returns: (y_iq [B, S, T, 2], noise_power scalar).
    """
    snr_db = snr_db.reshape(-1, 1, 1, 1).to(x_iq.dtype)
    sig_pwr = torch.mean(x_iq[..., 0] ** 2 + x_iq[..., 1] ** 2)
    x_norm = x_iq * torch.rsqrt(sig_pwr)
    noise_std = math.sqrt(0.5) * 10.0 ** (-snr_db / 20.0)
    if unit_noise is None:
        unit_noise = torch.randn(x_iq.shape, dtype=noise_dtype,
                                 device=x_iq.device, generator=generator)
    noise = noise_std * unit_noise.to(x_iq.dtype)
    noise_power = torch.mean(noise[..., 0] ** 2 + noise[..., 1] ** 2)
    return x_norm + noise, noise_power
