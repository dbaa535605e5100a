"""AWGN with per-frame SNR.

Port of `dl_ofdm_tpu/channel/awgn.py:14-38` (reference `dev/py/radio.py:
513-526`): the signal is normalized by the square root of its batch-wide
mean complex power, then white Gaussian noise with per-component std
sqrt(0.5)*10^(-SNR/20) is added.  Returns (noisy IQ, mean noise power).

The unit normals are drawn as the JAX package draws them.  In bf16 (the
default) that is not a Gaussian: `jax.random.normal(key, shape, bfloat16)`
(jax 0.9, `_normal_real` on `_uniform`) takes 8 random bits a value, puts
their top 7 under the exponent of 1.0 (a bf16 in [1, 2)), subtracts 1,
scales the result to [lo, 1) with lo = -0.99609375 (bf16's nextafter(-1,
0)), clamps it at lo and returns sqrt(2) * erfinv(u), every step in bf16
arithmetic.  So it takes 128 values, from -2.890625 to 2.515625 (variance
0.9938, none beyond 3), which `bf16_normal_table` holds; the port draws 7
uniform bits a value and looks them up.  In float32 both packages draw
Gaussians (`torch.randn`; JAX's agrees with it up to draws beyond ~5.3
sigma).
"""
from __future__ import annotations

import functools
import math

import torch

BF16_NORMAL_LO = -0.99609375    # bf16's nextafter(-1, 0), JAX's minval


@functools.cache
def _bf16_normal_table_cpu() -> torch.Tensor:
    b = torch.bfloat16
    one = torch.tensor(1.0, dtype=b)
    lo = torch.tensor(BF16_NORMAL_LO, dtype=b)
    f = (torch.arange(128, dtype=torch.int16) | 0x3F80).view(b) - one
    u = torch.maximum(lo, f * (one - lo) + lo)
    return torch.tensor(2.0, dtype=b).sqrt() * torch.special.erfinv(u)


@functools.cache
def bf16_normal_table(device: torch.device | str = "cpu") -> torch.Tensor:
    """JAX's 128 bf16 unit normals, entry i for the 7 bits i: built with
    bf16 arithmetic on the CPU (float32 arithmetic rounded once gives
    other values), then moved to `device`."""
    return _bf16_normal_table_cpu().to(device)


def bf16_normal_from_words(words: torch.Tensor) -> torch.Tensor:
    """`jax.random.normal(key, shape, bfloat16)` from the uint8 words of
    `jax.random.bits(key, shape, uint8)`: entry words >> 1 of the table."""
    idx = (words.to(torch.int32) >> 1).reshape(-1)
    return torch.index_select(bf16_normal_table(words.device), 0,
                              idx).reshape(words.shape)


def bf16_normal(shape, device: torch.device | str,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Unit normals distributed as JAX's in bf16: 7 uniform bits a value
    from `generator`, looked up in `bf16_normal_table`."""
    idx = torch.randint(0, 128, (math.prod(shape),), dtype=torch.int32,
                        device=device, generator=generator)
    return torch.index_select(bf16_normal_table(torch.device(device)), 0,
                              idx).reshape(shape)


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
        x_iq's dtype.  bfloat16 by default, as in the JAX package, and
        then drawn as JAX draws them (`bf16_normal`).
      unit_noise: [B, S, T, 2] unit normals to use instead of drawing them
        (tests feed both packages the same draws); used as given.

    Returns: (y_iq [B, S, T, 2], noise_power scalar).
    """
    snr_db = snr_db.reshape(-1, 1, 1, 1).to(x_iq.dtype)
    sig_pwr = torch.mean(x_iq[..., 0] ** 2 + x_iq[..., 1] ** 2)
    x_norm = x_iq * torch.rsqrt(sig_pwr)
    noise_std = math.sqrt(0.5) * 10.0 ** (-snr_db / 20.0)
    if unit_noise is None and noise_dtype == torch.bfloat16:
        unit_noise = bf16_normal(x_iq.shape, x_iq.device, generator)
    elif unit_noise is None:
        unit_noise = torch.randn(x_iq.shape, dtype=noise_dtype,
                                 device=x_iq.device, generator=generator)
    noise = noise_std * unit_noise.to(x_iq.dtype)
    noise_power = torch.mean(noise[..., 0] ** 2 + noise[..., 1] ** 2)
    return x_norm + noise, noise_power
