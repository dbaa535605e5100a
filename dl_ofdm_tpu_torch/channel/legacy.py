"""Legacy Rayleigh channel variants from the reference (capability parity).

Port of `dl_ofdm_tpu/channel/legacy.py:31-131`.  The production fading
path is `channel/rayleigh.py`; the reference also carries two older
simulators with a coarser tap model:

  * `rayleigh_channel_legacy` (`RayLeigh_channel_np`,
    `dev/py/radio.py:194-257`): integer-delay taps (ceil(delay/Ts),
    colliding taps keep the FIRST power), an iid Gaussian tap draw per
    frame, `np.convolve(frame, ht, 'same')`, and the ground truth
    `H = fft(ht, nfft)` constant over the frame's symbols;
  * `rayleigh_channel_batch_coherent` (`RayLeigh_channel`,
    `dev/py/radio.py:123-188`): ONE tap draw for the whole batch, TF
    'SAME' cross-correlation alignment, and AWGN whose level is scaled by
    each frame's RMS amplitude after the FIR.

Both keep the reference's quirk: the tap weights are the LINEAR POWERS
over sqrt(sum of powers), not amplitudes (`dev/py/radio.py:162-164,
231-233`), and one weight multiplies both the re and im draws.  Each
call's FIR is `channel.fir.fir_same_iq`: one `fir_shift_accum` kernel
launch on a CUDA device.  The draws come from `generator` unless given
(`unit_taps=`, `unit_noise=`: the unit normals before any scaling).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
from dl_ofdm_tpu_torch.ops import cfloat

# integer-delay legacy tap tables (`dev/py/radio.py:139-150,214-225`)
_LEGACY_TAPS = {
    "ETU": ([0, 50, 120, 200, 230, 500, 1600, 2300, 5000],
            [-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0]),
    "EPA": ([0, 30, 70, 90, 110, 190, 410],
            [0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8]),
    "EVA": ([0, 30, 150, 310, 370, 710, 1090, 1730, 2510],
            [0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9]),
}


@functools.lru_cache(maxsize=None)
def legacy_tap_coeff(chan: str, samp_rate: float,
                     n_signal: int) -> np.ndarray:
    """Integer-delay tap weight vector [N_fir] (`dev/py/radio.py:152-164`):
    ceil(delay/Ts) bins, the FIRST colliding tap's power kept, weights the
    linear powers over sqrt(sum of powers); a flat single tap for a
    channel without a table."""
    if chan.upper() not in _LEGACY_TAPS:
        return np.ones((1,), np.float32)
    delay, pow_db = _LEGACY_TAPS[chan.upper()]
    delay = np.asarray(delay, np.float64)
    pow_db = np.asarray(pow_db, np.float64)
    t_ns = 1e9 / samp_rate
    n_fir = min(int(np.ceil(delay[-1] / t_ns)) + 1, n_signal)
    c_tap = np.ceil(delay / t_ns).astype(int)
    c_taps, c_idx = np.unique(c_tap, return_index=True)
    c_pow = 10.0 ** (pow_db[c_idx] / 10.0)
    coeff = np.zeros((n_fir,), np.float32)
    keep = c_taps < n_fir
    coeff[c_taps[keep]] = c_pow[keep] / np.sqrt(np.sum(c_pow))
    return coeff


@functools.lru_cache(maxsize=None)
def _coeff_on(chan: str, samp_rate: float, n_signal: int,
              device: torch.device) -> torch.Tensor:
    """`legacy_tap_coeff` as a float32 tensor on `device`, made once."""
    return torch.from_numpy(legacy_tap_coeff(chan, samp_rate,
                                             n_signal)).to(device)


def rayleigh_channel_legacy(x_iq: torch.Tensor, nfft: int, chan: str = "ETU",
                            samp_rate: float = 0.96e6,
                            generator: torch.Generator | None = None,
                            unit_taps: torch.Tensor | None = None):
    """Per-frame legacy fading (`RayLeigh_channel_np`).

    Args:
      x_iq: [n_fr, n_sym, n_sc, 2] real-pair waveform.
      unit_taps: [n_fr, N_fir, 2] unit normals (else drawn from
        `generator`); the taps are unit_taps / sqrt(2) x the weights.
    Returns:
      (y_iq [n_fr, n_sym, n_sc, 2], h_iq [n_fr, n_sym, nfft, 2]: the
       frame-constant ground truth fft(ht, nfft), the same for every
       symbol).
    """
    n_fr, n_sym, n_sc, _ = x_iq.shape
    if chan.upper() == "AWGN":
        shape = (n_fr, n_sym, nfft)
        return x_iq, torch.stack([x_iq.new_ones(shape), x_iq.new_zeros(shape)],
                                 dim=-1)
    coeff = _coeff_on(chan, samp_rate, n_sym * n_sc, x_iq.device)
    n_fir = coeff.shape[0]
    if unit_taps is None:
        unit_taps = torch.randn((n_fr, n_fir, 2), dtype=x_iq.dtype,
                                device=x_iq.device, generator=generator)
    h_taps = unit_taps / math.sqrt(2.0) * coeff[None, :, None]  # [n_fr, F, 2]
    off = np.full((n_fr,), (n_fir - 1) // 2, np.int32)
    y = fir_same_iq(x_iq.reshape(n_fr, n_sym * n_sc, 2), h_taps, off)
    h_f = cfloat.dft_iq(h_taps, n_out=nfft)                     # [n_fr, nfft, 2]
    return (y.reshape(x_iq.shape),
            h_f[:, None].expand(n_fr, n_sym, nfft, 2))


def rayleigh_channel_batch_coherent(x_iq: torch.Tensor, snr_db: torch.Tensor,
                                    chan: str = "ETU",
                                    samp_rate: float = 1e7,
                                    generator: torch.Generator | None = None,
                                    unit_taps: torch.Tensor | None = None,
                                    unit_noise: torch.Tensor | None = None):
    """In-graph legacy fading and noise (`RayLeigh_channel`).

    One tap draw for the batch; the FIR as TF 'SAME' cross-correlation
    (the kernel not flipped, left pad (F-1)//2), that is a convolution with
    the reversed taps at offset F-1-(F-1)//2; AWGN of level
    sqrt(0.5) 10^(-SNR/20) x each frame's RMS amplitude after the FIR.

    Args:
      x_iq: [B, S, T, 2]; snr_db: [B] or [B, 1] dB.
      unit_taps: [N_fir, 2], unit_noise: [B, S*T, 2] unit normals (else
        drawn from `generator`, taps first).
    Returns: (y_iq [B, S, T, 2], noise_power scalar).
    """
    b, s, t, _ = x_iq.shape
    n_signal = s * t
    coeff = _coeff_on(chan, samp_rate, n_signal, x_iq.device)
    n_fir = coeff.shape[0]
    if unit_taps is None:
        unit_taps = torch.randn((n_fir, 2), dtype=x_iq.dtype,
                                device=x_iq.device, generator=generator)
    ht = unit_taps / math.sqrt(2.0) * coeff[:, None]             # [F, 2]
    h_rev = torch.flip(ht, dims=(0,))[None].expand(b, n_fir, 2)
    off = np.full((b,), n_fir - 1 - (n_fir - 1) // 2, np.int32)
    y = fir_same_iq(x_iq.reshape(b, n_signal, 2), h_rev, off)   # [B, N, 2]

    amp2 = y[..., 0] ** 2 + y[..., 1] ** 2
    dist_amp = torch.sqrt(torch.mean(amp2, dim=1, keepdim=True))   # [B, 1]
    level = (math.sqrt(0.5) * 10.0 ** (-snr_db.reshape(b, 1).to(y.dtype)
                                       / 20.0) * dist_amp)
    if unit_noise is None:
        unit_noise = torch.randn(y.shape, dtype=y.dtype, device=y.device,
                                 generator=generator)
    noise = level[..., None] * unit_noise
    noise_power = torch.mean(noise[..., 0] ** 2 + noise[..., 1] ** 2)
    return (y + noise).reshape(x_iq.shape), noise_power
