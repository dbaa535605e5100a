"""Jakes-model Doppler fading by a sum of sinusoids.

Port of `dl_ofdm_tpu/channel/doppler.py` (reference `dev/py/radio.py:387-396`):

  ss = 48 sinusoids; for tap k (1-based) and sinusoid n (1-based):
    n_vec[n]    = (n - 0.5) * pi / (4*ss)
    alpha_re[k] = k * pi / (4*ss),  alpha_im[k] = -alpha_re[k]
    f_re[n,k]   = Fd * cos(n_vec[n] + alpha_re[k])   (f_im analogous)
    theta_*     ~ U(0, 2*pi)                          (per frame, per n,k)
    zck(t)[k]   = sqrt(1/ss) * (sum_n cos(2*pi*t*f_re + th_re)
                                + 1j * sum_n cos(2*pi*t*f_im + th_im))

One t per OFDM symbol (t = i * t_sym); every frame and symbol in one
broadcast cos-sum.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SS = 48  # number of sinusoids


def jakes_bases(n_taps: int) -> tuple[np.ndarray, np.ndarray]:
    """(base_re, base_im) float32 [SS, n_taps]: cos(n_vec + alpha_re) and
    cos(n_vec - alpha_re), the frequencies of a 1 Hz Doppler shift."""
    k_vec = np.arange(1, n_taps + 1)
    n_vec = (np.arange(1, SS + 1).reshape(SS, 1) - 0.5) * np.pi / (4 * SS)
    alpha_re = k_vec * np.pi / (4 * SS)
    return (np.cos(n_vec + alpha_re).astype(np.float32),
            np.cos(n_vec - alpha_re).astype(np.float32))


def jakes_frequencies(fd: torch.Tensor, n_taps: int):
    """Per-(sinusoid, tap) Doppler frequencies: fd [...] (Hz) ->
    (f_re, f_im) [..., SS, n_taps]."""
    base_re, base_im = (torch.from_numpy(b).to(fd.device)
                        for b in jakes_bases(n_taps))
    fd = fd[..., None, None]
    return fd * base_re, fd * base_im


def jakes_gains_from_phases(th_re: torch.Tensor, th_im: torch.Tensor,
                            fd: torch.Tensor, t: torch.Tensor,
                            n_taps: int) -> torch.Tensor:
    """Jakes gains of given sinusoid phases.

    Args:
      th_re, th_im: [B, SS, n_taps] phases in [0, 2 pi).
      fd: [B] Doppler shift per frame (Hz); t: [S] symbol times (s).
    Returns zck [B, S, n_taps, 2] float32."""
    f_re, f_im = jakes_frequencies(fd, n_taps)            # [B, SS, n_taps]
    phase = 2 * math.pi * t[None, :, None, None]           # [1, S, 1, 1]
    c1 = float(np.float32(np.sqrt(1.0 / SS)))
    mu_re = c1 * torch.cos(phase * f_re[:, None] + th_re[:, None]).sum(2)
    mu_im = c1 * torch.cos(phase * f_im[:, None] + th_im[:, None]).sum(2)
    return torch.stack([mu_re, mu_im], dim=-1)


def jakes_phases(b: int, n_taps: int, generator: torch.Generator | None,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """(th_re, th_im) [b, SS, n_taps], U(0, 2 pi), drawn in that order."""
    return tuple(torch.rand(b, SS, n_taps, generator=generator,
                            device=device) * (2 * math.pi) for _ in range(2))


def jakes_gains_iq(fd: torch.Tensor, t: torch.Tensor, n_taps: int,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Time-varying tap gains [B, S, n_taps, 2] for fd [B] (Hz) at the
    times t [S] (s), with phases drawn from `generator`."""
    th_re, th_im = jakes_phases(fd.shape[0], n_taps, generator, fd.device)
    return jakes_gains_from_phases(th_re, th_im, fd, t, n_taps)
