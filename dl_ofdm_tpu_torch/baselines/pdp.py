"""Power-delay-profile channel statistics for LMMSE priors.

NumPy only; a copy of `dl_ofdm_tpu/baselines/pdp.py`, so that the port
imports nothing of the JAX package.  The tests hold the two equal.

Parity with the reference MATLAB helpers:
  * `rms_delay_spread` — `dev/m/rms_delay_spread.m:14-21`;
  * `mmse_pdp` — uniform / exponential PDP covariance closed forms
    (Hung & Lin 2010), `dev/m/mmse_pdp.m:19-49`.

These run once per configuration on the host (NumPy, complex) to produce the
static `Rhh` prior matrices consumed by the batched LMMSE estimators.
"""
from __future__ import annotations

import numpy as np


def rms_delay_spread(tau, pdb):
    """(Trms, Tmean) of a power delay profile (tau seconds, pdb dB)."""
    tau = np.asarray(tau, dtype=np.float64).ravel()
    pli = 10.0 ** (np.asarray(pdb, dtype=np.float64).ravel() / 10.0)
    tmean = float(tau @ pli / pli.sum())
    trms = float(np.sqrt(((tau - tmean) ** 2) @ pli / pli.sum()))
    return trms, tmean


def mmse_pdp(n_paths: int, n: int, trms: float, uniform: bool) -> np.ndarray:
    """Frequency-domain channel covariance Rhh [n, n] complex.

    `n_paths` is L (delay support in samples), `trms` the RMS delay spread in
    samples.  Diagonal is forced to 1 exactly as the MATLAB code does.
    """
    m = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    d = m - k
    if uniform:
        with np.errstate(divide="ignore", invalid="ignore"):
            x = 2j * np.pi * n_paths * d / n
            r = (1 - np.exp(-x)) / x
    else:
        a = (1.0 / trms) + 2j * np.pi * d / n
        r = (1 - np.exp(-n_paths * a)) / (trms * (1 - np.exp(-n_paths / trms)) * a)
    np.fill_diagonal(r, 1.0)
    return r.astype(np.complex128)
