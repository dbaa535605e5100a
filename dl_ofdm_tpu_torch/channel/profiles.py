"""3GPP LTE multipath tap profiles and fractional-delay FIR interpolation.

NumPy only; a copy of `dl_ofdm_tpu/channel/profiles.py`, so that the port
imports nothing of the JAX package.  The tests hold the two equal.

Profiles (delays ns / average powers dB / Doppler Fd when mobile) match the
reference (`dev/py/radio.py:339-366`): ETU, EPA, EVA, Custom, Flat.  The
fractional-delay "alpha matrix" that turns per-tap gains into an FIR kernel is
generated on the fly as alpha[k, n] = sinc(n - 4 - delay_k/Ts) — verified to
reproduce the reference's MATLAB-exported CSVs (`dev/py/3gpp/AM_*.csv`) to
their stored precision (~5e-6).  Column counts for the four named profiles are
pinned to the CSV shapes so `np.convolve(..., 'same')` alignment (which depends
on FIR length parity) is bit-compatible with the reference.

Known reference quirk preserved (selectable): tap weights use linear *power*
rather than amplitude, `ch_coeff = p / sqrt(sum(p))` (`dev/py/radio.py:367-371`)
— the default `weighting='reference'` reproduces it; `weighting='physical'`
uses sqrt(p)/sqrt(sum(p)) (MATLAB-consistent).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

# name -> (delays ns, powers dB, Fd when mobile)
_PROFILES = {
    "etu": ([0, 50, 120, 200, 230, 500, 1600, 2300, 5000],
            [-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0], 300.0),
    "epa": ([0, 30, 70, 90, 110, 190, 410],
            [0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8], 5.0),
    "eva": ([0, 30, 150, 310, 370, 710, 1090, 1730, 2510],
            [0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9], 70.0),
    "custom": ([0, 70, 200, 230, 500, 1600, 2700, 3000],
               [0.0, -1.4, -1.4, -1.0, -3.0, -9.1, -15.0, -19.0], 80.0),
    "flat": ([0], [0], 5.0),
    "awgn": ([0], [0], 0.0),
}

# FIR column counts pinned to the reference CSV shapes (@0.96 Msps).
_PINNED_NCOLS = {"etu": 13, "epa": 9, "eva": 11, "custom": 12}

PROFILE_NAMES = ("flat", "etu", "eva", "epa", "custom")
_CENTER = 4  # non-causal look-ahead of the sinc interpolator (samples)


@dataclasses.dataclass(frozen=True)
class TapProfile:
    name: str
    tap_delay_ns: np.ndarray      # [n_taps]
    tap_pow_db: np.ndarray        # [n_taps]
    fd_mobile: float              # Doppler shift when mobile (Hz)
    ch_coeff: np.ndarray          # [n_taps] tap weights
    alpha_matrix: np.ndarray      # [n_taps, n_fir] fractional-delay interp

    @property
    def n_taps(self) -> int:
        return len(self.tap_delay_ns)

    @property
    def n_fir(self) -> int:
        return self.alpha_matrix.shape[1]

    @property
    def same_offset(self) -> int:
        """Offset of `np.convolve(x, h, 'same')` into the full convolution."""
        return (self.n_fir - 1) // 2


def alpha_matrix(delays_ns: np.ndarray, sample_rate: float,
                 n_cols: int | None = None) -> np.ndarray:
    """Sinc fractional-delay interpolation matrix [n_taps, n_cols]."""
    d = np.asarray(delays_ns, dtype=np.float64) * sample_rate * 1e-9
    if n_cols is None:
        if len(d) == 1 and d[0] == 0.0:
            return np.ones((1, 1))
        # Fallback for rates without pinned reference shapes (_PINNED_NCOLS
        # covers the 4 MATLAB-exported CSVs @0.96 Msps; the exact generator
        # rule is not derivable from those 4 shapes — etu implies floor(dmax),
        # custom implies ceil).  ceil fully covers the last tap's sinc peak,
        # and the resulting FIR/ground-truth pair is self-consistent at any
        # rate; only the pinned rate claims bit-parity with the reference.
        n_cols = _CENTER + 1 + int(np.ceil(d.max())) + _CENTER
    n = np.arange(n_cols)
    return np.sinc(n[None, :] - _CENTER - d[:, None])


@functools.lru_cache(maxsize=None)
def get_profile(name: str, sample_rate: float = 0.96e6,
                weighting: str = "reference") -> TapProfile:
    key = name.lower()
    if key not in _PROFILES:
        raise ValueError(f"Unknown channel profile {name!r}")
    delays, powers, fd = _PROFILES[key]
    delays = np.asarray(delays, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    p_lin = 10.0 ** (powers / 10.0)
    if weighting == "reference":
        coeff = p_lin / np.sqrt(p_lin.sum())
    elif weighting == "physical":
        coeff = np.sqrt(p_lin / p_lin.sum())
    else:
        raise ValueError(f"Unknown weighting {weighting!r}")
    if key in ("flat", "awgn"):
        am = np.ones((1, 1))
    else:
        ncols = _PINNED_NCOLS.get(key) if sample_rate == 0.96e6 else None
        am = alpha_matrix(delays, sample_rate, ncols)
    return TapProfile(name=key, tap_delay_ns=delays, tap_pow_db=powers,
                      fd_mobile=fd, ch_coeff=coeff, alpha_matrix=am)
