"""Subcarrier planning: data/pilot/guard/DC index maps for an OFDM frame.

NumPy only; a copy of `dl_ofdm_tpu/ofdm/plan.py`, so that the port imports
nothing of the JAX package.  The tests hold the two equal.

Reproduces the reference's plan math exactly (`dev/py/ofdm.py:198-273`) for the
four pilot schemes ('lte' default, 'scattered', 'block', 'comb').  All indices
are computed once at config time with NumPy and baked into the jitted programs
as static gather/scatter maps — the TPU-native replacement for the reference's
per-frame fancy-indexed NumPy scatter (`dev/py/ofdm.py:358-360`).

Known reference quirk NOT copied: the reference's 'comb' branch allocates a
mis-shaped pilot array and crashes for nsymbol != 2 (`dev/py/ofdm.py:246-251`);
here 'comb' implements the evident intent (the same pilot comb in every symbol).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from dl_ofdm_tpu_torch.config import OFDMConfig

_SAMPLE_RATE = {64: 0.96e6, 128: 1.92e6, 256: 3.84e6, 512: 7.68e6,
                1024: 15.36e6, 1536: 23.04e6, 2048: 30.72e6}
_NRB = {64: 4, 128: 8, 256: 15, 512: 25, 1024: 50, 1536: 75, 2048: 100}


def lte_dl_cfg(nfft: int) -> tuple[float, int]:
    """FFT size -> (sample rate, resource blocks) (`dev/py/ofdm.py:173-194`)."""
    if nfft not in _SAMPLE_RATE:
        raise ValueError(f"Unsupported nFFT {nfft}")
    return _SAMPLE_RATE[nfft], _NRB[nfft]


@dataclasses.dataclass(frozen=True)
class SubcarrierPlan:
    """Static frame-level index plan.  Frame-flattened indices address the
    [nsymbol * nfft] grid in symbol-major (C) order."""

    nfft: int
    nsymbol: int
    cp_len: int
    sample_rate: float
    n_rb: int
    n_pilot: int            # pilots per pilot-bearing symbol (P)
    n_guard: int            # guard SCs per symbol incl. edges (G), excl. DC
    n_dc: int               # DC subcarriers
    pilot_value: complex
    pilot_type: str         # scheme name ('lte'|'scattered'|'block'|'comb')
    # per-symbol maps
    data_carriers: np.ndarray    # [n_data_sym] SC indices holding data (per-sym plan)
    pilot_carriers: np.ndarray   # [P] base pilot comb (symbol-0 comb).  Only
                                 # 'comb' places this comb in EVERY symbol;
                                 # 'lte' pilots live in symbols 0 and 4 (the
                                 # latter +3-shifted), 'block'/'scattered'
                                 # differ too — the exact frame-level truth is
                                 # pilot_sc.  Consumers using this field
                                 # across all symbols (e.g. the equalizer SNR
                                 # estimate, reference parity with
                                 # `dev/py/model.py:464-475` which does the
                                 # same) inherit that approximation.
    guard_carriers: np.ndarray   # guard+DC SC indices
    effec_carriers: np.ndarray   # effective (non-guard, non-DC) SC indices
    # frame-level maps (flattened over [nsymbol * nfft])
    data_sc: np.ndarray          # [frame_size]
    pilot_sc: np.ndarray         # [pilot_size]
    guard_sc: np.ndarray
    effec_sc: np.ndarray

    @property
    def frame_size(self) -> int:
        return len(self.data_sc)

    @property
    def pilot_size(self) -> int:
        return len(self.pilot_sc)

    @property
    def samples_per_symbol(self) -> int:
        return self.nfft + self.cp_len

    @property
    def samples_per_frame(self) -> int:
        return self.nsymbol * self.samples_per_symbol

    @property
    def pilot_sym(self) -> np.ndarray:
        """Symbol index of each frame-level pilot."""
        return self.pilot_sc // self.nfft

    @property
    def pilot_freq(self) -> np.ndarray:
        """Subcarrier index (within symbol) of each frame-level pilot."""
        return self.pilot_sc % self.nfft


@functools.lru_cache(maxsize=None)
def _build_plan_cached(nbits, nfft, nsymbol, npilot, nguard, pilot, longcp):
    k = nfft
    cp = int(np.around(k * (0.25 if longcp else 0.07)))
    fs, n_rb = lte_dl_cfg(k)
    dc = 2
    if pilot == "lte":
        p = 2 * n_rb
        g = k - dc - n_rb * 12
    else:
        p, g = npilot, nguard

    all_carriers = np.arange(k)
    dc_carriers = np.arange(k // 2 - 1, k // 2 + 1)
    effec = np.setdiff1d(np.arange(g // 2, k - g // 2), dc_carriers)
    pilot_loc = np.arange(0, len(effec), int(np.ceil(len(effec) / p)))
    pilot_carriers = effec[pilot_loc]
    guard_carriers = np.setdiff1d(all_carriers, effec)
    data_carriers = np.setdiff1d(effec, pilot_carriers)

    all_sc = np.arange(k * nsymbol)
    effec_sc = np.concatenate([effec + i * k for i in range(nsymbol)])
    if pilot == "scattered":
        cols = [np.sort((pilot_loc + i * 3) % len(effec)) for i in range(nsymbol)]
        pilot_sc = np.concatenate([effec[c] + i * k for i, c in enumerate(cols)])
    elif pilot == "block":
        if nsymbol < 4:
            raise ValueError("'block' pilot scheme places pilots in symbol 3 "
                             f"and needs nsymbol >= 4 (got {nsymbol})")
        pilot_sc = effec + 3 * k  # every effective SC of symbol 3 is a pilot
    elif pilot == "comb":
        pilot_sc = np.concatenate([pilot_carriers + i * k for i in range(nsymbol)])
    elif pilot == "lte":
        if nsymbol != 7:
            raise ValueError("'lte' pilot scheme requires nsymbol == 7")
        col0 = np.sort(pilot_loc % len(effec))
        col4 = np.sort((pilot_loc + 3) % len(effec))
        pilot_sc = np.concatenate([effec[col0] + 0 * k, effec[col4] + 4 * k])
    else:
        raise ValueError(f"Unsupported pilot type {pilot!r}")
    pilot_sc = np.sort(pilot_sc)
    guard_sc = np.setdiff1d(all_sc, effec_sc)
    data_sc = np.setdiff1d(effec_sc, pilot_sc)

    return SubcarrierPlan(
        nfft=k, nsymbol=nsymbol, cp_len=cp, sample_rate=fs, n_rb=n_rb,
        n_pilot=p, n_guard=g, n_dc=dc, pilot_value=3 + 3j, pilot_type=pilot,
        data_carriers=data_carriers, pilot_carriers=pilot_carriers,
        guard_carriers=guard_carriers, effec_carriers=effec,
        data_sc=data_sc, pilot_sc=pilot_sc, guard_sc=guard_sc, effec_sc=effec_sc,
    )


def build_plan(cfg: OFDMConfig) -> SubcarrierPlan:
    return _build_plan_cached(
        cfg.nbits, cfg.nfft, cfg.nsymbol, cfg.npilot, cfg.nguard,
        cfg.pilot, cfg.longcp,
    )
