"""SNR curriculum sampling for the equalizer fine-tuning stage.

Port of `dl_ofdm_tpu/train/curriculum.py` (reference
`dev/py/ofdmreceiver_np_mp.py:386,405,442`): per-frame SNR drawn from
linspace(0, 27, 10) dB with pmf [.01,.01,.02,.02,.02,.02,.1,.5,.2,.1]; the
tail grid 0-33 dB moves mass into the 27-33 bins; `modulation_offset_db`
shifts the grid +2.5 dB per extra bit.  Draws come from an explicit
`torch.Generator` and match JAX's `jax.random.choice` in distribution, not
draw for draw.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dl_ofdm_tpu_torch.utils.observability import span

SNR_GRID = np.linspace(0.0, 27.0, 10, dtype=np.float32)
SNR_PMF = np.asarray([0.01, 0.01, 0.02, 0.02, 0.02, 0.02, 0.1, 0.5, 0.2, 0.1],
                     dtype=np.float32)

SNR_TAIL_GRID = np.linspace(0.0, 33.0, 12, dtype=np.float32)
SNR_TAIL_PMF = np.asarray([0.01, 0.01, 0.02, 0.02, 0.02, 0.02,
                           0.05, 0.15, 0.25, 0.20, 0.15, 0.10],
                          dtype=np.float32)


def modulation_offset_db(nbits: int) -> float:
    """Default curriculum grid shift for nbits-per-symbol constellations."""
    return 2.5 * (nbits - 1)


@functools.cache
def _grid_pmf(tail: bool, device: torch.device):
    """The grid and its pmf as tensors on `device`, copied there once."""
    grid, pmf = (SNR_TAIL_GRID, SNR_TAIL_PMF) if tail else (SNR_GRID, SNR_PMF)
    return torch.from_numpy(grid).to(device), torch.from_numpy(pmf).to(device)


def sample_snr(generator: torch.Generator, n_frames: int,
               offset_db: float = 0.0, tail: bool = False) -> torch.Tensor:
    """[n_frames] float32 SNRs in dB on the generator's device: grid points
    drawn with the pmf, plus `offset_db`.  `tail=True` takes the 0-33 dB
    grid.  The draw is the `data.snr` span."""
    with span("data.snr"):
        grid, pmf = _grid_pmf(tail, generator.device)
        idx = torch.multinomial(pmf, n_frames, replacement=True,
                                generator=generator)
        return grid[idx] + offset_db
