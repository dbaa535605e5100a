"""Legacy transmitter variants from the reference (capability parity).

Port of `dl_ofdm_tpu/ofdm/legacy_tx.py:42-137`.  The main transmitter is
`ofdm/tx.py`; the reference's two others differ in pilot layout and I/O:

  * `ofdm_modulate_symbol_pilots` (`ofdm_tx_np`, `dev/py/ofdm.py:276-325`):
    the symbol-0 pilot comb in EVERY OFDM symbol, per-symbol data bits in,
    and the "pilot IQ" slice `waveform[:, :, pilotCarriers, :]`, which
    indexes TIME samples at pilot-subcarrier positions (a quirk, kept);
  * `ofdm_transmitter_iq` (`ofdm_transmitter`, `dev/py/ofdm.py:384-451`):
    its own plan (`legacy_tx_plan`): CP fixed at 25 %, no DC null, guards
    split at both edges, pilots every (K//P)-th effective carrier, data
    carriers by a POSITIONAL delete (a quirk, kept); its pilot output is
    the reversed slice `waveform[:, :, CP : K//P : -1, :]`, built as an
    explicit index (torch has no negative step), empty where CP <= K//P.

Both scatter the constellation points into the grid, run the IDFT as a
matmul (`ops.cfloat.idft_iq`) and prepend the CP.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from dl_ofdm_tpu_torch.ofdm.constellation import bits_to_symbols
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan
from dl_ofdm_tpu_torch.ops import cfloat


def _modulate(sym_iq: torch.Tensor, nfft: int, data_carriers, pilot_carriers,
              pilot: tuple[float, float], cp_len: int) -> torch.Tensor:
    """[N, n_data, 2] points -> [N, K+CP, 2]: the grid with data and
    pilots, its IDFT, the CP prepended."""
    dev = sym_iq.device
    grid = sym_iq.new_zeros(sym_iq.shape[0], nfft, 2)
    grid[:, torch.as_tensor(data_carriers, device=dev)] = sym_iq
    grid[:, torch.as_tensor(pilot_carriers, device=dev)] = torch.tensor(
        pilot, dtype=sym_iq.dtype, device=dev)
    time = cfloat.idft_iq(grid)                         # [N, K, 2]
    return torch.cat([time[:, -cp_len:], time], dim=1)


def ofdm_modulate_symbol_pilots(bits: torch.Tensor, plan: SubcarrierPlan):
    """Per-symbol-pilot modulator (`ofdm_tx_np`).

    Args:
      bits: [n_sym, n_data, nbits] {0,1}, n_sym a multiple of plan.nsymbol,
        n_data == len(plan.data_carriers).
    Returns:
      (iq [n_frame, nsymbol, K+CP, 2],
       pilot_iq [n_frame, nsymbol, P, 2]: the time samples at the pilot
       carriers' indices, the reference's quirk).
    """
    n_sym, n_data, _ = bits.shape
    if n_data != len(plan.data_carriers):
        raise ValueError(f"per-symbol data size {n_data} != "
                         f"{len(plan.data_carriers)}")
    if n_sym % plan.nsymbol:
        raise ValueError(f"n_sym {n_sym} not a multiple of {plan.nsymbol}")
    with_cp = _modulate(bits_to_symbols(bits), plan.nfft, plan.data_carriers,
                        plan.pilot_carriers,
                        (plan.pilot_value.real, plan.pilot_value.imag),
                        plan.cp_len)
    iq = with_cp.reshape(-1, plan.nsymbol, plan.samples_per_symbol, 2)
    pilot_iq = iq[:, :, torch.as_tensor(plan.pilot_carriers,
                                        device=iq.device)]
    return iq, pilot_iq


@dataclasses.dataclass(frozen=True)
class LegacyTxPlan:
    """Static plan of the legacy in-graph TX (`dev/py/ofdm.py:391-407`):
    CP always 25 %, no DC null, data carriers from a positional (not value)
    delete of the pilot comb."""

    nfft: int
    cp_len: int
    n_pilot: int            # requested P; len(pilot_carriers) may be
                            # smaller (7 for K=64, G=8, P=8)
    n_guard: int
    data_carriers: np.ndarray
    pilot_carriers: np.ndarray
    guard_carriers: np.ndarray


@functools.lru_cache(maxsize=None)
def legacy_tx_plan(nfft: int, npilot: int, nguard: int) -> LegacyTxPlan:
    k, p, g = nfft, npilot, nguard
    all_carriers = np.arange(k)
    effec = all_carriers[g // 2: k - g // 2]
    pilot_carriers = effec[:: k // p]
    guard_carriers = np.delete(all_carriers, effec)
    # positional delete, exactly as the reference writes it
    data_carriers = np.delete(effec, pilot_carriers - g // 2)
    return LegacyTxPlan(nfft=k, cp_len=k // 4, n_pilot=p, n_guard=g,
                        data_carriers=data_carriers,
                        pilot_carriers=pilot_carriers,
                        guard_carriers=guard_carriers)


def ofdm_transmitter_iq(bits: torch.Tensor, nfft: int, npilot: int,
                        nguard: int):
    """Legacy in-graph transmitter (`ofdm_transmitter`).

    Args:
      bits: [B, n_sym, n_data, nbits] {0,1}, n_data ==
        len(legacy_tx_plan(...).data_carriers).
    Returns:
      (iq [B, n_sym, K+CP, 2],
       pilot_iq: `iq[:, :, CP : K//P : -1, :]`, the reference's reversed
       time-sample slice).
    """
    plan = legacy_tx_plan(nfft, npilot, nguard)
    b, n_sym, n_data, _ = bits.shape
    if n_data != len(plan.data_carriers):
        raise ValueError(f"data size {n_data} != {len(plan.data_carriers)}")
    sym_iq = bits_to_symbols(bits).reshape(b * n_sym, n_data, 2)
    with_cp = _modulate(sym_iq, plan.nfft, plan.data_carriers,
                        plan.pilot_carriers, (3.0, 3.0), plan.cp_len)
    iq = with_cp.reshape(b, n_sym, plan.nfft + plan.cp_len, 2)
    rev = torch.tensor(list(range(plan.cp_len, plan.nfft // plan.n_pilot,
                                  -1)), dtype=torch.int64, device=iq.device)
    return iq, iq[:, :, rev]
