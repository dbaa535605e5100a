"""OFDM transmitter: bits -> QAM -> frame grid -> IFFT -> CP, on tensors.

Port of `dl_ofdm_tpu/ofdm/tx.py` (reference `dev/py/ofdm.py:328-380`):
constellation lookup, data/pilot subcarrier placement (pilot value 3+3j),
unscaled-forward / 1/N-inverse DFT and the CP prepend.  As in the JAX
package, small grids fold placement, IDFT and CP into one constant GEMM per
OFDM symbol (`_symbol_tx_operator`); large grids keep the grid/IDFT path.
`ofdm_modulate_frames` (complex64, `torch.fft.ifft`), `iq_split`,
`iq_join` and `OFDMTx` are the JAX module's complex-dtype oracle and class
API (`tx.py:201-246`), for the CPU and tests.
"""
from __future__ import annotations

import numpy as np
import torch

from dl_ofdm_tpu_torch.config import OFDMConfig
from dl_ofdm_tpu_torch.ofdm.constellation import (const_table,
                                                  const_table_iq,
                                                  indices_from_bits)
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan, build_plan
from dl_ofdm_tpu_torch.ops import cfloat

# plans are built once per config and cached (`plan._build_plan_cached`), so
# their identity keys the operator caches, as in the JAX module
_SYMBOL_OP_CACHE: dict[int, tuple] = {}
_DEVICE_OP_CACHE: dict[tuple, tuple] = {}


def _symbol_tx_operator(plan: SubcarrierPlan):
    """Per-symbol fused TX operator (`dl_ofdm_tpu/ofdm/tx.py:63`).

    Returns (counts [S], Wr [S, Dmax, sps], Wi, bias_iq [S, sps, 2]) where
    W[s, d] = idft_row(f of the d-th data SC of symbol s)[(u - cp) mod nfft]
    (zero rows beyond counts[s]) and bias is the pilots' waveform."""
    key = id(plan)
    hit = _SYMBOL_OP_CACHE.get(key)
    if hit is not None:
        return hit
    nfft, s_n, cp = plan.nfft, plan.nsymbol, plan.cp_len
    sps = nfft + cp
    t_idx = (np.arange(sps) - cp) % nfft
    f = np.arange(nfft)
    idft = np.exp(2j * np.pi * np.outer(f, t_idx) / nfft) / nfft  # [K, sps]
    s_of = plan.data_sc // nfft
    f_of = plan.data_sc % nfft
    if not np.all(np.diff(s_of) >= 0):
        raise ValueError("data_sc must be symbol-major sorted for the "
                         "per-symbol TX operator")
    counts = np.bincount(s_of, minlength=s_n)
    dmax = int(counts.max())
    w = np.zeros((s_n, dmax, sps), np.complex64)
    d_in_sym = np.concatenate([np.arange(c) for c in counts])
    for j in range(plan.frame_size):
        w[s_of[j], d_in_sym[j]] = idft[f_of[j]]
    bias = np.zeros((s_n, sps), np.complex64)
    for p in plan.pilot_sc:
        sp, fp = p // nfft, p % nfft
        bias[sp] += plan.pilot_value * idft[fp]
    out = (tuple(int(c) for c in counts),
           w.real.astype(np.float32), w.imag.astype(np.float32),
           np.stack([bias.real, bias.imag], -1).astype(np.float32))
    _SYMBOL_OP_CACHE[key] = out
    return out


def _symbol_operator_on(plan: SubcarrierPlan, device: torch.device):
    """The operator's tensors on `device`, plus the gather index that packs
    a frame's data symbols into [S, Dmax] rows (pads point at a zero row)."""
    key = (id(plan), str(device))
    hit = _DEVICE_OP_CACHE.get(key)
    if hit is not None:
        return hit
    counts, wr, wi, bias = _symbol_tx_operator(plan)
    dmax = max(counts)
    pack = np.full((len(counts), dmax), plan.frame_size, np.int64)
    start = 0
    for s, c in enumerate(counts):
        pack[s, :c] = np.arange(start, start + c)
        start += c
    out = tuple(torch.from_numpy(a).to(device)
                for a in (pack.reshape(-1), wr, wi, bias))
    _DEVICE_OP_CACHE[key] = out
    return out


def _tx_symbol_op_fits(plan: SubcarrierPlan) -> bool:
    """`_fused_tx_profitable`: the per-symbol operator for grids whose
    constant stays within 32 MiB (all nfft <= 512 plans)."""
    _, wr, _, _ = _symbol_tx_operator(plan)
    return 2 * wr.nbytes <= 32 * 2**20


def ofdm_modulate_frames_iq(bits: torch.Tensor, plan: SubcarrierPlan,
                            fused: bool | None = None) -> torch.Tensor:
    """Real-pair OFDM modulator: [B, frame_size, nbits] -> [B, S, K+CP, 2].

    Port of `dl_ofdm_tpu/ofdm/tx.py:130`.  `fused=None` picks the per-symbol
    operator where it fits (`_tx_symbol_op_fits`); `fused=True` forces it and
    `fused=False` forces the grid path (scatter -> IDFT -> CP)."""
    n_frame = bits.shape[0]
    if bits.shape[1] != plan.frame_size:
        raise ValueError(
            f"bits frame_size {bits.shape[1]} != plan frame_size {plan.frame_size}")
    nbits = bits.shape[-1]
    table_iq = const_table_iq(nbits, bits.device)
    if nbits == 1:
        # affine in the bit: no gather at all
        b_f = bits[..., 0].to(torch.float32)
        sym_iq = table_iq[0] + b_f[..., None] * (table_iq[1] - table_iq[0])
    else:
        sym_iq = table_iq[indices_from_bits(bits)]       # [B, frame, 2]

    if fused is None:
        fused = _tx_symbol_op_fits(plan)
    if fused:
        pack, wr, wi, bias = _symbol_operator_on(plan, bits.device)
        s_n, dmax, _ = wr.shape
        padded = torch.cat([sym_iq, sym_iq.new_zeros(n_frame, 1, 2)], dim=1)
        sp = padded[:, pack].reshape(n_frame, s_n, dmax, 2)
        sr, si = sp[..., 0], sp[..., 1]
        yr = (torch.einsum("bsd,sdt->bst", sr, wr)
              - torch.einsum("bsd,sdt->bst", si, wi) + bias[:, :, 0])
        yi = (torch.einsum("bsd,sdt->bst", sr, wi)
              + torch.einsum("bsd,sdt->bst", si, wr) + bias[:, :, 1])
        return torch.stack([yr, yi], dim=-1)

    dev = bits.device
    grid = torch.zeros(n_frame, plan.nsymbol * plan.nfft, 2, device=dev)
    grid[:, torch.from_numpy(plan.data_sc).to(dev)] = sym_iq
    grid[:, torch.from_numpy(plan.pilot_sc).to(dev)] = torch.tensor(
        [plan.pilot_value.real, plan.pilot_value.imag], device=dev)
    grid = grid.reshape(n_frame, plan.nsymbol, plan.nfft, 2)
    time = cfloat.idft_iq(grid)                          # [B, S, K, 2]
    return torch.cat([time[:, :, -plan.cp_len:], time], dim=2)


def ofdm_modulate_frames(bits: torch.Tensor,
                         plan: SubcarrierPlan) -> torch.Tensor:
    """The complex oracle of `ofdm_modulate_frames_iq`: [n_frame,
    frame_size, nbits] bits -> complex64 [n_frame, nsymbol, nfft + cp_len]
    (grid placement, `torch.fft.ifft`, CP prepend)."""
    n_frame = bits.shape[0]
    if bits.shape[1] != plan.frame_size:
        raise ValueError(
            f"bits frame_size {bits.shape[1]} != plan frame_size {plan.frame_size}")
    dev = bits.device
    symbols = const_table(bits.shape[-1], dev)[indices_from_bits(bits)]
    grid = torch.zeros(n_frame, plan.nsymbol * plan.nfft,
                       dtype=torch.complex64, device=dev)
    grid[:, torch.from_numpy(plan.data_sc).to(dev)] = symbols
    grid[:, torch.from_numpy(plan.pilot_sc).to(dev)] = complex(
        plan.pilot_value)
    time = torch.fft.ifft(grid.reshape(n_frame, plan.nsymbol, plan.nfft),
                          dim=-1).to(torch.complex64)
    return torch.cat([time[..., -plan.cp_len:], time], dim=-1)


# the canonical IQ <-> complex conversions live in ops.cfloat; these aliases
# keep the TX module's public names (`tx.py:231-232`)
iq_split = cfloat.from_complex
iq_join = cfloat.to_complex


class OFDMTx:
    """The reference `ofdm_tx` class API (`tx.py:235-246`): holds the plan
    and modulates frames."""

    def __init__(self, cfg: OFDMConfig):
        self.cfg = cfg
        self.plan = build_plan(cfg)

    def __call__(self, bits: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """(complex waveform [B, S, K+CP], its IQ view [B, S, K+CP, 2])."""
        wf = ofdm_modulate_frames(bits, self.plan)
        return wf, iq_split(wf)
