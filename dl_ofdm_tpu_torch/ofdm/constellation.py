"""Gray-mapped constellations and (de)mapping, as static lookup tables.

Port of `dl_ofdm_tpu/ofdm/constellation.py`: the same non-unit-power Gray
maps (reference `dev/py/ofdm.py:24-78`) and the same big-endian bit order
(`np.packbits` parity, `dev/py/ofdm.py:293-298`).  Symbols are IQ-last
`[..., 2]` float32 pairs rather than complex64, as everywhere in the port.
The classical baselines' MATLAB `qammod(..., 'gray')` tables and their
nearest-point demapper are here too (`constellation.py:82-113`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_BPSK_AMP = 4.24264  # 3*sqrt(2) rounded as in the reference
_8QAM_SCALE = 4.2426 / 3.1623  # |3+3j| / |3+1j|


@functools.lru_cache(maxsize=None)
def _table_np(nbits: int) -> np.ndarray:
    """Constellation LUT indexed by the big-endian integer of the bit tuple."""
    if nbits == 1:
        pts = [-_BPSK_AMP + 0j, _BPSK_AMP + 0j]
    elif nbits == 2:
        # (b0,b1): b0 flips Q sign, b1 selects the I sign
        pts = [-3 + 3j, 3 + 3j, -3 - 3j, 3 - 3j]
    elif nbits == 3:
        base = [-3 + 1j, 3 + 1j, -1 + 1j, 1 + 1j, -3 - 1j, 3 - 1j, -1 - 1j, 1 - 1j]
        pts = [p * _8QAM_SCALE for p in base]
    elif nbits == 4:
        pts = [
            -3 + 3j, 3 + 3j, -1 + 3j, 1 + 3j,
            -3 - 3j, 3 - 3j, -1 - 3j, 1 - 3j,
            -3 + 1j, 3 + 1j, -1 + 1j, 1 + 1j,
            -3 - 1j, 3 - 1j, -1 - 1j, 1 - 1j,
        ]
    else:
        raise ValueError("nbits must be in 1..4")
    return np.asarray(pts, dtype=np.complex64)


def const_table(nbits: int, device=None) -> torch.Tensor:
    """Reference constellation LUT, shape [2**nbits] complex64 (CPU/tests
    only; `const_table_iq` is the IQ table the port's paths use)."""
    return torch.from_numpy(_table_np(nbits)).to(device)


def const_table_iq(nbits: int, device=None) -> torch.Tensor:
    """Reference constellation LUT as IQ pairs, shape [2**nbits, 2] float32."""
    t = _table_np(nbits)
    return torch.tensor(np.stack([t.real, t.imag], -1), dtype=torch.float32,
                        device=device)


@functools.lru_cache(maxsize=None)
def _bit_table_np(nbits: int) -> np.ndarray:
    """[2**nbits, nbits] int32: big-endian bits of each symbol index."""
    idx = np.arange(2**nbits)
    return np.stack(
        [(idx >> (nbits - 1 - b)) & 1 for b in range(nbits)], axis=-1
    ).astype(np.int32)


def indices_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., nbits] {0,1} -> [...] symbol indices (big-endian, packbits-compatible)."""
    nbits = bits.shape[-1]
    weights = torch.tensor([1 << (nbits - 1 - b) for b in range(nbits)],
                           dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) * weights).sum(-1)


def bits_from_indices(idx: torch.Tensor, nbits: int) -> torch.Tensor:
    """[...] indices -> [..., nbits] int32 bits (big-endian)."""
    table = torch.from_numpy(_bit_table_np(nbits)).to(idx.device)
    return table[idx.to(torch.int64)]


def bits_to_symbols(bits: torch.Tensor) -> torch.Tensor:
    """Map [..., nbits] bits to IQ symbols [..., 2] via the reference LUT."""
    return const_table_iq(bits.shape[-1], bits.device)[indices_from_bits(bits)]


@functools.lru_cache(maxsize=None)
def _matlab_table_np(m: int) -> np.ndarray:
    """MATLAB `qammod(0:M-1, M, 'gray')` constellation (M in {2,4,8,16}),
    complex64.

    Equals the reference Python table with the per-symbol bit order reversed
    and without power scaling (BPSK +-1, 8QAM unscaled rectangle)."""
    nbits = int(np.log2(m))
    ref = _table_np(nbits)
    if nbits == 1:
        ref = ref / _BPSK_AMP
    elif nbits == 2:
        ref = ref / 3.0
    elif nbits == 3:
        ref = ref / _8QAM_SCALE
    out = np.empty_like(ref)
    for k in range(m):
        rev = int(f"{k:0{nbits}b}"[::-1], 2)
        out[k] = ref[rev]
    return out


def matlab_gray_table(m: int, device=None) -> torch.Tensor:
    """The MATLAB Gray table of M points as IQ pairs [M, 2] float32."""
    t = _matlab_table_np(m)
    return torch.tensor(np.stack([t.real, t.imag], -1), dtype=torch.float32,
                        device=device)


def demod_nearest(symbols: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Min-distance hard demapping (`qamdemod`,
    `dev/m/OFDM_Benchmark_dev.m:447`): IQ symbols [..., 2] and a table
    [M, 2] -> [...] int64 indices of the nearest points (the first on a
    tie)."""
    d2 = ((symbols[..., None, 0] - table[:, 0]) ** 2
          + (symbols[..., None, 1] - table[:, 1]) ** 2)
    return torch.argmin(d2, dim=-1)
