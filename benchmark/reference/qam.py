"""The OFDM link of a configuration with several bits a symbol, in float64:
the Gray maps of 1 to 4 bits a symbol, the transmitter that puts their
symbols on the lte plan, AWGN at one SNR over a whole batch, and the
receiver's counts over that batch as one group.

The maps are the paper's reference code's (Zhao et al., "Deep-Waveform",
IEEE JSAC 39(8), 2021, arXiv:1810.07181; `dev/py/ofdm.py:24-78` of its
code), not scaled to unit power (the link scales the waveform), and each
symbol's bits are read big-endian: bit 0 is the most significant bit of
the symbol's index, as `np.packbits` orders them.  BPSK at +-4.24264,
QPSK at +-3 +-3j, 8QAM the points {+-1, +-3} x {+-1j} scaled by
|3+3j| / |3+1j| (4.2426 / 3.1623 as the code rounds them), 16QAM
{+-1, +-3} x {+-1j, +-3j}.  The plan, the pilots, the IDFT with its cyclic
prefix, the SNR and the receiver's input normalization are `link.py`'s.

The control of a float32 configuration with TF32 off is the receiver in
TF32: `counts(..., precision="tf32")` rounds every GEMM operand of
`dccn.forward` to TF32's 10 mantissa bits (to nearest, ties to even) and
keeps the products and sums in float32, as the tensor cores' TF32 mode
computes them.
"""
from __future__ import annotations

import contextlib

import torch

from benchmark.reference import dccn, link

_8QAM = 4.2426 / 3.1623
GRAY = {
    1: [-link.BPSK_AMP, link.BPSK_AMP],
    2: [-3 + 3j, 3 + 3j, -3 - 3j, 3 - 3j],
    3: [_8QAM * p for p in (-3 + 1j, 3 + 1j, -1 + 1j, 1 + 1j,
                            -3 - 1j, 3 - 1j, -1 - 1j, 1 - 1j)],
    4: [-3 + 3j, 3 + 3j, -1 + 3j, 1 + 3j,
        -3 - 3j, 3 - 3j, -1 - 3j, 1 - 3j,
        -3 + 1j, 3 + 1j, -1 + 1j, 1 + 1j,
        -3 - 1j, 3 - 1j, -1 - 1j, 1 - 1j],
}


def symbol_index(bits: torch.Tensor) -> torch.Tensor:
    """[..., nbits] bits -> [...] int64 index, bit 0 the most significant."""
    n = bits.shape[-1]
    weights = torch.tensor([1 << (n - 1 - k) for k in range(n)],
                           dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) * weights).sum(-1)


def symbols(bits: torch.Tensor) -> torch.Tensor:
    """[..., nbits] bits -> [...] complex128 symbols of `GRAY[nbits]`."""
    table = torch.tensor(GRAY[bits.shape[-1]], dtype=link.C128,
                         device=bits.device)
    return table[symbol_index(bits)]


def transmit(bits: torch.Tensor, p: link.Plan) -> torch.Tensor:
    """bits [B, frame_size, nbits] -> complex128 waveform [B, S, sps]."""
    dev = bits.device
    grid = torch.zeros(bits.shape[0], p.nsymbol * p.nfft, dtype=link.C128,
                       device=dev)
    grid[:, torch.from_numpy(p.data_sc).to(dev)] = symbols(bits)
    grid[:, torch.from_numpy(p.pilot_sc).to(dev)] = link.PILOT
    t = torch.fft.ifft(grid.reshape(-1, p.nsymbol, p.nfft), dim=-1)
    return torch.cat([t[..., p.nfft - p.cp:], t], dim=-1)


def awgn_call(bits: torch.Tensor, unit_noise: torch.Tensor, snr_db: float,
              nfft: int) -> torch.Tensor:
    """A point_batch call's receiver input from given draws: bits
    [B, frame_size, nbits], unit normals [B, S, sps, 2], one SNR -> float64
    [B, S, sps, 2].  The waveform is scaled to unit mean power over the
    batch, the noise added at the SNR's std, and every frame normalized
    with moments over the whole batch."""
    x = transmit(bits, link.plan(nfft))
    noise = torch.view_as_complex(unit_noise.to(link.F64).contiguous())
    std = link.noise_std(torch.tensor(float(snr_db), device=bits.device))
    return link.normalize(x / torch.sqrt((x.abs() ** 2).mean()) + noise * std)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest with
    ties to even (finite values)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


@contextlib.contextmanager
def _tf32_operands():
    """`dccn.forward`'s operand rounding taking 'tf32' for the block."""
    operand = dccn._operand
    dccn._operand = lambda p: tf32 if p == "tf32" else operand(p)
    try:
        yield
    finally:
        dccn._operand = operand


def counts(params: dict, x: torch.Tensor, bits: torch.Tensor, nbits: int,
           precision: str = "float32"):
    """(bit errors [1] int64, summed per-frame CE [1] float64) of a batch
    normalized as one group: `dccn.eval_counts` in `precision` ('float32',
    'tf32' or 'fp8')."""
    groups = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    with _tf32_operands() if precision == "tf32" else \
            contextlib.nullcontext():
        return dccn.eval_counts(params, x, bits, groups, 1, nbits, precision)
