"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC'11) and the word layout of the training step's synthesize kernel,
frozen here so that the reference draws the frames the kernel draws.

Word j of stream `st` for frame row `row` is lane j % 4 of Philox4x32-10
under key (seed0, seed1) at counter (j // 4, st, row, 0).  Streams: 0 the
symbol indices, 1 and 2 the taps' two uniforms, 3 and 4 the noise's two
uniforms.  A uniform is (word >> 8) * 2^-24 + 2^-25 (never 0); a pair of
uniforms gives two normals by Box-Muller.
"""
from __future__ import annotations

import math

import torch

STREAM_IDX, STREAM_TAP1, STREAM_TAP2, STREAM_NOISE1, STREAM_NOISE2 = range(5)

_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)
_MASK = 0xFFFFFFFF


def _mul_hi_lo(a: int, b: torch.Tensor):
    """The high and low 32-bit words of a * b (b < 2^32) in int64 tensors,
    b split in 16-bit halves so that no product overflows."""
    lo16 = a * (b & 0xFFFF)
    hi16 = a * (b >> 16)
    low = lo16 + ((hi16 & 0xFFFF) << 16)
    return (low >> 32) + (hi16 >> 16), low & _MASK


def philox4x32_10(ctr: list, key: list) -> list:
    """Four counter words and two key words (int64 tensors or ints in
    [0, 2^32), broadcast together) -> the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + _WEYL[0]) & _MASK, (k1 + _WEYL[1]) & _MASK
        hi0, lo0 = _mul_hi_lo(_MUL[0], c0)
        hi1, lo1 = _mul_hi_lo(_MUL[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def words(seeds: tuple[int, int], rows: torch.Tensor, stream: int,
          n: int) -> torch.Tensor:
    """[len(rows), n] int64 words of `stream` for the frame rows `rows`."""
    blocks = -(-n // 4)
    dev = rows.device
    j = torch.arange(blocks, dtype=torch.int64, device=dev)[None, :]
    r = rows.to(torch.int64)[:, None]
    zero = torch.zeros((len(rows), blocks), dtype=torch.int64, device=dev)
    out = philox4x32_10([zero + j, zero + stream, zero + r, zero],
                        [int(seeds[0]), int(seeds[1])])
    return torch.stack(out, -1).reshape(len(rows), 4 * blocks)[:, :n]


def uniform(w: torch.Tensor) -> torch.Tensor:
    """Words -> uniforms in (0, 1), float64 (exact: 24 bits)."""
    return (w >> 8).to(torch.float64) * 2.0 ** -24 + 2.0 ** -25


def box_muller(w1: torch.Tensor, w2: torch.Tensor):
    """Two word planes -> two independent standard normal planes."""
    u1, u2 = uniform(w1), uniform(w2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(2.0 * math.pi * u2), r * torch.sin(2.0 * math.pi * u2)
