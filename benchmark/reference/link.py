"""The OFDM link in float64: the LTE-style subcarrier plan, the BPSK
transmitter, the static multipath channel of a 3GPP tap profile, AWGN and
the receiver's input normalization.

From the paper's link (Zhao et al., "Deep-Waveform", IEEE JSAC 39(8),
2021, arXiv:1810.07181) and the configuration files: nfft subcarriers, 7
OFDM symbols, a cyclic prefix of 25 % of nfft prepended, LTE resource
blocks (12 subcarriers each) around two DC subcarriers, pilots 3+3j on
every sixth effective subcarrier of symbols 0 and 4 (the second comb
shifted by 3), data on the rest; BPSK at +-4.24264 (3 sqrt 2 as the
reference's code rounds it); the IDFT scaled 1/N.  The channel is the
reference's: per-frame CN(0, 1) tap gains weighted by p / sqrt(sum p)
(linear powers), through the sinc fractional-delay matrix alpha[k, n] =
sinc(n - 4 - delay_k / Ts), convolved 'same' over the whole frame.  The
receiver input is (y - mean) / sqrt(var + 1e-9) / sqrt(2), the moments per
sample position over the frames of the batch (or of an SNR group).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import philox

F64, C128 = torch.float64, torch.complex128
BPSK_AMP = 4.24264
PILOT = 3 + 3j
SAMPLE_RATE = {64: 0.96e6, 128: 1.92e6, 256: 3.84e6, 512: 7.68e6,
               1024: 15.36e6}
RESOURCE_BLOCKS = {64: 4, 128: 8, 256: 15, 512: 25, 1024: 50}
# 3GPP TS 36.104 Annex B.2 delays (ns) and powers (dB); FIR lengths at
# 0.96 Msps as the reference's MATLAB exports have them
PROFILES = {"ETU": ([0, 50, 120, 200, 230, 500, 1600, 2300, 5000],
                    [-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0], 13)}


@dataclasses.dataclass(frozen=True)
class Plan:
    nfft: int
    nsymbol: int
    cp: int
    data_sc: np.ndarray     # frame-flattened [frame_size], ascending
    pilot_sc: np.ndarray

    @property
    def frame_size(self) -> int:
        return len(self.data_sc)

    @property
    def sps(self) -> int:
        return self.nfft + self.cp


def plan(nfft: int, nsymbol: int = 7) -> Plan:
    """The 'lte' pilot plan with the long cyclic prefix."""
    if nsymbol != 7:
        raise ValueError("the lte plan has 7 symbols")
    n_rb = RESOURCE_BLOCKS[nfft]
    guard = nfft - 2 - 12 * n_rb
    dc = {nfft // 2 - 1, nfft // 2}
    effec = np.array([c for c in range(guard // 2, nfft - guard // 2)
                      if c not in dc])
    step = math.ceil(len(effec) / (2 * n_rb))
    loc = np.arange(0, len(effec), step)
    pilots = np.concatenate([effec[np.sort(loc % len(effec))],
                             effec[np.sort((loc + 3) % len(effec))]
                             + 4 * nfft])
    effec_sc = np.concatenate([effec + s * nfft for s in range(nsymbol)])
    data = np.setdiff1d(effec_sc, pilots)
    return Plan(nfft, nsymbol, round(nfft * 0.25), data, np.sort(pilots))


def transmit(bits: torch.Tensor, p: Plan) -> torch.Tensor:
    """BPSK bits [B, frame_size] -> complex128 waveform [B, S, sps]."""
    dev = bits.device
    grid = torch.zeros(bits.shape[0], p.nsymbol * p.nfft, dtype=C128,
                       device=dev)
    grid[:, torch.from_numpy(p.data_sc).to(dev)] = (
        (2.0 * bits.to(F64) - 1.0) * BPSK_AMP).to(C128)
    grid[:, torch.from_numpy(p.pilot_sc).to(dev)] = PILOT
    t = torch.fft.ifft(grid.reshape(-1, p.nsymbol, p.nfft), dim=-1)
    return torch.cat([t[..., p.nfft - p.cp:], t], dim=-1)


def tap_profile(name: str, nfft: int):
    """(tap weights [taps], alpha [taps, n_fir]) of a 3GPP profile."""
    delays, powers, n_fir = PROFILES[name]
    if SAMPLE_RATE[nfft] != 0.96e6:
        raise ValueError("the pinned FIR lengths hold at 0.96 Msps")
    p_lin = 10.0 ** (np.asarray(powers) / 10.0)
    d = np.asarray(delays, np.float64) * SAMPLE_RATE[nfft] * 1e-9
    alpha = np.sinc(np.arange(n_fir)[None, :] - 4 - d[:, None])
    return p_lin / np.sqrt(p_lin.sum()), alpha


def fade(x: torch.Tensor, z: torch.Tensor, name: str,
         nfft: int) -> torch.Tensor:
    """x [B, L] complex, z [B, taps] CN(0, 1) gains -> 'same' convolution
    of each frame with its kernel sum_t z_t w_t alpha_t."""
    w, alpha = tap_profile(name, nfft)
    kern = (z * torch.from_numpy(w).to(z.device)) @ torch.from_numpy(
        alpha).to(z.device).to(C128)                     # [B, n_fir]
    n_fir, length = kern.shape[1], x.shape[1]
    off = (n_fir - 1) // 2
    xp = torch.nn.functional.pad(torch.view_as_real(x),
                                 (0, 0, n_fir, n_fir))
    xp = torch.view_as_complex(xp.contiguous())
    y = torch.zeros_like(x)
    for k in range(n_fir):
        s = n_fir + off - k
        y = y + xp[:, s:s + length] * kern[:, k:k + 1]
    return y


def normalize(y: torch.Tensor, groups: torch.Tensor | None = None,
              eps: float = 1e-9) -> torch.Tensor:
    """Receiver input from y [B, ...] complex: each real plane centred and
    scaled per position over the frames (of each group [B] int, if given),
    then divided by sqrt(2); returns float64 [B, ..., 2]."""
    r = torch.view_as_real(y)
    if groups is None:
        groups = torch.zeros(r.shape[0], dtype=torch.int64, device=r.device)
    out = torch.empty_like(r)
    for g in torch.unique(groups).tolist():
        sel = groups == g
        rg = r[sel]
        m = rg.mean(0, keepdim=True)
        v = ((rg - m) ** 2).mean(0, keepdim=True)
        out[sel] = (rg - m) / torch.sqrt(v + eps) / math.sqrt(2.0)
    return out


def noise_std(snr_db: torch.Tensor) -> torch.Tensor:
    """Per-component AWGN std of a unit-power signal at `snr_db`."""
    return math.sqrt(0.5) * 10.0 ** (-snr_db.to(F64) / 20.0)


def training_batch(seeds, n_frames: int, nfft: int, channel: str,
                   snr_db: float, device):
    """The frames the training step's synthesize kernel draws from its two
    seed words: (bits [B, frame_size] int64, receiver input [B, S, sps, 2]
    float64).  The faded signal is scaled to unit mean power over the
    batch, then the noise is added at the frame's std."""
    p = plan(nfft)
    rows = torch.arange(n_frames, device=device)
    bits = philox.words(seeds, rows, philox.STREAM_IDX, p.frame_size) & 1
    x = transmit(bits, p).reshape(n_frames, -1)
    if channel != "AWGN":
        n_taps = len(PROFILES[channel][0])
        g0, g1 = philox.box_muller(
            philox.words(seeds, rows, philox.STREAM_TAP1, n_taps),
            philox.words(seeds, rows, philox.STREAM_TAP2, n_taps))
        x = fade(x, torch.complex(g0, g1) * math.sqrt(0.5), channel, nfft)
    n0, n1 = philox.box_muller(
        philox.words(seeds, rows, philox.STREAM_NOISE1, x.shape[1]),
        philox.words(seeds, rows, philox.STREAM_NOISE2, x.shape[1]))
    std = noise_std(torch.full((n_frames, 1), float(snr_db), device=device))
    y = x / torch.sqrt((x.abs() ** 2).mean()) + torch.complex(n0, n1) * std
    rx = normalize(y.reshape(n_frames, p.nsymbol, p.sps))
    return bits, rx


def awgn_batch(bits: torch.Tensor, unit_noise: torch.Tensor,
               snr_db: torch.Tensor, groups: torch.Tensor, nfft: int):
    """The sweep's frames on AWGN from given draws: bits [B, frame_size],
    unit normals [B, S, sps, 2], per-frame SNR [B], SNR group [B] ->
    receiver input [B, S, sps, 2] float64, normalized per group."""
    p = plan(nfft)
    x = transmit(bits, p)
    noise = torch.view_as_complex(unit_noise.to(F64).contiguous())
    y = x / torch.sqrt((x.abs() ** 2).mean()) \
        + noise * noise_std(snr_db)[:, None, None]
    return normalize(y, groups)


def jax_bf16_normals() -> torch.Tensor:
    """The 128 values `jax.random.normal(key, shape, bfloat16)` takes (the
    noise the port's plain data plane draws): 7 random bits under the
    exponent of 1.0, minus 1, scaled to [lo, 1) with lo the bfloat16 just
    above -1, clamped at lo, sqrt(2) erfinv, all in bfloat16 arithmetic;
    float64 [128], entry i for the bits i."""
    bf = torch.bfloat16
    one, lo = torch.tensor(1.0, dtype=bf), torch.tensor(-0.99609375, dtype=bf)
    f = (torch.arange(128, dtype=torch.int16) | 0x3F80).view(bf) - one
    u = torch.maximum(lo, f * (one - lo) + lo)
    return (torch.tensor(2.0, dtype=bf).sqrt()
            * torch.special.erfinv(u)).to(F64)


def plain_awgn_shard(seed: int, n_frames: int, nfft: int, snr_db: float,
                     device):
    """A dp row's frames on AWGN as the port's plain data plane draws them
    from a generator seeded `seed`: the bits, the channel's unused tap gain,
    then 7 bits a unit normal (`jax_bf16_normals`); the signal scaled to
    unit power over the row, the noise added, the row normalized over its
    own frames.  Returns (bits [B, frame_size] int64, input float64)."""
    p = plan(nfft)
    g = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, (n_frames, p.frame_size, 1),
                         dtype=torch.int32, generator=g, device=device)
    torch.randn(n_frames, 1, 2, generator=g, device=device)
    idx = torch.randint(0, 128, (n_frames * p.nsymbol * p.sps * 2,),
                        dtype=torch.int32, generator=g, device=device)
    unit = jax_bf16_normals().to(device)[idx.long()].reshape(
        n_frames, p.nsymbol, p.sps, 2)
    x = transmit(bits[..., 0], p)
    noise = torch.view_as_complex(unit.contiguous())
    std = noise_std(torch.tensor(float(snr_db), device=device))
    y = x / torch.sqrt((x.abs() ** 2).mean()) + noise * std
    return bits[..., 0].to(torch.int64), normalize(y)
