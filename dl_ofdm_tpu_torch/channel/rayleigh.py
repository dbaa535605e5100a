"""Batched Rayleigh multipath fading channel (static profiles).

Port of `dl_ofdm_tpu/channel/rayleigh.py:56-160` (reference
`dev/py/radio.py:277-510`) for static fading: per-frame iid tap gains
zck ~ CN(0,1), FIR kernel gt = (zck * ch_coeff) @ alpha_matrix, 'same'
convolution over the whole frame and H = fft(gt, nfft) broadcast over
symbols.  'mixRayleigh' cycles frames over {flat, etu, eva, epa} and
'mixAll' over {awgn, flat, etu, eva, epa}; AWGN rows pass through with a
unit tap.  Jakes Doppler (`mobile=True`) is a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from dl_ofdm_tpu_torch.channel import fir
from dl_ofdm_tpu_torch.channel.profiles import TapProfile, get_profile
from dl_ofdm_tpu_torch.ops import cfloat


@dataclasses.dataclass
class ChannelOut:
    y: torch.Tensor        # [B, S, n_sc, 2] received IQ waveform
    h_freq: torch.Tensor   # [B, S, nfft, 2] ground-truth channel DFT (IQ)


def _pad_to(a: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    out = np.zeros(shape, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


class RayleighChannel:
    """Callable channel simulator: tx_iq [B, S, n_sc, 2] -> ChannelOut."""

    def __init__(self, channel: str = "etu", nfft: int = 64,
                 sample_rate: float = 0.96e6, mobile: bool = False,
                 weighting: str = "reference"):
        if mobile:
            raise NotImplementedError(
                "Jakes Doppler (mobile=True) is not ported yet: ROADMAP.md "
                "Queue A item 4 (channel/doppler.py and fir_per_symbol_iq)")
        self.channel = channel.lower()
        self.nfft = nfft
        self.sample_rate = sample_rate

        if self.channel == "mixrayleigh":
            names: Sequence[str] = ("flat", "etu", "eva", "epa")
            self._passthrough = np.zeros(len(names), dtype=bool)
        elif self.channel == "mixall":
            names = ("awgn", "flat", "etu", "eva", "epa")
            self._passthrough = np.asarray([True, False, False, False, False])
        else:
            names = (self.channel,)
            self._passthrough = np.asarray([self.channel == "awgn"])
        self.profiles: list[TapProfile] = [
            get_profile(n, sample_rate, weighting) for n in names]

        self.max_taps = max(p.n_taps for p in self.profiles)
        self.max_fir = max(p.n_fir for p in self.profiles)
        self._coeff_np = np.stack(
            [_pad_to(p.ch_coeff, (self.max_taps,)) for p in self.profiles]
        ).astype(np.float32)                        # [P, max_taps]
        self._alpha_np = np.stack(
            [_pad_to(p.alpha_matrix, (self.max_taps, self.max_fir))
             for p in self.profiles]).astype(np.float32)  # [P, taps, fir]
        self._offset_np = np.asarray([p.same_offset for p in self.profiles],
                                     dtype=np.int32)

    def _frame_profiles(self, n_frames: int) -> np.ndarray:
        p = len(self.profiles)
        if p == 1:
            return np.zeros(n_frames, dtype=np.int32)
        return (np.arange(n_frames) % p).astype(np.int32)

    def __call__(self, tx: torch.Tensor,
                 generator: torch.Generator | None = None,
                 zck: torch.Tensor | None = None) -> ChannelOut:
        """Args:
          tx: [B, S, n_sc, 2] float32 time-domain IQ frames.
          generator: draws the tap gains (the device's default when None).
          zck: [B, max_taps, 2] CN(0,1) tap gains to use instead of drawing
            them (tests feed both packages the same draws).  AWGN rows
            still take the unit tap.
        """
        b, s, n_sc, _ = tx.shape
        dev = tx.device
        prof_idx = self._frame_profiles(b)
        coeff = torch.from_numpy(self._coeff_np[prof_idx]).to(dev)
        alpha = torch.from_numpy(self._alpha_np[prof_idx]).to(dev)
        offsets = self._offset_np[prof_idx]

        if zck is None:
            zck = torch.randn(b, self.max_taps, 2, device=dev,
                              generator=generator) / math.sqrt(2.0)
        passthrough = self._passthrough[prof_idx]
        if passthrough.any():
            unit = torch.zeros(self.max_taps, 2, device=dev)
            unit[0, 0] = 1.0
            mask = torch.from_numpy(passthrough).to(dev)[:, None, None]
            zck = torch.where(mask, unit, zck)

        # per-frame FIR kernel: gt = (zck * coeff) @ alpha
        gt = torch.einsum("btc,btf->bfc", zck * coeff[..., None], alpha)
        h_freq = cfloat.dft_iq(gt, self.nfft)[:, None].expand(
            b, s, self.nfft, 2)
        y = fir.fir_same_iq(tx.reshape(b, s * n_sc, 2), gt, offsets)
        return ChannelOut(y=y.reshape(b, s, n_sc, 2), h_freq=h_freq)
