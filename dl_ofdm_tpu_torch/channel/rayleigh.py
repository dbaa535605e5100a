"""Batched Rayleigh multipath fading channel.

Port of `dl_ofdm_tpu/channel/rayleigh.py:58-206` (reference
`dev/py/radio.py:277-510`):

  * static fading: per-frame iid tap gains zck ~ CN(0,1), FIR kernel
    gt = (zck * ch_coeff) @ alpha_matrix, 'same' convolution over the whole
    frame, H = fft(gt, nfft) broadcast over symbols;
  * Doppler fading (`mobile=True`): Jakes sum-of-sinusoids gains per OFDM
    symbol, a per-symbol FIR with n_taps look-back (`fir_per_symbol_iq`)
    and a per-symbol H;
  * mixes: 'mixRayleigh' cycles frames over {flat, etu, eva, epa} and
    'mixAll' over {awgn, flat, etu, eva, epa}; AWGN rows pass through with
    a unit tap; with `mix` on, Doppler applies to every 3rd (resp. 4th)
    frame.

The JAX package's opt-in `_partition_doppler` path (`rayleigh.py:172-196`,
off by default, same `y`) is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from dl_ofdm_tpu_torch.channel import fir
from dl_ofdm_tpu_torch.channel.doppler import (jakes_gains_from_phases,
                                               jakes_phases)
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
                 mix: bool = False, weighting: str = "reference"):
        self.channel = channel.lower()
        self.nfft = nfft
        self.sample_rate = sample_rate
        self.mobile = mobile
        self.mix = mix

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
        fd = [p.fd_mobile if mobile else 0.0 for p in self.profiles]
        self._fd_np = np.asarray(fd, dtype=np.float32)
        # does any frame ever take the Doppler path?
        self.has_doppler = mobile and any(f > 0.1 for f in fd) and \
            (mix or len(self.profiles) == 1)

    def _frame_profiles(self, n_frames: int) -> np.ndarray:
        p = len(self.profiles)
        if p == 1:
            return np.zeros(n_frames, dtype=np.int32)
        return (np.arange(n_frames) % p).astype(np.int32)

    def _frame_doppler_mask(self, n_frames: int,
                            prof_idx: np.ndarray) -> np.ndarray:
        """Which frames take the Doppler path (static bool mask)."""
        if not self.mobile:
            return np.zeros(n_frames, dtype=bool)
        fd = self._fd_np[prof_idx]
        if self.channel == "mixrayleigh":
            sel = (np.arange(n_frames) % 3 == 0) & self.mix
        elif self.channel == "mixall":
            sel = (np.arange(n_frames) % 4 == 0) & self.mix
        else:
            sel = np.ones(n_frames, dtype=bool)
        return sel & (fd > 0.1)

    def __call__(self, tx: torch.Tensor,
                 generator: torch.Generator | None = None,
                 zck: torch.Tensor | None = None,
                 theta: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> ChannelOut:
        """Args:
          tx: [B, S, n_sc, 2] float32 time-domain IQ frames.
          generator: draws the static tap gains, then (where a frame takes
            the Doppler path) the Jakes phases; the device's default when
            None.
          zck: [B, max_taps, 2] CN(0,1) tap gains to use instead of drawing
            them (tests feed both packages the same draws).  AWGN rows
            still take the unit tap.
          theta: (th_re, th_im) [B, SS, max_taps] Jakes phases to use
            instead of drawing them.
        """
        b, s, n_sc, _ = tx.shape
        dev = tx.device
        prof_idx = self._frame_profiles(b)
        dop_mask = self._frame_doppler_mask(b, prof_idx)
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
        y = fir.fir_same_iq(tx.reshape(b, s * n_sc, 2), gt,
                            offsets).reshape(b, s, n_sc, 2)
        if not (self.has_doppler and dop_mask.any()):
            h_freq = cfloat.dft_iq(gt, self.nfft)[:, None].expand(
                b, s, self.nfft, 2)
            return ChannelOut(y=y, h_freq=h_freq)

        # Doppler: per-symbol gains on the masked frames, static elsewhere
        if theta is None:
            theta = jakes_phases(b, self.max_taps, generator, dev)
        fd = torch.from_numpy(self._fd_np[prof_idx]).to(dev)
        t = torch.arange(s, dtype=torch.float32, device=dev) * (
            n_sc / self.sample_rate)
        zck_dop = jakes_gains_from_phases(*theta, fd, t, self.max_taps)
        if passthrough.any():
            zck_dop = torch.where(mask[..., None], unit, zck_dop)
        dop = torch.from_numpy(dop_mask).to(dev)[:, None, None, None]
        zck_s = torch.where(dop, zck_dop, zck[:, None])
        gt_s = torch.einsum("bstc,btf->bsfc", zck_s * coeff[:, None, :, None],
                            alpha)                      # [B, S, max_fir, 2]
        h_freq = cfloat.dft_iq(gt_s, self.nfft)         # [B, S, nfft, 2]
        y_dop = fir.fir_per_symbol_iq(tx, gt_s, self.max_taps, offsets)
        return ChannelOut(y=torch.where(dop, y_dop, y), h_freq=h_freq)

    # -- complex-dtype convenience wrapper (CPU/tests only) -----------------
    def apply_complex(self, tx_c: torch.Tensor,
                      generator: torch.Generator | None = None,
                      zck: torch.Tensor | None = None,
                      theta: tuple[torch.Tensor, torch.Tensor] | None = None
                      ) -> ChannelOut:
        """`__call__` on complex frames [B, S, n_sc]: complex64 y and
        h_freq (`rayleigh.py:209-213`); the draws as for `__call__`."""
        out = self(cfloat.from_complex(tx_c), generator, zck=zck, theta=theta)
        return ChannelOut(y=cfloat.to_complex(out.y),
                          h_freq=cfloat.to_complex(out.h_freq))
