"""Composed receivers: the equalizer stage grafted in front of the DCCN.

Port of `dl_ofdm_tpu/models/receiver.py`.  The equalizer and the
pretrained receiver are submodules named as the flax scopes (`Equalizer`,
`receiver`); grafting is parameter surgery and freezing an optimizer mask
(`train.transfer`).
"""
from __future__ import annotations

import torch
from torch import nn

from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
from dl_ofdm_tpu_torch.models.equalizers import (EqSpec, Equalizer, dense,
                                                 reset_all)
from dl_ofdm_tpu_torch.ops import cfloat
from dl_ofdm_tpu_torch.ops.complex_ops import ComplexConv2d, ComplexDense
from dl_ofdm_tpu_torch.ops.norms import frame_layer_norm, leaky_relu


class SingleGraphEqualizedRx(nn.Module):
    """The single-graph equalized receiver `ofdm_equalized_rx`
    (`dev/py/model.py:1421-1535`): layer norm -> optional CP strip ->
    Dense -> learned DFT -> channel-estimation subnet (pilots,
    interpolation, (S, F) complex-conv refinement, phase equalization) ->
    demodulation head.  Returns (logits, freq, eq, chest)."""

    def __init__(self, nbits: int, nfft: int, cp_len: int, nfilter: int,
                 frame_size: int, nsymbol: int, pilot_size: int,
                 keep_cp: bool = True):
        super().__init__()
        self.nbits, self.nfft, self.cp_len = nbits, nfft, cp_len
        self.nfilter, self.frame_size = nfilter, frame_size
        self.nsymbol, self.pilot_size, self.keep_cp = nsymbol, pilot_size, keep_cp
        s, f = nsymbol, nfilter
        k = nfft + cp_len if keep_cp else nfft
        self.Dense_in = dense(k * 2, f * 2)
        self.fft_like = ComplexDense(f, f)
        self.Dense_pilot = dense(s * f * 2, pilot_size * 2)
        self.Dense_interp0 = dense(pilot_size * 2, s * f * 2)
        self.Dense_interp1 = dense(s * f * 2, s * f * 2)
        self.RefineConv = ComplexConv2d(1, 1, (s, f), padding="same")
        self.Dense_extract = dense(s * f * 2, frame_size * 2)
        self.Dense_llr = dense(4, nbits * 2)

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_all(self, generator)

    def forward(self, x: torch.Tensor):
        b, s, f = x.shape[0], self.nsymbol, self.nfilter
        h = frame_layer_norm(x)
        if not self.keep_cp:
            h = h[:, :, self.cp_len:self.cp_len + self.nfft, :]
        h = self.Dense_in(h.reshape(b, s, -1)).reshape(b, s, f, 2)
        freq = self.fft_like(h)                            # [B, S, F, 2]

        c = self.Dense_pilot(freq.reshape(b, s * f * 2))
        c = self.Dense_interp1(self.Dense_interp0(c))
        chest = self.RefineConv(c.reshape(b, s, f, 1, 2)).reshape(b, s, f, 2)
        h_norm = cfloat.conj_iq(chest) / (
            cfloat.abs_iq(chest, eps=1e-24)[..., None] + 1e-12)
        eq = cfloat.cmul_iq(freq, h_norm)

        o = self.Dense_extract(eq.reshape(b, s * f * 2))
        o = o.reshape(b, 1, self.frame_size, 2)
        o2 = torch.cat([leaky_relu(o), o], dim=-1)
        o2 = leaky_relu(self.Dense_llr(o2))
        logits = o2.reshape(b, self.frame_size, self.nbits, 2)
        return logits, freq, eq, chest


class EqualizedReceiver(nn.Module):
    """input IQ waveform -> (logits, fft_out, equalized, snr_db, chest)."""

    def __init__(self, nbits: int, nfft: int, cp_len: int, nfilter: int,
                 frame_size: int, nsymbol: int, pilot_size: int,
                 pilot_carriers, keep_cp: bool = True,
                 recombine: str = "true", eq_spec: EqSpec = EqSpec()):
        super().__init__()
        self.Equalizer = Equalizer(
            nfft=nfft, cp_len=cp_len, nsymbol=nsymbol, pilot_size=pilot_size,
            pilot_carriers=pilot_carriers, spec=eq_spec, keep_cp=keep_cp)
        self.receiver = DCCNReceiver(
            nbits=nbits, nfft=nfft, cp_len=cp_len, nfilter=nfilter,
            frame_size=frame_size, nsymbol=nsymbol, keep_cp=keep_cp,
            recombine=recombine)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.Equalizer.reset_parameters(generator)
        self.receiver.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        equalized, snr_db, chest = self.Equalizer(x)
        logits, fft_out = self.receiver(equalized)
        return logits, fft_out, equalized, snr_db, chest
