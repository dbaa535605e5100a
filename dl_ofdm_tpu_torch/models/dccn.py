"""DCCN receiver (Deep Complex-valued Convolutional Network).

Port of `DCCNReceiver` from `dl_ofdm_tpu/models/dccn.py` (reference
`ofdm_dense_rx`, `dev/py/model.py:1222-1292`):

  waveform IQ [B, S, K+CP, 2]
    -> optional CP strip (keep_cp=False)
    -> 'fft_like': learned-DFT complex dense K -> nfilter
    -> 'demodulation': flatten -> Dense(frame_size*2) -> per-symbol 1x1 conv
       (Dense(2^nbits)) -> leaky_relu(0.2) -> concat IQ -> Dense(nbits*2)
       -> leaky_relu(0.2)
    -> per-bit 2-class logits [B, frame_size, nbits, 2].

Submodules keep the flax scope names, so `train.checkpoint.params_from_flax`
maps a flax param tree onto `state_dict()` keys one to one.  Parameters start
as flax's do: `lecun_normal` kernels (a normal truncated at 2 std, fan-in
variance) and zero biases, for the `nn.Linear` layers as for `ComplexDense`.
"""
from __future__ import annotations

import torch
from torch import nn

from dl_ofdm_tpu_torch.ops.complex_ops import ComplexDense, lecun_normal_
from dl_ofdm_tpu_torch.ops.norms import leaky_relu


class DCCNReceiver(nn.Module):
    def __init__(self, nbits: int, nfft: int, cp_len: int, nfilter: int,
                 frame_size: int, nsymbol: int = 7, keep_cp: bool = True,
                 recombine: str = "true"):
        super().__init__()
        self.nbits, self.nfft, self.cp_len = nbits, nfft, cp_len
        self.nfilter, self.frame_size = nfilter, frame_size
        self.keep_cp = keep_cp
        k_in = nfft + cp_len if keep_cp else nfft
        self.fft_like = ComplexDense(k_in, nfilter, recombine=recombine)
        self.Dense_extract = nn.Linear(nsymbol * nfilter * 2, frame_size * 2)
        self.Dense_conv1x1 = nn.Linear(2, 2 ** nbits)
        self.Dense_llr = nn.Linear(2 ** nbits + 2, nbits * 2)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Draw every parameter afresh with flax's initializers (kernels
        `lecun_normal`, biases zero) from `generator`, which lies on the
        parameters' device (the default generator when None)."""
        self.fft_like.reset_parameters(generator)
        for layer in (self.Dense_extract, self.Dense_conv1x1, self.Dense_llr):
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor):
        """x [B, S, K+CP, 2] -> (logits [B, frame_size, nbits, 2],
        fft_out [B, S, nfilter, 2])."""
        b, s = x.shape[0], x.shape[1]
        if not self.keep_cp:
            x = x[:, :, self.cp_len:self.cp_len + self.nfft, :]
        fft_out = self.fft_like(x)                               # [B, S, F, 2]
        out = self.Dense_extract(fft_out.reshape(b, s * self.nfilter * 2))
        out_iq = out.reshape(b, 1, self.frame_size, 2)
        h = leaky_relu(self.Dense_conv1x1(out_iq))
        h = torch.cat([h, out_iq], dim=-1)
        h = leaky_relu(self.Dense_llr(h))
        return h.reshape(b, self.frame_size, self.nbits, 2), fft_out
