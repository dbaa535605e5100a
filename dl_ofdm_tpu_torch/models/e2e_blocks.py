"""Legacy end-to-end autoencoder blocks: channel-coding emulation.

Port of `dl_ofdm_tpu/models/e2e_blocks.py:24-96` (reference
`dev/py/model.py:80-206`, used by neither of the reference's two main
programs):

  * DenseBlockTx: FC channel-encoder emulation, Dense(codein) -> concat
    skip -> Dense(codeout), tanh head (`:80-117`);
  * ConvBlockTx: learned constellation mapper, 4x tanh Dense(2^nbits) ->
    Dense(2) -> 2 tanh, optionally an (S, 1) complex-conv waveform shaping
    (`:121-148`);
  * ConvBlockRx: the mirror of ConvBlockTx (`:151-173`);
  * DenseBlockRx: FC decoder with a skip concat -> per-bit logits
    (`:176-206`).

flax infers the layers' input widths at the first call; a torch module
takes them at construction (`n_sc`, `nsymbol`, `channels`).  The layer
names are flax's, so `train.checkpoint.params_from_flax` maps a flax tree
one to one.  `ShapeConv` is `ComplexConv2d` with an (S, 1) kernel and
'same' padding, n_sc filters, their mean taken over the filter axis.
"""
from __future__ import annotations

import torch
from torch import nn

from dl_ofdm_tpu_torch.models.equalizers import dense, reset_all
from dl_ofdm_tpu_torch.ops.complex_ops import ComplexConv2d
from dl_ofdm_tpu_torch.ops.norms import leaky_relu


class _Block(nn.Module):
    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_all(self, generator)


def _shape_conv(n_sc: int, nsymbol: int) -> ComplexConv2d:
    return ComplexConv2d(1, n_sc, (nsymbol, 1), padding="same")


def _shape(conv: ComplexConv2d, h: torch.Tensor) -> torch.Tensor:
    """[B, S, n_sc, 2] -> the (S, 1) complex conv's n_sc filters, their
    mean: one waveform stream [B, S, n_sc, 2]."""
    b, s, n_sc, _ = h.shape
    return conv(h.reshape(b, s, n_sc, 1, 2)).mean(dim=3)


class DenseBlockTx(_Block):
    """[B, S, n_sc, nbits] bits -> [B, S, n_sc*codeout//codein, nbits]."""

    def __init__(self, codein: int, codeout: int, n_sc: int, nbits: int):
        super().__init__()
        self.codein, self.codeout, self.n_sc, self.nbits = (codein, codeout,
                                                            n_sc, nbits)
        self.n_sc_out = (codeout * n_sc) // codein
        self.Dense_code1 = dense(n_sc * nbits, n_sc * nbits)
        self.Dense_code2 = dense(2 * n_sc * nbits, self.n_sc_out * nbits)

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        b, s, n_sc, nbits = bits.shape
        x = bits.reshape(b * s, n_sc * nbits).to(torch.float32)
        h = leaky_relu(self.Dense_code1(x))
        h = torch.tanh(self.Dense_code2(torch.cat([x, h], dim=1)))
        return h.reshape(b, s, self.n_sc_out, nbits)


class ConvBlockTx(_Block):
    """[B, S, n_sc, nbits] -> [B, S, n_sc, 2]: a learned IQ mapping."""

    def __init__(self, nbits: int, n_sc: int, nsymbol: int,
                 use_conv: bool = True):
        super().__init__()
        self.nbits, self.use_conv = nbits, use_conv
        width = nbits
        for i in range(4):
            setattr(self, f"Dense_map{i}", dense(width, 2 ** nbits))
            width = 2 ** nbits
        self.Dense_iq = dense(width, 2)
        if use_conv:
            self.ShapeConv = _shape_conv(n_sc, nsymbol)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(torch.float32)
        for i in range(4):
            h = torch.tanh(getattr(self, f"Dense_map{i}")(h))
        h = 2.0 * torch.tanh(self.Dense_iq(h))
        return _shape(self.ShapeConv, h) if self.use_conv else h


class ConvBlockRx(_Block):
    """[B, S, n_sc, 2] -> [B, S, n_sc, 2^nbits]."""

    def __init__(self, nbits: int, n_sc: int, nsymbol: int,
                 use_conv: bool = True):
        super().__init__()
        self.nbits, self.use_conv = nbits, use_conv
        if use_conv:
            self.ShapeConv = _shape_conv(n_sc, nsymbol)
        width = 2
        for i in range(4):
            setattr(self, f"Dense_demap{i}", dense(width, 2 ** nbits))
            width = 2 ** nbits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _shape(self.ShapeConv, x) if self.use_conv else x
        for i in range(4):
            h = leaky_relu(getattr(self, f"Dense_demap{i}")(h))
        return h


class DenseBlockRx(_Block):
    """[B, S, n_sc, channels] -> per-bit logits [B, frame_size, nbits,
    nllr]: the symbols' outputs averaged."""

    def __init__(self, frame_size: int, nbits: int, n_sc: int, channels: int,
                 nllr: int = 2):
        super().__init__()
        self.frame_size, self.nbits, self.nllr = frame_size, nbits, nllr
        self.Dense_rx1 = dense(n_sc * channels, n_sc * nbits)
        self.Dense_rx2 = dense(n_sc * (channels + nbits),
                               frame_size * nbits * nllr)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, n_sc, c = x.shape
        h = x.reshape(b, s, n_sc * c)
        enc = leaky_relu(self.Dense_rx1(h))
        h = leaky_relu(self.Dense_rx2(torch.cat([h, enc], dim=2)))
        return h.mean(dim=1).reshape(b, self.frame_size, self.nbits,
                                     self.nllr)
