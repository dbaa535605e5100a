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

`compute_dtype='bfloat16'` is flax's `nn.Dense(dtype=bf16)` in the three
Dense layers (`dl_ofdm_tpu/models/dccn.py:60-76`): inputs, weights and
biases cast to bf16, each product rounded once to bf16 (float32 sums in
`F.linear` without its bias), the bias added in bf16, leaky_relu and the
concat in bf16, and only the logits cast back to float32; `fft_like`
takes the flag as JAX's `ComplexDense` does (bf16 operands, float32 sums
and output).  Parameters stay float32.

Submodules keep the flax scope names, so `train.checkpoint.params_from_flax`
maps a flax param tree onto `state_dict()` keys one to one.  Parameters start
as flax's do: `lecun_normal` kernels (a normal truncated at 2 std, fan-in
variance) and zero biases, for the `nn.Linear` layers as for `ComplexDense`.

`DNNReceiver` is the all-dense ablation (`dl_ofdm_tpu/models/dccn.py:79-118`,
reference `ofdm_DNN_rx`, `dev/py/model.py:1539-1625`), its layers named
`Dense_0` ... `Dense_4` as flax names the layers it did not name itself;
`RxOutputs` is JAX's typed bundle of a receiver's outputs (`:31-41`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from dl_ofdm_tpu_torch.ops.complex_ops import ComplexDense, lecun_normal_
from dl_ofdm_tpu_torch.ops.norms import leaky_relu
from dl_ofdm_tpu_torch.ops.pallas_kernels import is_bf16


@dataclasses.dataclass
class RxOutputs:
    """Typed replacement of the reference's named-tensor graph ABI
    (`dev/py/ofdmreceiver_np.py:172-183`)."""
    logits: torch.Tensor          # [B, frame_size, nbits, 2]
    probs: torch.Tensor           # softmax of logits (the reference 'output')
    fft_out: torch.Tensor | None  # [B, S, F, 2] learned-transform activations
    equalized: torch.Tensor | None = None   # [B, S, n_sc, 2]
    snr_est_db: torch.Tensor | None = None  # [B, 1]
    chest: torch.Tensor | None = None       # [B, S, K, 2] channel estimate


def dense_bf16(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax `nn.Dense(dtype=bfloat16)`: x, weight and bias in bf16, the
    product rounded once to bf16 before the bf16 bias is added."""
    y = F.linear(x.to(torch.bfloat16), layer.weight.to(torch.bfloat16))
    return y + layer.bias.to(torch.bfloat16)


class DCCNReceiver(nn.Module):
    def __init__(self, nbits: int, nfft: int, cp_len: int, nfilter: int,
                 frame_size: int, nsymbol: int = 7, keep_cp: bool = True,
                 recombine: str = "true", compute_dtype: str | None = None):
        super().__init__()
        self.nbits, self.nfft, self.cp_len = nbits, nfft, cp_len
        self.nfilter, self.frame_size = nfilter, frame_size
        self.keep_cp = keep_cp
        self.compute_dtype = compute_dtype
        self.bf16 = is_bf16(compute_dtype)
        k_in = nfft + cp_len if keep_cp else nfft
        self.fft_like = ComplexDense(k_in, nfilter, recombine=recombine,
                                     compute_dtype=compute_dtype)
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

    def forward(self, x: torch.Tensor, tp=None):
        """x [B, S, K+CP, 2] -> (logits [B, frame_size, nbits, 2],
        fft_out [B, S, nfilter, 2]).  `tp` (a `parallel.tp.TensorParallel`
        of this module's keys) runs `fft_like` column-parallel and
        `Dense_extract` row-parallel over a dp row's tp ranks."""
        b, s = x.shape[0], x.shape[1]
        if not self.keep_cp:
            x = x[:, :, self.cp_len:self.cp_len + self.nfft, :]
        dense = dense_bf16 if self.bf16 else (lambda layer, v: layer(v))
        flat_shape = (b, s * self.nfilter * 2)
        if tp is None:
            fft_out = self.fft_like(x)                           # [B, S, F, 2]
            out = dense(self.Dense_extract, fft_out.reshape(flat_shape))
        else:
            fft_out = tp.complex_dense(self.fft_like, "fft_like", x)
            out = tp.row_linear(self.Dense_extract, "Dense_extract",
                                fft_out.reshape(flat_shape), self.bf16)
        out_iq = out.reshape(b, 1, self.frame_size, 2)
        h = leaky_relu(dense(self.Dense_conv1x1, out_iq))
        h = torch.cat([h, out_iq], dim=-1)
        h = leaky_relu(dense(self.Dense_llr, h))
        logits = h.reshape(b, self.frame_size, self.nbits, 2)
        return (logits.float() if self.bf16 else logits), fft_out


class DNNReceiver(nn.Module):
    """All-dense FC ablation receiver (`ofdm_DNN_rx`).

    The reference function is dead code whose last reshape folds the
    symbol axis into the batch; JAX's (and so this) implementation follows
    the architecture's evident intent (`dl_ofdm_tpu/models/dccn.py:79-102`):
    a per-symbol dense stack K*2 -> nfilter*2 -> 250 -> 125, the symbol
    axis flattened, then a frame-level head frame_size*2 and a per-symbol
    Dense(nbits*2), every layer followed by leaky_relu(0.2)."""

    def __init__(self, nbits: int, nfft: int, cp_len: int, nfilter: int,
                 frame_size: int, nsymbol: int = 7, keep_cp: bool = True):
        super().__init__()
        self.nbits, self.nfft, self.cp_len = nbits, nfft, cp_len
        self.nfilter, self.frame_size = nfilter, frame_size
        self.nsymbol, self.keep_cp = nsymbol, keep_cp
        k = nfft + cp_len if keep_cp else nfft
        widths = (k * 2, nfilter * 2, 250, 125)
        for i in range(3):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        self.Dense_3 = nn.Linear(nsymbol * 125, frame_size * 2)
        self.Dense_4 = nn.Linear(2, nbits * 2)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers (`lecun_normal` kernels, zero biases) from
        `generator`."""
        for i in range(5):
            layer = getattr(self, f"Dense_{i}")
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor):
        """x [B, S, K+CP, 2] -> (logits [B, frame_size, nbits, 2], None)."""
        b, s = x.shape[0], x.shape[1]
        if not self.keep_cp:
            x = x[:, :, self.cp_len:self.cp_len + self.nfft, :]
        out = x.reshape(b, s, -1)
        for i in range(3):
            out = leaky_relu(getattr(self, f"Dense_{i}")(out))
        out = leaky_relu(self.Dense_3(out.reshape(b, s * 125)))
        out = leaky_relu(self.Dense_4(out.reshape(b, self.frame_size, 2)))
        return out.reshape(b, self.frame_size, self.nbits, 2), None
