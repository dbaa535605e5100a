"""The equalizer stage of the paper's receiver (Zhao et al., "Deep-Waveform",
IEEE JSAC 39(8), 2021, arXiv:1810.07181; the reference code's
channel-estimation and equalization subnetwork, `dev/py/model.py:349-1218`,
grafted in front of the pretrained DCCN by
`dev/py/ofdmreceiver_np_mp.py:264-322`), variant 12, its loss and Adam on
the equalizer alone, in plain float32 PyTorch.

Variant 12 (zero-forcing division, regularizer 0.1), one frame of S = 7
symbols of K = nfft subcarriers with the cyclic prefix kept (n_sc = K + CP
samples a symbol), x [B, S, n_sc, 2]:

  front    layer norm over the frame (population variance, eps 1e-12, no
           affine) -> Dense_in per symbol (2 n_sc -> 2K) -> ToFreq, a
           complex dense K -> K (the learned DFT)                -> Y
  chest    Dense_pilot (2SK -> 2P, P the frame's pilots) -> Dense_interp0
           (2P -> 2SK) -> Dense_interp1 (2SK -> 2SK), no activations ->
           tanh(Dense_block0) (2SK -> 2SK) -> BlockConv0, a complex 2-D
           convolution with an (S, K) kernel over the (S, K) grid, 'same'
           padding as XLA pads it (the odd pixel after)          -> H
  equalize Hn = H / rms(H) over the frame; E = Y conj(Hn) / (|Hn|^2 + 0.1);
           the power feature E conj(E) through CorrT, E through ToTime
           (complex dense K -> K each); their (re, im) pairs side by side
           per subcarrier -> Dense_out per symbol (4K -> 2 n_sc) -> the
           equalized waveform [B, S, n_sc, 2]; the SNR estimate: log10 of
           the mean over the variance (population) of |E|^2 on the pilot
           comb of the first pilot symbol, over every symbol, clipped to
           [1e-3, 1e4] (the reference's log10 without the x10)

then the frozen DCCN receiver (`benchmark/reference/dccn.py`) on the
equalized waveform.  Loss: the mean 2-class cross entropy over every bit
plus 1e-3 x 0.01 x the squared norm of every Dense layer's weight and bias,
the frozen receiver's included (`ofdmreceiver_np_mp.py:338`: the
equalizer stage's coefficient 1e-3 on the reference's `l2(0.01)`
regularizers).  Adam (b1 0.9, b2 0.999, eps 1e-8) on the equalizer's
parameters only; the receiver takes no gradient.

Parameters are keyed as the equalized receiver's `state_dict` keys them:
`Equalizer.<layer>.<leaf>` and `receiver.<leaf>` (`weight` [out, in] as
`torch.nn.Linear` keeps it; a complex dense layer's `wr`, `wi` [K, F] and
`br`, `bi` [F]; the convolution's `wr`, `wi` [S, K, 1, 1] (HWIO) and `br`,
`bi` [1]).  A complex product is computed here as one real product of the
stacked planes, [xr, xi] [[wr, wi], [-wi, wr]], and the complex
convolution as one real convolution of two channels to two.

`precision` is 'float32' (TF32 off for matmuls and convolutions) or 'fp8'
(every product's two operands, forward and backward, scaled per tensor to
the e4m3 range and rounded: the control).

Departures from the reference code, each where the configuration asks it:
  * the receiver keeps the cyclic prefix (`cp` true), so Dense_in reads
    2 n_sc values a symbol, as the committed BPSK arm was trained;
  * the reference code's power feature is the "autocorrelation" E conj(E)
    (`model.py:437-440`), a real power in a complex pair; it is kept as
    the code has it;
  * the SNR estimate is in log10 units, as the code computes it, not dB;
  * the channel: the reference repeats the program's first steps on the
    batches the program's own data plane produced (bits, receiver input,
    true channel, SNRs).  The mixRayleigh Jakes-Doppler channel is not
    derived again here (`link.py` covers AWGN and static ETU only); the
    comparison holds the model, its loss, its gradients and Adam to the
    program's, on the program's frames.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import dccn

ZF_EPS = 0.1
EQ_REG = 1e-3
PREFIX = "Equalizer."


def _dense(p, name, v, q):
    return q(v) @ q(p[f"{PREFIX}{name}.weight"]).T \
        + p[f"{PREFIX}{name}.bias"]


def _stacked(wr, wi):
    """[[wr, wi], [-wi, wr]]: the real form of a complex weight."""
    return torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)], 0)


def _cdense(p, name, v, q):
    """A complex dense layer on the last axis but one: [..., K, 2] ->
    [..., F, 2]."""
    w = _stacked(p[f"{PREFIX}{name}.wr"], p[f"{PREFIX}{name}.wi"])
    y = q(torch.cat([v[..., 0], v[..., 1]], -1)) @ q(w)
    f = y.shape[-1] // 2
    return torch.stack([y[..., :f] + p[f"{PREFIX}{name}.br"],
                        y[..., f:] + p[f"{PREFIX}{name}.bi"]], -1)


def _same_pads(size: int, k: int):
    total = k - 1
    return total // 2, total - total // 2


def _cconv(p, name, v, q):
    """A one-channel complex convolution over the (S, K) grid with 'same'
    padding: v [B, S, K, 2] -> [B, S, K, 2]."""
    wr = p[f"{PREFIX}{name}.wr"][:, :, 0, 0]
    wi = p[f"{PREFIX}{name}.wi"][:, :, 0, 0]
    # out channel 0 = re = xr*wr - xi*wi, out channel 1 = im = xr*wi + xi*wr
    w = torch.stack([torch.stack([wr, -wi]), torch.stack([wi, wr])])
    (t, b), (l, r) = _same_pads(v.shape[1], wr.shape[0]), _same_pads(
        v.shape[2], wr.shape[1])
    x = F.pad(v.permute(0, 3, 1, 2), (l, r, t, b))
    y = F.conv2d(q(x), q(w)).permute(0, 2, 3, 1)
    return y + torch.stack([p[f"{PREFIX}{name}.br"],
                            p[f"{PREFIX}{name}.bi"]], -1).reshape(2)


def equalizer_forward(p: dict, x: torch.Tensor, pilot_comb,
                      precision: str = "float32"):
    """x [B, S, n_sc, 2] -> (equalized [B, S, n_sc, 2], SNR estimate
    [B, 1], channel estimate [B, S, K, 2])."""
    q = dccn._operand(precision)
    b, s, n_sc, _ = x.shape
    k = p[f"{PREFIX}ToFreq.wr"].shape[0]
    m = x.mean(dim=(1, 2, 3), keepdim=True)
    v = ((x - m) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    h = ((x - m) / torch.sqrt(v + 1e-12)).reshape(b, s, n_sc * 2)
    freq = _cdense(p, "ToFreq", _dense(p, "Dense_in", h, q).reshape(
        b, s, k, 2), q)
    c = _dense(p, "Dense_pilot", freq.reshape(b, -1), q)
    c = _dense(p, "Dense_interp1", _dense(p, "Dense_interp0", c, q), q)
    c = torch.tanh(_dense(p, "Dense_block0", c, q))
    chest = _cconv(p, "BlockConv0", c.reshape(b, s, k, 2), q)
    hc = torch.complex(chest[..., 0], chest[..., 1])
    hn = hc / (torch.sqrt((hc.abs() ** 2).mean(dim=(1, 2), keepdim=True))
               + 1e-12)
    y = torch.complex(freq[..., 0], freq[..., 1])
    e = y * hn.conj() / (hn.abs() ** 2 + ZF_EPS)
    e_iq = torch.view_as_real(e)
    corr = torch.view_as_real(e * e.conj())
    feats = torch.cat([_cdense(p, "ToTime", e_iq, q),
                       _cdense(p, "CorrT", corr, q)], -1)
    out = _dense(p, "Dense_out", feats.reshape(b, s, -1), q)
    pw = (e.abs() ** 2)[:, :, list(pilot_comb)].reshape(b, -1)
    snr = torch.clamp(pw.mean(1, keepdim=True)
                      / (pw.var(1, unbiased=False, keepdim=True) + 1e-12),
                      1e-3, 1e4)
    return out.reshape(b, s, n_sc, 2), torch.log10(snr), chest


def receiver_params(p: dict) -> dict:
    return {k[len("receiver."):]: v for k, v in p.items()
            if k.startswith("receiver.")}


def forward(p: dict, x: torch.Tensor, pilot_comb, nbits: int,
            precision: str = "float32"):
    """(logits [B, D, nbits, 2], equalized, SNR estimate, channel
    estimate)."""
    eq, snr, chest = equalizer_forward(p, x, pilot_comb, precision)
    logits = dccn.forward(receiver_params(p), eq, nbits, precision)
    return logits, eq, snr, chest


def loss(p: dict, x: torch.Tensor, bits: torch.Tensor, pilot_comb,
         nbits: int, precision: str = "float32") -> torch.Tensor:
    """CE + 1e-3 x 0.01 x the squared norm of every Dense leaf; bits
    [B, D * nbits] (0/1)."""
    logits = forward(p, x, pilot_comb, nbits, precision)[0].reshape(-1, 2)
    ce = F.cross_entropy(logits, bits.reshape(-1).to(torch.int64))
    l2 = 0.01 * sum(torch.sum(v * v) for k, v in p.items() if "Dense" in k)
    return ce + EQ_REG * l2


def train_steps(params: dict, batches, pilot_comb, nbits: int, train: dict,
                precision: str = "float32") -> dict:
    """Adam steps on the `Equalizer.*` leaves from `params` over `batches`
    (an iterable of (x, bits)).  Returns {'loss': [per step], 'grad1':
    the first step's gradients, 'params': the equalizer's leaves after the
    last step}."""
    eq = {k: v.detach().float().clone() for k, v in params.items()
          if k.startswith(PREFIX)}
    frozen = {k: v.detach().float() for k, v in params.items()
              if not k.startswith(PREFIX)}
    state = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in eq.items()},
             "nu": {k: torch.zeros_like(v) for k, v in eq.items()}}
    losses, grad1 = [], None
    with dccn.full_float32():
        for x, bits in batches:
            leaves = {k: v.requires_grad_() for k, v in eq.items()}
            value = loss({**frozen, **leaves}, x.float(), bits, pilot_comb,
                         nbits, precision)
            grads = dict(zip(leaves, torch.autograd.grad(
                value, list(leaves.values()))))
            losses.append(float(value.detach()))
            if grad1 is None:
                grad1 = {k: g.detach() for k, g in grads.items()}
            eq = dccn.adam_step({k: v.detach() for k, v in eq.items()},
                                grads, state, train)
    return {"loss": losses, "grad1": grad1, "params": eq}
