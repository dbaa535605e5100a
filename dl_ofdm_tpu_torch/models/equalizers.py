"""DCCN equalizer zoo: channel estimation and equalization subnetworks.

Port of `dl_ofdm_tpu/models/equalizers.py` (reference
`dev/py/model.py:349-1218`, dispatched by `--opt`,
`dev/py/ofdmreceiver_np_mp.py:292-312`): `EqSpec`, `EQUALIZER_REGISTRY`
(ids 0-7 and 9-13, the same switches), `equalize_iq` and `Equalizer`.

Shared skeleton (the variants toggle pieces of it):
  layer_norm -> [CP strip] -> Dense(K*2) -> to-frequency transform ->
  pilot extraction Dense(pilot_size*2) -> [residual cascade] ->
  interpolation Dense stack -> refinement blocks (tanh Dense + (S, K)
  complex conv) -> chest -> equalize -> optional power feature ->
  back-to-time transform -> Dense(n_sc*2); plus a pilot-moment SNR
  estimate.  Id 13 is the legacy all-dense `equalizer_dnn`.

Submodules keep the flax scope names (`Dense_in`, `ToFreq`, `Dense_pilot`,
`Dense_interp{i}`, `Dense_block{i}`, `BlockConv{i}`, `CascadeConv{i}`,
`CorrT`, `ToTime`, `Dense_out`, ...), so an arm's npz maps onto
`state_dict()` through `train.checkpoint.params_from_flax`.  `nn.Linear`
layers start as flax's `Dense` does (`lecun_normal` kernels, zero biases).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from dl_ofdm_tpu_torch.ops import cfloat
from dl_ofdm_tpu_torch.ops.complex_ops import (ComplexConv2d, ComplexDense,
                                               lecun_normal_)
from dl_ofdm_tpu_torch.ops.norms import frame_layer_norm, leaky_relu
from dl_ofdm_tpu_torch.utils.observability import span


@dataclasses.dataclass(frozen=True)
class EqSpec:
    """Structural switches distinguishing the equalizer variants."""
    to_freq: str = "cconv"        # 'cconv' | 'dense' | 'vector'
    pre_dense_acts: tuple = (None, None)  # interpolation stack activations
    n_blocks: int = 1             # refinement blocks
    block_conv: str = "cconv"     # 'cconv' | 'vector' | 'none'
    back_to_time: str = "cconv"   # 'cconv' | 'vector' | 'ifft' | 'dense'
    use_corr: bool = True         # concat the power feature
    cmode: str = "exact"          # complex-op mode for this variant
    cascade: int = 0              # residual cascade steps on pilot features
    eq_div: str = "phase"         # 'phase' (conj(H)/|H|) | 'zf'
    zf_eps: float = 1e-2          # ZF inverse regularizer
    zf_stopgrad_denom: bool = False  # no gradient through 1/(|H|^2+eps)
    legacy_dnn: bool = False      # legacy all-dense `equalizer_dnn`


EQUALIZER_REGISTRY: dict[int, EqSpec] = {
    0: EqSpec(),
    1: EqSpec(to_freq="dense", n_blocks=1, block_conv="cconv",
              back_to_time="dense", use_corr=False),
    2: EqSpec(pre_dense_acts=(None,), n_blocks=0, back_to_time="ifft",
              use_corr=False),
    3: EqSpec(to_freq="dense", pre_dense_acts=("tanh", "tanh"), n_blocks=2,
              block_conv="none", back_to_time="dense", use_corr=False),
    4: EqSpec(pre_dense_acts=(None, "tanh"), n_blocks=0, back_to_time="ifft",
              use_corr=False),
    5: EqSpec(pre_dense_acts=(None, "tanh"), n_blocks=2, block_conv="none",
              back_to_time="ifft", use_corr=False),
    6: EqSpec(),   # 'doppler': never defined in the reference; the default
    7: EqSpec(to_freq="vector", pre_dense_acts=("tanh", "tanh"), n_blocks=1,
              block_conv="vector", back_to_time="vector", cmode="vector"),
    9: EqSpec(),
    10: EqSpec(),
    11: EqSpec(cascade=4),                      # legacy residual cascade
    12: EqSpec(eq_div="zf", zf_eps=0.1),        # zero-forcing
    13: EqSpec(legacy_dnn=True),                # legacy `equalizer_dnn`
}


def equalize_iq(input_freq: torch.Tensor, chest_iq: torch.Tensor,
                eq_div: str, zf_eps: float = 1e-2,
                zf_stopgrad_denom: bool = False) -> torch.Tensor:
    """Apply the channel estimate to the frequency-domain input (IQ pairs).

    'phase': eq = Y conj(H)/|H| (reference, `dev/py/model.py:430-434`).
    'zf': eq = Y conj(Hn)/(|Hn|^2 + zf_eps), Hn the estimate over its RMS;
    `zf_stopgrad_denom` detaches the denominator."""
    if eq_div == "zf":
        rms = torch.sqrt(torch.mean(torch.sum(chest_iq ** 2, dim=-1),
                                    dim=(1, 2), keepdim=True))[..., None]
        chest_n = chest_iq / (rms + 1e-12)
        denom = torch.sum(chest_n ** 2, dim=-1, keepdim=True) + zf_eps
        if zf_stopgrad_denom:
            denom = denom.detach()
        h_norm = cfloat.conj_iq(chest_n) / denom
    elif eq_div == "phase":
        h_norm = cfloat.conj_iq(chest_iq) / (
            cfloat.abs_iq(chest_iq, eps=1e-24)[..., None] + 1e-12)
    else:
        raise ValueError(eq_div)
    return cfloat.cmul_iq(input_freq, h_norm)


_LOG10 = math.log(10.0)


def snr_estimate(freq_iq: torch.Tensor, pilot_idx: torch.Tensor
                 ) -> torch.Tensor:
    """[B, 1] pilot-moment SNR "in dB", as the reference computes it
    (`model.py:464-475`): mean over variance (population) of the pilots'
    |x|^2 (subcarriers `pilot_idx`), clipped to [1e-3, 1e4], then log10
    without the x10."""
    b = freq_iq.shape[0]
    p_pow = torch.sum(freq_iq[:, :, pilot_idx, :] ** 2, dim=-1).reshape(b, -1)
    sig = p_pow.mean(dim=1, keepdim=True)
    noi = p_pow.var(dim=1, unbiased=False, keepdim=True)
    snr_est = torch.clamp(sig / (noi + 1e-12), 1e-3, 1e4)
    return torch.log(snr_est) / _LOG10


def dense(in_features: int, features: int) -> nn.Linear:
    """flax's `nn.Dense` as an `nn.Linear` (its init in `reset_dense`)."""
    layer = nn.Linear(in_features, features)
    reset_dense(layer)
    return layer


def reset_dense(layer: nn.Linear,
                generator: torch.Generator | None = None) -> None:
    lecun_normal_(layer.weight, layer.in_features, generator)
    nn.init.zeros_(layer.bias)


def reset_all(module: nn.Module,
              generator: torch.Generator | None = None) -> None:
    """Draw every layer of `module` afresh with flax's initializers, in
    the order of `named_modules`."""
    for _, m in module.named_modules():
        if isinstance(m, nn.Linear):
            reset_dense(m, generator)
        elif m is not module and hasattr(m, "reset_parameters") \
                and not list(m.children()):
            m.reset_parameters(generator)


class Equalizer(nn.Module):
    """(waveform IQ [B, S, K+CP, 2]) -> (equalized IQ [B, S, K+CP, 2],
    snr_db [B, 1], channel estimate [B, S, K, 2])."""

    def __init__(self, nfft: int, cp_len: int, nsymbol: int,
                 pilot_size: int, pilot_carriers, spec: EqSpec = EqSpec(),
                 keep_cp: bool = True):
        super().__init__()
        self.nfft, self.cp_len, self.nsymbol = nfft, cp_len, nsymbol
        self.pilot_size = pilot_size
        self.pilot_carriers = tuple(int(c) for c in pilot_carriers)
        self.spec, self.keep_cp = spec, keep_cp
        # the pilot subcarriers as a device tensor (not a parameter)
        self.register_buffer("pilot_idx", torch.as_tensor(
            self.pilot_carriers, dtype=torch.int64), persistent=False)
        k, s = nfft, nsymbol
        n_sc = nfft + cp_len
        k_in = n_sc if keep_cp else k
        if spec.legacy_dnn:
            self._build_legacy_dnn(k, s, k_in, n_sc)
            return
        self.Dense_in = dense(k_in * 2, k * 2)
        if spec.to_freq in ("cconv", "vector"):
            mode = "exact" if spec.to_freq == "cconv" else "vector"
            self.ToFreq = ComplexDense(k, k, mode=mode)
        elif spec.to_freq == "dense":
            self.Dense_tofreq = dense(k * 2, k * 2)
        else:
            raise ValueError(spec.to_freq)
        p_iq = pilot_size * 2
        self.Dense_pilot = dense(s * k * 2, p_iq)
        width = p_iq
        if spec.cascade > 0:
            self.Dense_cascade0 = dense(p_iq, p_iq)
            for i in range(spec.cascade):
                setattr(self, f"Dense_cascade{i + 1}", dense(p_iq, p_iq))
                setattr(self, f"CascadeConv{i}",
                        ComplexConv2d(1, 1, (1, pilot_size), padding="same"))
            width = (spec.cascade + 2) * p_iq
        for i in range(len(spec.pre_dense_acts)):
            setattr(self, f"Dense_interp{i}", dense(width, s * k * 2))
            width = s * k * 2
        for i in range(spec.n_blocks):
            setattr(self, f"Dense_block{i}", dense(width, s * k * 2))
            width = s * k * 2
            if spec.block_conv != "none":
                mode = "vector" if spec.block_conv == "vector" else "exact"
                setattr(self, f"BlockConv{i}",
                        ComplexConv2d(1, 1, (s, k), padding="same",
                                      mode=mode))
        if spec.use_corr:
            mode = "vector" if spec.cmode == "vector" else "exact"
            self.CorrT = ComplexDense(k, k, mode=mode)
        if spec.back_to_time in ("cconv", "vector"):
            mode = "vector" if spec.back_to_time == "vector" else "exact"
            self.ToTime = ComplexDense(k, k, mode=mode)
        elif spec.back_to_time == "dense":
            self.Dense_totime = dense(k * 2, k * 2)
        elif spec.back_to_time != "ifft":
            raise ValueError(spec.back_to_time)
        self.Dense_out = dense(k * (4 if spec.use_corr else 2), n_sc * 2)

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_all(self, generator)

    def _front(self, x: torch.Tensor) -> torch.Tensor:
        """layer norm, CP strip, flatten per symbol: [B, S, k_in*2]."""
        h = frame_layer_norm(x)
        if not self.keep_cp:
            h = h[:, :, self.cp_len:self.cp_len + self.nfft, :]
        return h.reshape(x.shape[0], self.nsymbol, -1)

    def forward(self, x: torch.Tensor, tp=None):
        """`tp` (a `parallel.tp.TensorParallel` of this module's keys) runs
        `Dense_interp*` and `Dense_block*` column-parallel over a dp row's
        tp ranks, their outputs gathered before the activations.  The
        three stages carry the `eq.front`, `eq.chest` and `eq.equalize`
        spans."""
        spec = self.spec
        if spec.legacy_dnn:
            return self._legacy_dnn(x)
        with span("eq.front"):
            input_freq = self._to_freq(x)                  # [B, S, K, 2]
        with span("eq.chest"):
            chest_iq = self._chest(input_freq, tp)         # [B, S, K, 2]
        with span("eq.equalize"):
            return self._equalize(input_freq, chest_iq, x.shape[2])

    def _to_freq(self, x: torch.Tensor) -> torch.Tensor:
        k, s, b = self.nfft, self.nsymbol, x.shape[0]
        h = self.Dense_in(self._front(x)).reshape(b, s, k, 2)
        if self.spec.to_freq == "dense":
            return self.Dense_tofreq(h.reshape(b, s, k * 2)).reshape(
                b, s, k, 2)
        return self.ToFreq(h)

    def _chest(self, freq: torch.Tensor, tp) -> torch.Tensor:
        """Pilot extraction, cascade, interpolation and the refinement
        blocks: the channel estimate [B, S, K, 2]."""
        spec, k, s, b = self.spec, self.nfft, self.nsymbol, freq.shape[0]
        c = self.Dense_pilot(freq.reshape(b, s * k * 2))
        if spec.cascade > 0:
            p_iq = self.pilot_size * 2
            prev, cur = c, self.Dense_cascade0(c)
            stages = [prev, cur]
            for i in range(spec.cascade):
                nxt = getattr(self, f"Dense_cascade{i + 1}")(prev - cur)
                blk = nxt.reshape(b, 1, self.pilot_size, 1, 2)
                blk = getattr(self, f"CascadeConv{i}")(blk)
                nxt = blk.reshape(b, p_iq)
                stages.append(nxt)
                prev, cur = cur, nxt
            c = torch.cat(stages, dim=-1)

        def wide(name, v):
            layer = getattr(self, name)
            return layer(v) if tp is None else tp.column_linear(layer, name,
                                                                v)

        for i, act in enumerate(spec.pre_dense_acts):
            c = wide(f"Dense_interp{i}", c)
            if act == "tanh":
                c = torch.tanh(c)
        for i in range(spec.n_blocks):
            c = torch.tanh(wide(f"Dense_block{i}", c.reshape(b, -1)))
            if spec.block_conv != "none":
                blk = getattr(self, f"BlockConv{i}")(c.reshape(b, s, k, 1, 2))
                c = blk.reshape(b, s * k * 2)
        return c.reshape(b, s, k, 2)

    def _equalize(self, input_freq: torch.Tensor, chest_iq: torch.Tensor,
                  n_sc: int):
        """The estimate applied, the power feature x conj(x) (the
        reference's "autocorrelation", `model.py:437-440`), back to time,
        `Dense_out` and the SNR estimate."""
        spec, k, s, b = self.spec, self.nfft, self.nsymbol, input_freq.shape[0]
        eq_freq_iq = equalize_iq(input_freq, chest_iq, spec.eq_div,
                                 spec.zf_eps, spec.zf_stopgrad_denom)
        feats = []
        if spec.use_corr:
            corr = cfloat.cmul_iq(eq_freq_iq, cfloat.conj_iq(eq_freq_iq))
            feats.append(self.CorrT(corr))
        if spec.back_to_time == "ifft":
            eq_t = cfloat.idft_iq(eq_freq_iq)
        elif spec.back_to_time == "dense":
            eq_t = self.Dense_totime(eq_freq_iq.reshape(b, s, k * 2)).reshape(
                b, s, k, 2)
        else:
            eq_t = self.ToTime(eq_freq_iq)
        feats.insert(0, eq_t)
        out = self.Dense_out(torch.cat(feats, dim=-1).reshape(b, s, -1))
        equalized = out.reshape(b, s, n_sc, 2)
        return equalized, snr_estimate(eq_freq_iq, self.pilot_idx), chest_iq

    # -- registry id 13: the legacy all-dense `equalizer_dnn` ---------------
    def _build_legacy_dnn(self, k, s, k_in, n_sc):
        p = len(self.pilot_carriers)
        pilot_size = s * p * 2        # reference sizing: n_sym*P*m_iq
        frame_size = s * k * 2        # n_sym*K*m_iq
        self.Dense_in = dense(k_in * 2, k * 2)
        self.Dense_pilot = dense(frame_size, pilot_size)
        self.Dense_mid = dense(pilot_size, pilot_size * 2 - 8)
        self.Dense_chest = dense(pilot_size * 2 - 8, frame_size)
        self.Dense_cascade = dense(2 * frame_size, frame_size * 2 - 30)
        self.Dense_freq = dense(frame_size * 2 - 30, frame_size)
        self.Dense_out = dense(k * 2, n_sc * 2)

    def _legacy_dnn(self, x: torch.Tensor):
        """`dev/py/model.py:1629-1732` with its quirks: no equalize-divide,
        hidden widths pilot_size*2-8 and frame_size*2-30, a per-symbol
        Dense back to the CP-bearing width (`equalizers.py:_legacy_dnn`)."""
        k, s = self.nfft, self.nsymbol
        b, n_sc = x.shape[0], x.shape[2]
        h = leaky_relu(self.Dense_in(self._front(x)))
        inputs_flat = h.reshape(b, s * k * 2)
        c = leaky_relu(self.Dense_pilot(inputs_flat))
        c = leaky_relu(self.Dense_mid(c))
        chest_flat = self.Dense_chest(c)
        f = self.Dense_cascade(torch.cat([inputs_flat, chest_flat], dim=-1))
        f = leaky_relu(self.Dense_freq(f))
        iq_freq = f.reshape(b, s, k, 2)
        out = self.Dense_out(iq_freq.reshape(b, s, k * 2))
        equalized = out.reshape(b, s, n_sc, 2)
        return (equalized, snr_estimate(iq_freq, self.pilot_idx),
                chest_flat.reshape(b, s, k, 2))
