"""The receiver's training loop and its data plane.

Port of `dl_ofdm_tpu/train/loop.py`: `TrainState`, `make_optimizer`,
`Trainer` (`synthesize`, `init_state`, `_loss_fn`, `train_step` with its
two routes, `eval_step`, `_ideal_batch_frames`, `fit`), with the hook the
equalizer stage uses: `model=` (any receiver that returns its logits
first).  Random draws come from an explicit `torch.Generator` in place of
`jax.random` keys; the streams differ from JAX's, so the tests hand both
packages the same draws (`bits=`, `unit_noise=` here, `words=` for the
fused route).

`train_step` has the JAX package's two routes:

  * fused (`_train_step_fused`, `loop.py:296-335`): the fused synthesize
    kernel's raw planes -> `_combine_stats` -> the fused DCCN gradient
    kernel -> the L2 gradient -> Adam.  Eligible where JAX's is
    (`loop.py:128-170`) with "on a CUDA device" for "on a TPU backend";
    on the CPU it runs on request with the kernels' plain versions;
  * autograd: `_loss_fn` under `torch.autograd` on the fused synthesize
    kernel's normalized output (or on `synthesize` where the fused chain
    does not apply).

Parameters live in a `TrainState` as a dict keyed as the model's
`state_dict()`; the model module only supplies the forward function
(`torch.func.functional_call`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import functional_call

from dl_ofdm_tpu_torch import resolve_device
from dl_ofdm_tpu_torch.channel.awgn import awgn_channel
from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.ofdm.tx import ofdm_modulate_frames_iq
from dl_ofdm_tpu_torch.ops.fused_model import (ModelSpec, dccn_fused_grads,
                                               reg_grads)
from dl_ofdm_tpu_torch.ops.fused_synth import (_combine_stats,
                                               build_synth_spec,
                                               fused_synthesize)
from dl_ofdm_tpu_torch.ops.norms import batch_norm_ref
from dl_ofdm_tpu_torch.train import metrics as M


@dataclasses.dataclass
class TrainState:
    params: dict          # name -> tensor, keyed as the model's state_dict()
    opt_state: dict       # Adam moments and count (`Adam.init`)
    step: int


class Adam:
    """optax's `adam` (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt) behind
    its staircase `exponential_decay` schedule, optionally after
    `clip_by_global_norm` (`loop.py:60-67`), as functions of dicts of
    tensors: `init(params)`, `update(grads, state)`."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tc: TrainConfig):
        self.tc = tc

    def learning_rate(self, count: int) -> float:
        """The rate of the update that `count` updates precede."""
        tc = self.tc
        return tc.init_learning * tc.lr_decay_rate ** (
            count // tc.lr_decay_steps)

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads: dict, state: dict):
        """(updates, new state); add the updates to the parameters.

        optax's operations in optax's order, each over all tensors at once
        (`torch._foreach_*`: one launch per operation, not per tensor)."""
        keys = list(grads)
        g = [grads[k] for k in keys]
        clip = self.tc.grad_clip
        if clip > 0:
            # optax's clip_by_global_norm: g if ||g|| < c else (g / ||g||) c
            # (no epsilon, unlike torch's clip_grad_norm_)
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g))
            g = [torch.where(norm < clip, t, (t / norm) * clip) for t in g]
        count = state["count"] + 1
        lr = self.learning_rate(state["count"])
        b1, b2 = self.b1, self.b2
        mul, add, div = (torch._foreach_mul, torch._foreach_add,
                         torch._foreach_div)
        mu = add(mul(g, 1 - b1), mul([state["mu"][k] for k in keys], b1))
        nu = add(mul(mul(g, g), 1 - b2),
                 mul([state["nu"][k] for k in keys], b2))
        mu_hat = div(mu, 1 - b1 ** count)
        nu_hat = div(nu, 1 - b2 ** count)
        den = add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = mul(div(mu_hat, den), -lr)
        return dict(zip(keys, upd)), {"count": count,
                                      "mu": dict(zip(keys, mu)),
                                      "nu": dict(zip(keys, nu))}


def make_optimizer(tc: TrainConfig) -> Adam:
    return Adam(tc)


def first_output(out):
    """The logits: every receiver returns them first (`loop.py:258-261`)."""
    return out[0] if isinstance(out, tuple) else out


class Trainer:
    """The basic DCCN receiver on an AWGN, static fading or Jakes-Doppler
    (`mobile=True`) channel.

    `model` replaces the `DCCNReceiver` (`loop.py:75,85`): any module with
    `reset_parameters(generator)` whose output is the logits or a tuple
    that starts with them.  The fused model route is for the bare
    `DCCNReceiver` only (`loop.py:158`).  `mix` applies Doppler to the
    designated frames of a mixed channel (every 3rd of mixRayleigh, every
    4th of mixAll); mobile implies it unless given (`loop.py:78-82`).
    `device` defaults to `cuda` and raises where there is none
    (`resolve_device`); the model's parameters live there."""

    def __init__(self, cfg: OFDMConfig, tc: TrainConfig, channel: str = "AWGN",
                 mobile: bool = False, mix: bool | None = None,
                 model: torch.nn.Module | None = None,
                 device: str | torch.device | None = None):
        if cfg.compute_dtype is not None:
            raise NotImplementedError(
                "OFDMConfig.compute_dtype (bf16 receiver GEMMs) is not "
                "ported yet")
        self.device = resolve_device(device)
        self.cfg, self.tc = cfg, tc
        self.plan = build_plan(cfg)
        if model is None:
            model = DCCNReceiver(
                nbits=cfg.nbits, nfft=cfg.nfft, cp_len=self.plan.cp_len,
                nfilter=cfg.nfilter, frame_size=self.plan.frame_size,
                nsymbol=cfg.nsymbol, keep_cp=cfg.cp)
        self.model = model.to(self.device)
        self.channel = RayleighChannel(
            channel=channel, nfft=cfg.nfft,
            sample_rate=self.plan.sample_rate, mobile=mobile,
            mix=mobile if mix is None else mix)
        self.optimizer = make_optimizer(tc)
        self.batch_frames = max(1, tc.batch_size // cfg.nsymbol)
        # the fused chain's eligibility (`loop.py:128-170`), apart from the
        # device: the TX operator within 2 MiB, no symbol without data
        self._fused_synth_spec = None
        tx_op_bytes = 2 * 4 * self.plan.frame_size * self.plan.samples_per_symbol
        sym_counts = np.bincount(self.plan.data_sc // cfg.nfft,
                                 minlength=self.plan.nsymbol)
        ch = self.channel
        if cfg.nbits <= 4 and tx_op_bytes <= 2 * 2**20 \
                and sym_counts.min() > 0:
            profs = [None if ch._passthrough[i] else p
                     for i, p in enumerate(ch.profiles)]
            fd = dop_cycle = None
            if ch.has_doppler:
                # frame i takes the Jakes path iff _frame_doppler_mask says
                # so; the pattern repeats every lcm(P, 3|4) frames
                per = {"mixrayleigh": 3, "mixall": 4}.get(ch.channel, 1)
                cyc_len = math.lcm(len(ch.profiles), per)
                dop_cycle = ch._frame_doppler_mask(
                    cyc_len, ch._frame_profiles(cyc_len))
                fd = ch._fd_np
            self._fused_synth_spec = build_synth_spec(
                self.plan, profs, cfg.nbits, fd=fd, dop_cycle=dop_cycle)
        self._fused_model_spec = None
        if (self._fused_synth_spec is not None
                and type(self.model) is DCCNReceiver
                and self.model.fft_like.recombine == "true"
                and self.model.keep_cp and not tc.double_softmax):
            self._fused_model_spec = ModelSpec(
                nsymbol=self.plan.nsymbol, sps=self.plan.samples_per_symbol,
                nfilter=cfg.nfilter, frame_size=self.plan.frame_size,
                nbits=cfg.nbits, matmul_dtype=tc.fused_model_matmul_dtype)
        on_card = self.device.type == "cuda"
        self._use_fused_synth = on_card and self._fused_synth_spec is not None
        self._use_fused_model = on_card and self._fused_model_spec is not None

    # -- state ---------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None
                   ) -> TrainState:
        """Fresh parameters with flax's initializers, drawn from
        `generator` (on the trainer's device), and a zero Adam state."""
        self.model.reset_parameters(generator)
        params = {k: v.detach().clone()
                  for k, v in self.model.state_dict().items()}
        return TrainState(params, self.optimizer.init(params), 0)

    # -- data plane ----------------------------------------------------------
    def synthesize(self, n_frames: int, snr_db: torch.Tensor,
                   generator: torch.Generator | None = None,
                   norm_groups: torch.Tensor | None = None,
                   bits: torch.Tensor | None = None,
                   unit_noise: torch.Tensor | None = None):
        """bits -> waveform -> fading -> AWGN -> normalized receiver input.

        Returns (bits [B, frame, nbits] int32, rx_in [B, S, K+CP, 2],
        h_freq, noise_power, waveform), as the JAX method does.  Draws bits,
        then tap gains, then unit noise from `generator`; `bits=` and
        `unit_noise=` replace the first and last draws.  `norm_groups`
        [B, G] one-hot: per-group normalization statistics (the interleaved
        sweep)."""
        dev = self.device
        if bits is None:
            bits = torch.randint(
                0, 2, (n_frames, self.plan.frame_size, self.cfg.nbits),
                generator=generator, device=dev, dtype=torch.int32)
        wf = ofdm_modulate_frames_iq(bits, self.plan)        # [B, S, K+CP, 2]
        ch = self.channel(wf, generator)
        y_iq, noise_pwr = awgn_channel(ch.y, snr_db, generator,
                                       unit_noise=unit_noise)
        rx_in = batch_norm_ref(y_iq, group_onehot=norm_groups)
        return bits, rx_in, ch.h_freq, noise_pwr, wf

    # -- loss ----------------------------------------------------------------
    def _loss_fn(self, params: dict, bits: torch.Tensor,
                 rx_in: torch.Tensor):
        """(CE + stop_grad(BER) * reg_coeff * L2, metrics) (`loop.py:257`)."""
        logits = first_output(functional_call(self.model, params, (rx_in,)))
        ce = M.cross_entropy(logits, bits, self.tc.double_softmax)
        reg = M.l2_regularization(params)
        conf = M.confusion_matrix(bits, M.bit_predictions(logits))
        log_ber, ber = M.ber_from_confusion(conf)
        loss = ce + ber.detach() * self.tc.reg_coeff * reg
        aux = {"ce": ce, "ber": ber, "log_ber": log_ber, "conf": conf,
               "total_loss": ce + ber * self.tc.reg_coeff * reg + log_ber}
        return loss, aux

    # -- steps ---------------------------------------------------------------
    def _apply(self, state: TrainState, grads: dict) -> TrainState:
        """The optimizer on the parameters that `grads` holds; any other
        parameter keeps its tensor."""
        updates, opt_state = self.optimizer.update(grads, state.opt_state)
        keys = list(updates)
        params = dict(state.params)
        params.update(zip(keys, torch._foreach_add(
            [state.params[k] for k in keys], [updates[k] for k in keys])))
        return TrainState(params, opt_state, state.step + 1)

    def train_step(self, state: TrainState, generator: torch.Generator,
                   snr_db: torch.Tensor, words: dict | None = None,
                   fused: bool | None = None,
                   return_grads: bool = False):
        """One optimizer step on `batch_frames` fresh frames; returns
        (state, aux).  `fused=None` takes the fused route where it is
        eligible on a CUDA device; True or False asks for one route.
        `words=` hands the fused synthesize chain its random words (CPU
        only).  `return_grads=True` adds the step's gradients to aux."""
        if fused is None:
            fused = self._use_fused_model
        if fused:
            if self._fused_model_spec is None:
                raise ValueError("this trainer's configuration has no fused "
                                 "route (loop.py:128-170)")
            return self._train_step_fused(state, generator, snr_db, words,
                                          return_grads)
        b = self.batch_frames
        if self._fused_synth_spec is not None and (
                self._use_fused_synth or words is not None):
            bits, rx_in, noise_pwr = fused_synthesize(
                self._fused_synth_spec, b, generator, snr_db, words=words)
        else:
            bits, rx_in, _, noise_pwr, _ = self.synthesize(b, snr_db,
                                                           generator)
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        loss, aux = self._loss_fn(params, bits, rx_in)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        aux = {k: v.detach() for k, v in aux.items()}
        aux.update(loss=loss.detach(), noise_power=noise_pwr)
        if return_grads:
            aux["grads"] = grads
        return self._apply(state, grads), aux

    def _train_step_fused(self, state, generator, snr_db, words,
                          return_grads):
        """Synth kernel (raw planes) -> batch moments -> fused model
        gradient kernel -> L2 gradient -> Adam (`loop.py:296-335`)."""
        b = self.batch_frames
        idx, yr, yi, nr, ni, stats = fused_synthesize(
            self._fused_synth_spec, b, generator, snr_db, raw=True,
            words=words)
        _, c, noise_pwr, _ = _combine_stats(stats.sum(0), b)
        grads, ce, conf = dccn_fused_grads(
            self._fused_model_spec, b, state.params, yr, yi, nr, ni, c, idx)
        log_ber, ber = M.ber_from_confusion(conf)
        reg = M.l2_regularization(state.params)
        rc = self.tc.reg_coeff
        loss = ce + ber * rc * reg
        reg_g = reg_grads(state.params, ber, rc)
        keys = list(grads)
        grads = dict(zip(keys, torch._foreach_add(
            [grads[k] for k in keys], [reg_g[k] for k in keys])))
        aux = {"ce": ce, "ber": ber, "log_ber": log_ber, "conf": conf,
               "total_loss": loss + log_ber, "loss": loss,
               "noise_power": noise_pwr}
        if return_grads:
            aux["grads"] = grads
        return self._apply(state, grads), aux

    @torch.no_grad()
    def eval_step(self, params: dict, generator: torch.Generator,
                  n_frames: int, snr_db: torch.Tensor) -> dict:
        """Metrics of `params` on fresh frames of the plain data plane."""
        bits, rx_in, _, noise_pwr, wf = self.synthesize(n_frames, snr_db,
                                                        generator)
        _, aux = self._loss_fn(params, bits, rx_in)
        aux["noise_power"] = noise_pwr
        aux["iq_tx"] = wf.reshape(-1, 2)[:2048]
        aux["iq_rx"] = rx_in.reshape(-1, 2)[:2048]
        return aux

    # -- adaptive batch growth (reference C15, `ofdmreceiver_np.py:242-243`) -
    def _ideal_batch_frames(self, ber: float) -> int:
        """idealbatch = (min(200/BER, 9e5) / (55*nbits)) // 8, rounded down
        to a power of two, capped at 8192 frames (`loop.py:338-350`)."""
        ideal = int(min(200.0 / max(ber, 1e-6), 9e5)
                    / (55 * self.cfg.nbits)) // 8
        if ideal <= self.batch_frames:
            return self.batch_frames
        target = min(ideal, 8192)
        snapped = 1
        while snapped < target:
            snapped *= 2
        return max(self.batch_frames,
                   snapped // 2 if snapped > target else snapped)

    # -- epochs (the reference's epoch/early-stop protocol) -------------------
    def fit(self, seed: int | None = None, max_epochs: int | None = None,
            log_fn=print, grow_batch: bool = True,
            dump_constellations: bool = False,
            init_state: TrainState | None = None,
            ckpt_dir: str | None = None, ckpt_every: int = 50):
        """Epochs of `train_step`, an `eval_step` of 1024 frames after each,
        batch growth, best-params tracking and early stop
        (`loop.py:399-468`).  Returns (state with the best params,
        {"best_epoch", "best_loss", "history"})."""
        if ckpt_dir is not None:
            raise NotImplementedError(
                "resume payloads (ckpt_dir) are not ported yet: ROADMAP.md "
                "Queue A item 5")
        if dump_constellations:
            raise NotImplementedError(
                "dump_constellations is not ported yet: ROADMAP.md Queue A "
                "item 11 (utils/observability)")
        tc = self.tc
        seed = tc.seed if seed is None else seed
        max_epochs = tc.max_epoch_num if max_epochs is None else max_epochs
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = self.init_state(gen) if init_state is None else init_state
        best_loss, best_epoch, best_params = math.inf, 0, state.params
        sel = "total_loss" if tc.best_metric == "total" else "ce"
        history = []
        for epoch in range(max_epochs):
            steps = max(1, tc.frames_per_epoch(self.cfg.nsymbol)
                        // self.batch_frames)
            snr = torch.full((self.batch_frames,), tc.snr,
                             device=self.device)
            losses = []
            for _ in range(steps):
                state, aux = self.train_step(state, gen, snr)
                losses.append(aux[sel])
            last_ber = float(aux["ber"])
            epoch_loss = float(torch.stack(losses).mean())
            val = self.eval_step(state.params, gen, 1024,
                                 torch.full((1024,), tc.snr,
                                            device=self.device))
            if grow_batch:
                self.batch_frames = self._ideal_batch_frames(last_ber)
            history.append({"epoch": epoch, "train_loss": epoch_loss,
                            "val_ber": float(val["ber"]),
                            "val_loss": float(val["ce"])})
            log_fn(f"epoch {epoch}: train_ce={epoch_loss:.5f} "
                   f"val_ber={float(val['ber']):.6f}")
            if epoch_loss < best_loss:
                best_loss, best_epoch = epoch_loss, epoch
                best_params = state.params
            if epoch - tc.early_stop > best_epoch:
                break
        state = TrainState(best_params, state.opt_state, state.step)
        return state, {"best_epoch": best_epoch, "best_loss": best_loss,
                       "history": history}
