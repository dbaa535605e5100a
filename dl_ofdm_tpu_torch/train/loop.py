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

`OFDMConfig.compute_dtype` reaches the `DCCNReceiver` (bf16 GEMM inputs,
`models/dccn.py`); as in JAX (`loop.py:157-163`) only a model without it
takes the fused route, so a bf16 trainer on a card takes the autograd
route, through `complex_dense`'s bf16 mode.

`fit(ckpt_dir=)` writes a resume payload every `ckpt_every` epochs and
resumes from it (`loop.py:353-397`, `train/checkpoint.py`): the state,
the epoch loop's generator (the only source of its draws: the synth
kernel draws its seed words from it, and on a mesh the rank generators
are drawn from it at every step), the cursors and the batch size, so
the resumed trajectory is bit-identical to an uninterrupted one.

With `mesh=` (`parallel/mesh.py`, dp only) the step is data parallel, as
JAX's mesh step (`loop.py:96-106`, `:187-229`): the plain data plane and
the autograd route on every rank, each rank's shard drawn on its device
from its own generator and normalized with its own moments
(`_synth_mesh`), the gradients summed over the ranks (`_mesh_step`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import os

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
from dl_ofdm_tpu_torch.parallel.mesh import (check_dp_only, module_replicas,
                                             rank_generators, shard_params)
from dl_ofdm_tpu_torch.train import checkpoint as ckpt
from dl_ofdm_tpu_torch.train import metrics as M
from dl_ofdm_tpu_torch.utils.observability import dump_constellation


@dataclasses.dataclass
class TrainState:
    params: dict          # name -> tensor, keyed as the model's state_dict()
    opt_state: dict       # Adam moments and count (`Adam.init`)
    step: int
    # on a mesh: one copy of `params` per dp rank, on its device
    replicas: list[dict] | None = None


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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block, its setting
    restored after: the algorithms it picks by default may sum a
    convolution's weight gradient with atomics in an order that varies
    from run to run (the equalizers' convolutions), and a resumed `fit`
    has to repeat the uninterrupted one bit for bit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


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
    (`resolve_device`); the model's parameters live there.

    `mesh` (a dp-only `parallel.mesh.Mesh`) makes the step data parallel
    over its ranks; `batch_frames` is rounded up to a multiple of dp, the
    device is rank 0's, and the fused route is never taken
    (`loop.py:146`)."""

    def __init__(self, cfg: OFDMConfig, tc: TrainConfig, channel: str = "AWGN",
                 mobile: bool = False, mix: bool | None = None,
                 model: torch.nn.Module | None = None,
                 device: str | torch.device | None = None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            check_dp_only(mesh)
            rank0 = mesh.dp_devices[0]
            if device is not None and resolve_device(device) != rank0:
                raise ValueError(f"device {device} is not the mesh's rank 0 "
                                 f"({rank0})")
            device = rank0
        self.device = resolve_device(device)
        self.cfg, self.tc = cfg, tc
        self.plan = build_plan(cfg)
        if model is None:
            model = DCCNReceiver(
                nbits=cfg.nbits, nfft=cfg.nfft, cp_len=self.plan.cp_len,
                nfilter=cfg.nfilter, frame_size=self.plan.frame_size,
                nsymbol=cfg.nsymbol, keep_cp=cfg.cp,
                compute_dtype=cfg.compute_dtype)
        self.model = model.to(self.device)
        self.channel = RayleighChannel(
            channel=channel, nfft=cfg.nfft,
            sample_rate=self.plan.sample_rate, mobile=mobile,
            mix=mobile if mix is None else mix)
        self.optimizer = make_optimizer(tc)
        self.batch_frames = self._round_to_dp(
            max(1, tc.batch_size // cfg.nsymbol))
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
                and self.model.compute_dtype is None
                and self.model.keep_cp and not tc.double_softmax):
            self._fused_model_spec = ModelSpec(
                nsymbol=self.plan.nsymbol, sps=self.plan.samples_per_symbol,
                nfilter=cfg.nfilter, frame_size=self.plan.frame_size,
                nbits=cfg.nbits, matmul_dtype=tc.fused_model_matmul_dtype)
        on_card = self.device.type == "cuda" and mesh is None
        self._use_fused_synth = on_card and self._fused_synth_spec is not None
        self._use_fused_model = on_card and self._fused_model_spec is not None
        # the model on every rank's device, for the ranks' forward passes
        self._rank_models = (None if mesh is None else
                             module_replicas(self.model, mesh.dp_devices))

    def _round_to_dp(self, frames: int) -> int:
        """`frames` rounded up to a multiple of the mesh's dp (so that every
        rank gets equal shards, `loop.py:102-106`)."""
        if self.mesh is None:
            return frames
        return frames + (-frames) % self.mesh.shape["dp"]

    def _replicate(self, params: dict) -> list[dict] | None:
        """Each dp rank's copy of `params`; None off a mesh."""
        return None if self.mesh is None else shard_params(self.mesh, params)

    # -- state ---------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None
                   ) -> TrainState:
        """Fresh parameters with flax's initializers, drawn from
        `generator` (on the trainer's device), and a zero Adam state; on a
        mesh, with the replicas."""
        self.model.reset_parameters(generator)
        params = {k: v.detach().clone()
                  for k, v in self.model.state_dict().items()}
        return TrainState(params, self.optimizer.init(params), 0,
                          self._replicate(params))

    # -- data plane ----------------------------------------------------------
    def synthesize(self, n_frames: int, snr_db: torch.Tensor,
                   generator: torch.Generator | None = None,
                   norm_groups: torch.Tensor | None = None,
                   bits: torch.Tensor | None = None,
                   unit_noise: torch.Tensor | None = None,
                   normalize: bool = True,
                   device: torch.device | None = None):
        """bits -> waveform -> fading -> AWGN -> normalized receiver input.

        Returns (bits [B, frame, nbits] int32, rx_in [B, S, K+CP, 2],
        h_freq, noise_power, waveform), as the JAX method does.  Draws bits,
        then tap gains, then unit noise from `generator`; `bits=` and
        `unit_noise=` replace the first and last draws.  `norm_groups`
        [B, G] one-hot: per-group normalization statistics (the interleaved
        sweep).  `normalize=False` returns the waveform after AWGN in place
        of `rx_in` (the mesh point_batch sweep normalizes with moments over
        every rank).  `device` (the trainer's by default) is where the bits
        are drawn, and so where everything runs."""
        dev = self.device if device is None else device
        if bits is None:
            bits = torch.randint(
                0, 2, (n_frames, self.plan.frame_size, self.cfg.nbits),
                generator=generator, device=dev, dtype=torch.int32)
        wf = ofdm_modulate_frames_iq(bits, self.plan)        # [B, S, K+CP, 2]
        ch = self.channel(wf, generator)
        y_iq, noise_pwr = awgn_channel(ch.y, snr_db, generator,
                                       unit_noise=unit_noise)
        rx_in = (batch_norm_ref(y_iq, group_onehot=norm_groups)
                 if normalize else y_iq)
        return bits, rx_in, ch.h_freq, noise_pwr, wf

    # -- loss ----------------------------------------------------------------
    def _rank_terms(self, params: dict, bits: torch.Tensor,
                    rx_in: torch.Tensor, model: torch.nn.Module | None = None):
        """What the frames give the loss: (CE, confusion counts, further
        metrics) of `params` on one batch, through `model` (the trainer's
        by default; a rank's copy on a mesh)."""
        logits = first_output(functional_call(model or self.model, params,
                                              (rx_in,)))
        ce = M.cross_entropy(logits, bits, self.tc.double_softmax)
        conf = M.confusion_matrix(bits, M.bit_predictions(logits))
        return ce, conf, {}

    def _global_terms(self, params: dict, ce: torch.Tensor,
                      conf: torch.Tensor):
        """(CE + stop_grad(BER) * reg_coeff * L2, metrics) from the batch's
        CE and counts (`loop.py:257-272`)."""
        reg = M.l2_regularization(params)
        log_ber, ber = M.ber_from_confusion(conf)
        loss = ce + ber.detach() * self.tc.reg_coeff * reg
        aux = {"ce": ce, "ber": ber, "log_ber": log_ber, "conf": conf,
               "total_loss": ce + ber * self.tc.reg_coeff * reg + log_ber}
        return loss, aux

    def _loss_fn(self, params: dict, bits: torch.Tensor,
                 rx_in: torch.Tensor):
        """(the loss, metrics) of `params` on one batch."""
        ce, conf, _ = self._rank_terms(params, bits, rx_in)
        return self._global_terms(params, ce, conf)

    # -- the mesh (dp) ---------------------------------------------------------
    def _synth_mesh(self, generator: torch.Generator, snr_db: torch.Tensor,
                    want_h: bool = False):
        """The data plane over the dp ranks (`loop.py:206-228`): rank r
        draws `batch_frames / dp` frames at its slice of `snr_db` on its
        device from its own generator (`rank_generators`: one draw of
        `generator` plus r, for JAX's `fold_in(key, axis_index)`) and
        normalizes them with its own moments.  Returns per-rank lists
        (bits, rx_in, h_freq or None without `want_h`) and the noise power
        averaged over the ranks."""
        devs = self.mesh.dp_devices
        local = self.batch_frames // len(devs)
        shards = [self.synthesize(local, snr.to(dev), gen, device=dev)
                  for dev, gen, snr in zip(devs,
                                           rank_generators(generator, devs),
                                           torch.chunk(snr_db, len(devs)))]
        bits, rx_in, h_freq, noise_pwr, _ = zip(*shards)
        noise_pwr = torch.stack([p.to(self.device) for p in noise_pwr]).mean()
        return (list(bits), list(rx_in), list(h_freq) if want_h else None,
                noise_pwr)

    def _grad_keys(self, params: dict) -> list[str]:
        """The parameters that take gradients: all of them."""
        return list(params)

    def _mesh_step(self, state: TrainState, bits: list, rx_in: list,
                   extras: list, noise_pwr: torch.Tensor,
                   return_grads: bool = False):
        """One data-parallel step on per-rank shards (`extras[r]`: further
        arguments of rank r's `_rank_terms`).

        Every rank runs the forward pass on its shard with its replica; the
        confusion counts are summed over the ranks first, so the L2 term
        takes the global BER as JAX's global-batch loss does; each rank's
        backward pass runs on its CE weighted by its share of the frames;
        the rank gradients are summed in rank order on rank 0's device, the
        L2 term's gradient is added once, Adam runs once, and every replica
        receives a copy of the new parameters (a reduce and a broadcast in
        place of an all-reduce and replicated Adam: the same parameters)."""
        dev0 = self.device
        keys = self._grad_keys(state.params)
        total = sum(b.shape[0] for b in bits)
        ranks = []
        for replica, b, x, extra in zip(state.replicas, bits, rx_in, extras):
            params = dict(replica)
            train = [params[k].detach().requires_grad_() for k in keys]
            params.update(zip(keys, train))
            ce, conf, more = self._rank_terms(
                params, b, x, model=self._rank_models[x.device], **extra)
            ranks.append((train, ce * (b.shape[0] / total), conf, more))
        ce = sum(w.detach().to(dev0) for _, w, _, _ in ranks)
        conf = sum(c.to(dev0) for _, _, c, _ in ranks)
        grads = None
        for train, w, _, _ in ranks:
            g = [t.to(dev0) for t in torch.autograd.grad(
                w, train, materialize_grads=True)]
            grads = g if grads is None else torch._foreach_add(grads, g)
        # the parameter term, once, on rank 0's copy (the CE is detached)
        params = dict(state.params)
        train = [params[k].detach().requires_grad_() for k in keys]
        params.update(zip(keys, train))
        loss, aux = self._global_terms(params, ce, conf)
        grads = dict(zip(keys, torch._foreach_add(grads, torch.autograd.grad(
            loss, train, materialize_grads=True))))
        aux = {k: v.detach() for k, v in aux.items()}
        for k in ranks[0][3]:
            aux[k] = sum(m[k].detach().to(dev0) * (b.shape[0] / total)
                         for (_, _, _, m), b in zip(ranks, bits))
        aux.update(loss=loss.detach(), noise_power=noise_pwr)
        if return_grads:
            aux["grads"] = grads
        return self._apply(state, grads), aux

    # -- steps ---------------------------------------------------------------
    def _apply(self, state: TrainState, grads: dict) -> TrainState:
        """The optimizer on the parameters that `grads` holds; any other
        parameter keeps its tensor."""
        updates, opt_state = self.optimizer.update(grads, state.opt_state)
        keys = list(updates)
        params = dict(state.params)
        params.update(zip(keys, torch._foreach_add(
            [state.params[k] for k in keys], [updates[k] for k in keys])))
        return TrainState(params, opt_state, state.step + 1,
                          self._replicate(params))

    def train_step(self, state: TrainState, generator: torch.Generator,
                   snr_db: torch.Tensor, words: dict | None = None,
                   fused: bool | None = None,
                   return_grads: bool = False):
        """One optimizer step on `batch_frames` fresh frames; returns
        (state, aux).  `fused=None` takes the fused route where it is
        eligible on a CUDA device; True or False asks for one route.
        `words=` hands the fused synthesize chain its random words (CPU
        only).  `return_grads=True` adds the step's gradients to aux.  On a
        mesh the step is `_mesh_step` on `_synth_mesh`'s shards."""
        if self.mesh is not None:
            if fused or words is not None:
                raise ValueError("a mesh step takes the plain data plane "
                                 "and the autograd route (loop.py:146)")
            bits, rx_in, _, noise_pwr = self._synth_mesh(generator, snr_db)
            return self._mesh_step(state, bits, rx_in,
                                   [{}] * len(bits), noise_pwr, return_grads)
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

    # -- crash-resume plumbing (shared with EqualizerTrainer.fit) -------------
    def _config_sig(self) -> str:
        """Hash of everything that shapes the trajectory (`loop.py:353-364`),
        embedded in resume payloads so that a run with other settings
        refuses a stale payload."""
        ch = self.channel
        parts = (type(self).__name__, repr(self.cfg), repr(self.tc),
                 ch.channel, ch.mobile, ch.mix,
                 getattr(self, "freeze_rx", None),
                 getattr(self, "fused_curriculum", None))
        return hashlib.sha1(repr(parts).encode()).hexdigest()

    def _maybe_resume(self, ckpt_dir, state: TrainState,
                      generator: torch.Generator):
        """Restore `<ckpt_dir>/resume` if it exists (`loop.py:366-388`):
        sets `generator`'s state and the batch size, and returns (state,
        start epoch, best loss, best epoch, best params, resumed)."""
        rp = None if ckpt_dir is None else os.path.join(ckpt_dir, "resume")
        if rp is None or not ckpt.has_resume(rp):
            return state, 0, math.inf, 0, state.params, False
        payload = ckpt.restore_resume(rp, state)
        saved = payload["config_sig"]
        if saved is not None and saved != self._config_sig():
            raise RuntimeError(
                f"resume payload at {rp} was written by a run with a "
                f"different configuration (sig {saved[:12]} != "
                f"{self._config_sig()[:12]}); delete the stale payload or "
                f"use a fresh ckpt_dir")
        generator.set_state(payload["generator_state"])
        cur = payload["cursor"]
        self.batch_frames = cur["batch_frames"]
        st = payload["state"]
        state = TrainState(st.params, st.opt_state, st.step,
                           self._replicate(st.params))
        return (state, cur["epoch"] + 1, cur["best_loss"],
                cur["best_epoch"], payload["best_params"], True)

    def _save_resume(self, ckpt_dir, state, generator, epoch, best_loss,
                     best_epoch, best_params):
        ckpt.save_resume(os.path.join(ckpt_dir, "resume"), state=state,
                         generator=generator, epoch=epoch,
                         best_loss=best_loss, best_epoch=best_epoch,
                         best_params=best_params,
                         batch_frames=self.batch_frames,
                         config_sig=self._config_sig())

    # -- epochs (the reference's epoch/early-stop protocol) -------------------
    def fit(self, seed: int | None = None, max_epochs: int | None = None,
            log_fn=print, grow_batch: bool = True,
            dump_constellations: bool = False,
            init_state: TrainState | None = None,
            ckpt_dir: str | None = None, ckpt_every: int = 50):
        """Epochs of `train_step`, an `eval_step` of 1024 frames after each,
        batch growth, best-params tracking and early stop
        (`loop.py:399-468`).  Returns (state with the best params,
        {"best_epoch", "best_loss", "history"}).

        `init_state` warm-starts from a restored checkpoint.  `ckpt_dir`
        makes the run resumable: a payload is written to
        `<ckpt_dir>/resume` every `ckpt_every` epochs and picked up by the
        next `fit` with the same `ckpt_dir`, which then goes on exactly as
        the uninterrupted run would (cuDNN's deterministic algorithms for
        the length of the fit, `deterministic_cudnn`).
        `dump_constellations` writes each epoch's validation IQ samples
        (`utils.observability`) to `tc.save_dir`."""
        with deterministic_cudnn():
            return self._fit(seed, max_epochs, log_fn, grow_batch,
                             dump_constellations, init_state, ckpt_dir,
                             ckpt_every)

    def _fit(self, seed, max_epochs, log_fn, grow_batch, dump_constellations,
             init_state, ckpt_dir, ckpt_every):
        tc = self.tc
        seed = tc.seed if seed is None else seed
        max_epochs = tc.max_epoch_num if max_epochs is None else max_epochs
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = self.init_state(gen) if init_state is None else init_state
        state, start, best_loss, best_epoch, best_params, resumed = \
            self._maybe_resume(ckpt_dir, state, gen)
        if resumed:
            log_fn(f"resumed from {ckpt_dir}/resume at epoch {start}")
        sel = "total_loss" if tc.best_metric == "total" else "ce"
        history = []
        for epoch in range(start, max_epochs):
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
                self.batch_frames = self._round_to_dp(
                    self._ideal_batch_frames(last_ber))
            if dump_constellations:
                dump_constellation(tc.token, val["iq_tx"], val["iq_rx"],
                                   out_dir=tc.save_dir)
            history.append({"epoch": epoch, "train_loss": epoch_loss,
                            "val_ber": float(val["ber"]),
                            "val_loss": float(val["ce"])})
            log_fn(f"epoch {epoch}: train_ce={epoch_loss:.5f} "
                   f"val_ber={float(val['ber']):.6f}")
            if epoch_loss < best_loss:
                best_loss, best_epoch = epoch_loss, epoch
                best_params = state.params
            if ckpt_dir is not None and (epoch + 1) % ckpt_every == 0:
                self._save_resume(ckpt_dir, state, gen, epoch, best_loss,
                                  best_epoch, best_params)
            if epoch - tc.early_stop > best_epoch:
                break
        state = TrainState(best_params, state.opt_state, state.step,
                           self._replicate(best_params))
        return state, {"best_epoch": best_epoch, "best_loss": best_loss,
                       "history": history}
