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

Every route takes its optimizer step through `Adam.step`, which chooses
its path from the leaves: one launch of the optimizer kernel
(`ops/fused_adam.py`: the L2 fold, Adam and the parameter write) wherever
the leaves are float32 on one card and `grad_clip` is 0 (on every route,
and on a mesh with tp = 1); with clipping, on a tp mesh's shard lists and
on the CPU `fused_adam.l2_fold` and `Adam.update`'s `_foreach_*` path,
with the same float32 arithmetic.

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

With `mesh=` (`parallel/mesh.py`, a [dp, tp] grid) the step is JAX's
mesh step (`loop.py:96-106`, `:187-229`): the plain data plane and the
autograd route on every dp row, each row's shard of the frames drawn on
its device from its own generator and normalized with its own moments
(`_synth_mesh`), the gradients summed over the rows (`_mesh_step`).  With
tp > 1 the leaves that JAX's rules split (`parallel.mesh.shard_dims`) live
as shards on the tp ranks of every row (`TrainState.replicas`); a row's
forward pass runs on its tp ranks (`parallel/tp.py`), each shard's
gradient stays on its rank, the L2 term sums the shards' squares, and
Adam runs on the shards (a split leaf's moments are the list of this
process's shards, one a tp index it holds, on its first rank with that
index).  `TrainState.params` holds the gathered (full) parameters after
every step, for evaluation, sweeps and checkpoints (over processes the
gather is an `all_reduce` of the split leaves each step).

On a mesh over a group of processes (`parallel/distributed.py`), each
process runs and differentiates only the dp rows it holds a rank of; a
row's owner draws its frames (and broadcasts them where the row spans
processes: its tp ranks then meet through `parallel/tp.py`'s autograd
functions); the rows' noise powers, CE terms, confusion counts, further
metrics and replicated leaves' gradients are combined over the processes
by `parallel.mesh.gather_rows` and summed in row order, a split leaf's
shard gradients over the processes of its tp column, so the L2 term sees
the global BER and every process runs Adam on the same gradients (on the
replicated leaves and on its own shards), with the one-process mesh's
numbers.  `fit` takes every decision on process
0's numbers (`distributed.agree`), only process 0 logs and writes resume
payloads, and every process restores them (`ckpt_dir` must be a
directory every process sees).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import math
import os

import torch
from torch.func import functional_call

from dl_ofdm_tpu_torch import resolve_device
from dl_ofdm_tpu_torch.channel.awgn import awgn_channel
from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.ofdm.tx import ofdm_modulate_frames_iq
from dl_ofdm_tpu_torch.ops.fused_adam import (AdamHyper, AdamLayout,
                                              fused_adam_kernel,
                                              kernel_layout, l2_fold)
from dl_ofdm_tpu_torch.ops.fused_model import ModelSpec, dccn_fused_grads
from dl_ofdm_tpu_torch.ops.fused_synth import (_combine_stats,
                                               fused_synthesize,
                                               synth_spec_for)
from dl_ofdm_tpu_torch.ops.norms import batch_norm_ref
from dl_ofdm_tpu_torch.parallel import distributed as pd
from dl_ofdm_tpu_torch.parallel.mesh import (exchange, gather_rows,
                                             gather_shards, module_replicas,
                                             rank_generators, shard_dims,
                                             shard_of, shard_params)
from dl_ofdm_tpu_torch.parallel.tp import TensorParallel
from dl_ofdm_tpu_torch.train import checkpoint as ckpt
from dl_ofdm_tpu_torch.train import metrics as M
from dl_ofdm_tpu_torch.utils.observability import dump_constellation, span


@dataclasses.dataclass
class TrainState:
    params: dict          # name -> tensor, keyed as the model's state_dict()
    opt_state: dict       # Adam moments and count (`Adam.init`)
    step: int
    # on a mesh: each (dp, tp) rank's parameters on its device, row-major
    # (`parallel.mesh.shard_params`: with tp = 1 a copy of `params` per dp
    # rank)
    replicas: list[dict] | None = None


def flatten_leaves(tree: dict):
    """A dict whose values are tensors or lists of tensors (the shards of a
    leaf split over tp ranks) -> (its structure, the flat list of
    tensors)."""
    spec, flat = [], []
    for k, v in tree.items():
        if isinstance(v, list):
            spec.append((k, len(v)))
            flat.extend(v)
        else:
            spec.append((k, None))
            flat.append(v)
    return spec, flat


def unflatten_leaves(spec, flat) -> dict:
    """The inverse of `flatten_leaves`."""
    out, i = {}, 0
    for k, n in spec:
        out[k] = flat[i] if n is None else list(flat[i:i + n])
        i += 1 if n is None else n
    return out


class Adam:
    """optax's `adam` (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt) behind
    its staircase `exponential_decay` schedule, optionally after
    `clip_by_global_norm` (`loop.py:60-67`), as functions of dicts of
    tensors: `init(params)`, `step(...)`, the step and the parameter write
    on the path the leaves allow, and `update(grads, state)`, the updates
    on the `_foreach_*` path.  A value may be the list of a split leaf's
    shards (a tp mesh): Adam runs on each shard on its device, and the
    global norm counts each element once."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    # steps `update` took on CUDA leaves (the `_foreach_*` path)
    foreach_steps = 0

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self._layouts = {}        # the fused kernel's, by leaf set

    def learning_rate(self, count: int) -> float:
        """The rate of the update that `count` updates precede."""
        tc = self.tc
        return tc.init_learning * tc.lr_decay_rate ** (
            count // tc.lr_decay_steps)

    def init(self, params: dict) -> dict:
        spec, flat = flatten_leaves(params)
        return {"count": 0,
                "mu": unflatten_leaves(spec, [torch.zeros_like(v)
                                              for v in flat]),
                "nu": unflatten_leaves(spec, [torch.zeros_like(v)
                                              for v in flat])}

    def update(self, grads: dict, state: dict, sq: list | None = None):
        """(updates, new state); add the updates to the parameters.

        optax's operations in optax's order, each over all tensors at once
        (`torch._foreach_*`: one launch per operation, not per tensor).
        `sq`: the sums of squares of every tensor of the whole gradient,
        in order, for the global norm, where `grads` holds only some
        shards of a split leaf (a mesh over processes)."""
        spec, g = flatten_leaves(grads)
        moments = {m: flatten_leaves({k: state[m][k] for k in grads})[1]
                   for m in ("mu", "nu")}
        if g and g[0].is_cuda:
            Adam.foreach_steps += 1
        clip = self.tc.grad_clip
        if clip > 0:
            # optax's clip_by_global_norm: g if ||g|| < c else (g / ||g||) c
            # (no epsilon, unlike torch's clip_grad_norm_)
            terms = (torch.sum(t * t) for t in g) if sq is None else sq
            norm = torch.sqrt(sum(v.to(g[0].device) for v in terms))
            g = [torch.where(n < clip, t, (t / n) * clip)
                 for t, n in ((t, norm.to(t.device)) for t in g)]
        count = state["count"] + 1
        lr = self.learning_rate(state["count"])
        b1, b2 = self.b1, self.b2
        mul, add, div = (torch._foreach_mul, torch._foreach_add,
                         torch._foreach_div)
        mu = add(mul(g, 1 - b1), mul(moments["mu"], b1))
        nu = add(mul(mul(g, g), 1 - b2), mul(moments["nu"], b2))
        mu_hat = div(mu, 1 - b1 ** count)
        nu_hat = div(nu, 1 - b2 ** count)
        den = add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = mul(div(mu_hat, den), -lr)
        return unflatten_leaves(spec, upd), {
            "count": count, "mu": unflatten_leaves(spec, mu),
            "nu": unflatten_leaves(spec, nu)}

    def _kernel_leaves(self, keys, params: dict, grads: dict, state: dict):
        """(the kernel's layout, its leaves: parameters, gradients and both
        moments of `keys`) where `fused_adam_kernel` takes the step: every
        leaf float32 on one CUDA device (a leaf in another layout copied to
        the kernel's, `kernel_layout`) and no clipping; else None."""
        if self.tc.grad_clip > 0:
            return None
        leaves = ([params[k] for k in keys], [grads[k] for k in keys],
                  [state["mu"][k] for k in keys],
                  [state["nu"][k] for k in keys])
        lay = AdamLayout.of(self._layouts, keys, *leaves)
        if lay is None:
            leaves = kernel_layout(*leaves)
            if leaves is None:
                return None
            lay = AdamLayout.of(self._layouts, keys, *leaves)
        return lay, leaves

    def step(self, params: dict, grads: dict, state: dict, conf=None,
             ce=None, reg_coeff: float = 0.0, sq: list | None = None,
             return_grads: bool = False):
        """The step and the parameter write on `grads`' keys: (their new
        parameters, the new state, the loss scalars (`fused_adam.SCALARS`,
        with `conf`) or None, the gradients the update used (with
        `return_grads`) or None).  With the counts `conf` and the mean `ce`
        the `Dense` leaves' L2 term is folded into their gradients.

        One launch of `fused_adam_kernel` where `_kernel_leaves` allows it;
        else `fused_adam.l2_fold` (with `conf`), `update` (clipping, split
        leaves' shard lists, `sq` as there) and the parameter add.  Spans:
        with `conf` the choice and the fold under `optim.loss_terms`, then
        the launch or the update under `optim.adam`; without, the whole
        step under `optim.adam`."""
        keys = list(grads)
        if conf is None:
            with span("optim.adam"):
                kernel = self._kernel_leaves(keys, params, grads, state)
                return self._launch_or_update(
                    kernel, keys, params, grads, state, sq=sq,
                    return_grads=return_grads)
        scalars = None
        with span("optim.loss_terms"):
            kernel = self._kernel_leaves(keys, params, grads, state)
            if kernel is None:
                gs, scalars = l2_fold(keys, [params[k] for k in keys],
                                      [grads[k] for k in keys], conf, ce,
                                      reg_coeff)
                grads = dict(zip(keys, gs))
        with span("optim.adam"):
            return self._launch_or_update(
                kernel, keys, params, grads, state, conf, ce, reg_coeff, sq,
                return_grads, scalars)

    def _launch_or_update(self, kernel, keys, params, grads, state,
                          conf=None, ce=None, reg_coeff=0.0, sq=None,
                          return_grads=False, scalars=None):
        """`step`'s second half on the path `kernel` (`_kernel_leaves`'
        answer) names; the plain path's `grads` are already folded."""
        if kernel is not None:
            lay, leaves = kernel
            count = state["count"]
            hp = AdamHyper(self.b1, self.b2, self.eps,
                           self.learning_rate(count), count + 1)
            out = fused_adam_kernel(lay, *leaves, hp, conf, ce, reg_coeff,
                                    return_grads)
            return (dict(zip(keys, out.params)),
                    {"count": hp.count, "mu": dict(zip(keys, out.mu)),
                     "nu": dict(zip(keys, out.nu))}, out.scalars,
                    None if out.grads is None
                    else dict(zip(keys, out.grads)))
        updates, state = self.update(grads, state, sq)
        spec, upd = flatten_leaves(updates)
        new = unflatten_leaves(spec, torch._foreach_add(
            flatten_leaves({k: params[k] for k in keys})[1], upd))
        return new, state, scalars, grads if return_grads else None


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


def _row_sums(stacks: list) -> list:
    """Each [dp, ...] stack summed over its rows in row order."""
    out = [s[0] for s in stacks]
    for r in range(1, stacks[0].shape[0] if stacks else 0):
        out = torch._foreach_add(out, [s[r] for s in stacks])
    return out


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

    `mesh` (a `parallel.mesh.Mesh`) makes the step data parallel over its
    dp rows and, with tp > 1, tensor parallel over each row's tp ranks;
    `batch_frames` is rounded up to a multiple of dp (the tp ranks of a
    row share its frames), the device is the mesh's `home` (rank 0's in
    one process), and the fused route is never taken (`loop.py:146`)."""

    def __init__(self, cfg: OFDMConfig, tc: TrainConfig, channel: str = "AWGN",
                 mobile: bool = False, mix: bool | None = None,
                 model: torch.nn.Module | None = None,
                 device: str | torch.device | None = None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            home = mesh.home
            if device is not None and resolve_device(device) != home:
                raise ValueError(f"device {device} is not the mesh's home "
                                 f"rank's ({home})")
            device = home
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
        # device: the synth kernel's, then the model's
        self._fused_synth_spec = synth_spec_for(self.plan, self.channel,
                                                cfg.nbits)
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
        # the model on every dp row's device, for the rows' forward passes
        self._rank_models = (None if mesh is None else
                             module_replicas(self.model,
                                             mesh.local_dp_devices))
        # the axis each parameter is split along over tp (None: replicated)
        self._dims = ({} if mesh is None else
                      shard_dims(mesh, self.model.state_dict()))
        self._tp = any(d is not None for d in self._dims.values())
        if self._tp and "tp" not in inspect.signature(
                self.model.forward).parameters:
            raise ValueError(f"{type(self.model).__name__} has split "
                             "parameters on this mesh but no tensor-"
                             "parallel forward (tp=)")

    def _round_to_dp(self, frames: int) -> int:
        """`frames` rounded up to a multiple of the mesh's dp (so that every
        rank gets equal shards, `loop.py:102-106`)."""
        if self.mesh is None:
            return frames
        return frames + (-frames) % self.mesh.shape["dp"]

    def _replicate(self, params: dict) -> list[dict] | None:
        """Each local (dp, tp) rank's parameters; None off a mesh."""
        return None if self.mesh is None else shard_params(self.mesh, params)

    def _multiprocess(self) -> bool:
        return self.mesh is not None and self.mesh.multiprocess

    def _leaves(self, params: dict, replicas: list[dict] | None,
                keys) -> dict:
        """The optimizer's view of `keys`: the full tensor of a replicated
        leaf (from `params`), the list of this process's shards of a split
        one, one a tp index it holds (`mesh.local_tps`; every index in one
        process), from its first rank with that index (`replicas`)."""
        mesh = self.mesh
        return {k: params[k] if self._dims.get(k) is None
                else [replicas[mesh.tp_slot(t)][k] for t in mesh.local_tps]
                for k in keys}

    def _gathered(self, leaves: dict) -> dict:
        """`leaves` with each split leaf's shards made whole on the home
        device (from the other processes too: collective on a mesh over
        processes)."""
        if self.mesh is None:
            return dict(leaves)
        return gather_shards(self.mesh, leaves, self.device)

    def _l2_view(self, leaves: dict, full: dict) -> dict:
        """`leaves` with each split leaf's list holding every tp shard, in
        tp order: this process's as they are, the others cut from the
        gathered parameters `full` (`shard_of`: the same tensors, so the
        L2 term's sums of squares are the one-process mesh's)."""
        mesh = self.mesh
        if mesh is None or mesh.tps_local:
            return leaves
        tp, pos = mesh.shape["tp"], {t: i for i, t in
                                     enumerate(mesh.local_tps)}
        return {k: [v[pos[t]] if t in pos else shard_of(k, full[k], tp, t)
                    for t in range(tp)] if isinstance(v, list) else v
                for k, v in leaves.items()}

    def _new_state(self, params: dict, keys) -> TrainState:
        """`params` with a zero Adam state over `keys` (on the shards); on a
        mesh over processes, process 0's `params` in every process."""
        if self._multiprocess():
            for v in params.values():
                pd.broadcast_(v)
        replicas = self._replicate(params)
        return TrainState(params, self.optimizer.init(
            self._leaves(params, replicas, keys)), 0, replicas)

    # -- state ---------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None
                   ) -> TrainState:
        """Fresh parameters with flax's initializers, drawn from
        `generator` (on the trainer's device), and a zero Adam state; on a
        mesh, with the ranks' shards."""
        self.model.reset_parameters(generator)
        params = {k: v.detach().clone()
                  for k, v in self.model.state_dict().items()}
        return self._new_state(params, list(params))

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
        with span("data.tx"):
            if bits is None:
                bits = torch.randint(
                    0, 2, (n_frames, self.plan.frame_size, self.cfg.nbits),
                    generator=generator, device=dev, dtype=torch.int32)
            wf = ofdm_modulate_frames_iq(bits, self.plan)    # [B, S, K+CP, 2]
        with span("data.channel"):
            ch = self.channel(wf, generator)
        with span("data.awgn"):
            y_iq, noise_pwr = awgn_channel(ch.y, snr_db, generator,
                                           unit_noise=unit_noise)
        with span("data.norm"):
            rx_in = (batch_norm_ref(y_iq, group_onehot=norm_groups)
                     if normalize else y_iq)
        return bits, rx_in, ch.h_freq, noise_pwr, wf

    # -- loss ----------------------------------------------------------------
    def _rank_terms(self, params: dict, bits: torch.Tensor,
                    rx_in: torch.Tensor, model: torch.nn.Module | None = None,
                    tp: TensorParallel | None = None):
        """What the frames give the loss: (CE, confusion counts, further
        metrics) of `params` on one batch, through `model` (the trainer's
        by default; a dp row's copy on a mesh), tensor parallel over `tp`'s
        ranks where given."""
        with span("model.forward"):
            logits = first_output(functional_call(
                model or self.model, params, (rx_in,),
                None if tp is None else {"tp": tp}))
            ce = M.cross_entropy(logits, bits, self.tc.double_softmax)
            conf = M.confusion_matrix(bits, M.bit_predictions(logits))
        return ce, conf, {}

    def _global_terms(self, params: dict, ce: torch.Tensor,
                      conf: torch.Tensor):
        """(CE + stop_grad(BER) * reg_coeff * L2, metrics) from the batch's
        CE and counts (`loop.py:257-272`)."""
        with span("optim.loss_terms"):
            reg = M.l2_regularization(params)
            log_ber, ber = M.ber_from_confusion(conf)
            loss = ce + ber.detach() * self.tc.reg_coeff * reg
            aux = {"ce": ce, "ber": ber, "log_ber": log_ber, "conf": conf,
                   "total_loss": (ce + ber * self.tc.reg_coeff * reg
                                  + log_ber)}
        return loss, aux

    def _loss_fn(self, params: dict, bits: torch.Tensor,
                 rx_in: torch.Tensor):
        """(the loss, metrics) of `params` on one batch."""
        ce, conf, _ = self._rank_terms(params, bits, rx_in)
        return self._global_terms(params, ce, conf)

    # -- the mesh (dp) ---------------------------------------------------------
    def _synth_mesh(self, generator: torch.Generator, snr_db: torch.Tensor,
                    want_h: bool = False):
        """The data plane over the dp rows this process holds a rank of
        (`loop.py:206-228`): row r draws `batch_frames / dp` frames at its
        slice of `snr_db` on its device from its own generator
        (`rank_generators`: one draw of `generator` plus r, for JAX's
        `fold_in(key, axis_index)`) and normalizes them with its own
        moments.  A row's owner draws it; where the row spans processes
        the owner broadcasts its bits, input (and true channel) to the
        row's other processes (one draw, the noise power counted once).
        Returns the local rows' lists (bits, rx_in, h_freq or None without
        `want_h`) and the noise power averaged over every row of the
        mesh."""
        mesh = self.mesh
        rows = mesh.owned_rows
        devs = [mesh.row_device(r) for r in rows]
        snrs = torch.chunk(snr_db, mesh.shape["dp"])
        local = self.batch_frames // mesh.shape["dp"]
        drawn = {r: self.synthesize(local, snrs[r].to(dev), gen, device=dev)
                 for dev, gen, r in zip(devs, rank_generators(
                     generator, devs, rows, self.device), rows)}
        noise_pwr = gather_rows(
            mesh, [[drawn[r][3]] for r in rows], self.device,
            like=[torch.zeros((), device=self.device)])[0].mean()
        out = []
        for r in mesh.local_rows:
            row = drawn.get(r)
            if row is not None:
                row = [row[0], row[1]] + ([row[2]] if want_h else [])
            if mesh.row_groups[r] is not None:
                row = pd.broadcast_tensors(row, mesh.owner(r),
                                           mesh.row_groups[r], mesh.home)
                row = [t.to(mesh.row_device(r)) for t in row]
            out.append(row)
        bits, rx_in = [o[0] for o in out], [o[1] for o in out]
        h_freq = [o[2] for o in out] if want_h else None
        return bits, rx_in, h_freq, noise_pwr

    def _grad_keys(self, params: dict) -> list[str]:
        """The parameters that take gradients: all of them."""
        return list(params)

    def _mesh_step(self, state: TrainState, bits: list, rx_in: list,
                   extras: list, noise_pwr: torch.Tensor,
                   return_grads: bool = False):
        """One mesh step on the shards of the frames of the rows this
        process holds a rank of (`mesh.local_rows`; `extras[i]`: further
        arguments of local row i's `_rank_terms`; every row's shard has as
        many frames; every process of a row holds the row's shard).

        Every local dp row runs the forward pass on its frames with its
        ranks' parameters (tensor parallel over its tp ranks, across the
        row's processes where it spans them); the confusion counts are
        summed over every row of the mesh first, so the L2 term takes the
        global BER as JAX's global-batch loss does; each row's backward
        pass runs on its CE weighted by its share of the frames.  The rows'
        gradients are summed in row order: a replicated leaf's (the same
        in every process of a row) from each row's owner (`gather_rows`),
        on the home device; shard t of a split leaf's over the processes
        that hold tp index t (the column's group), on this process's first
        rank with that index.  The L2 term's gradient is added once, Adam
        runs in every process on the replicated leaves and on its own
        shards, with the same gradients, and every local rank receives its
        part of the new parameters."""
        mesh, dev0 = self.mesh, self.device
        tp, dp = mesh.shape["tp"], mesh.shape["dp"]
        keys = self._grad_keys(state.params)
        sizes = {b.shape[0] for b in bits}
        if len(sizes) != 1 or len(bits) != len(mesh.local_rows):
            raise ValueError(f"one shard of equal frames a local row "
                             f"({len(mesh.local_rows)}), got "
                             f"{[b.shape[0] for b in bits]}")
        total = sizes.pop() * dp
        rep_keys = [k for k in keys if self._dims[k] is None]
        split_keys = [k for k in keys if self._dims[k] is not None]
        ranks = []
        for row_id, b, x, extra in zip(mesh.local_rows, bits, rx_in, extras):
            slots = mesh.row_slots(row_id)
            row = [dict(state.replicas[i]) for i in slots]
            for k in keys:
                for r in row[:len(row) if self._dims[k] is not None else 1]:
                    r[k] = r[k].detach().requires_grad_()
            leaves = [row[0][k] for k in rep_keys] + [
                r[k] for k in split_keys for r in row]
            ctx = (TensorParallel.for_row(mesh, row_id, row, self._dims)
                   if self._tp else None)
            ce, conf, more = self._rank_terms(
                row[0], b, x, model=self._rank_models[x.device], tp=ctx,
                **extra)
            ranks.append((row_id, leaves, ce * (b.shape[0] / total), conf,
                          more))
        # every row's CE term, counts and further metrics, in row order
        more = list(ranks[0][4])
        share = bits[0].shape[0] / total
        terms = gather_rows(mesh, [
            [w.detach(), c] + [m[k].detach() * share for k in more]
            for row_id, _, w, c, m in ranks if row_id in mesh.owned_rows],
            dev0, like=[ranks[0][2].detach(), ranks[0][3]]
            + [ranks[0][4][k].detach() for k in more])
        ce = sum(terms[0][r] for r in range(dp))
        conf = sum(terms[1][r] for r in range(dp))
        # the parameter term, once, on this process's leaves (the CE is
        # detached); the L2 term sees every shard
        params = self._leaves(state.params, state.replicas, state.params)
        spec, train = flatten_leaves({k: params[k] for k in keys})
        train = [t.detach().requires_grad_() for t in train]
        params.update(unflatten_leaves(spec, train))
        loss, aux = self._global_terms(self._l2_view(params, state.params),
                                       ce, conf)
        row_grads = []
        for _, leaves, w, _, _ in ranks:
            with span("model.backward"):
                row_grads.append(torch.autograd.grad(
                    w, leaves, materialize_grads=True))
        # replicated leaves: each row's owner's gradients, on the home
        # device, summed in row order
        n_rep = len(rep_keys)
        rep = gather_rows(mesh, [
            [g.to(dev0) for g in grads[:n_rep]]
            for (row_id, *_), grads in zip(ranks, row_grads)
            if row_id in mesh.owned_rows], None,
            like=[g.to(dev0) for g in row_grads[0][:n_rep]])
        summed = dict(zip(rep_keys, _row_sums(rep)))
        # shard t of each split leaf: summed over the dp rows in row order
        # by the processes that hold tp index t (a row's gradients hold
        # each split key's local shards in tp order)
        for t in mesh.local_tps:
            slots = {}
            for (row_id, *_), grads in zip(ranks, row_grads):
                ts = [mesh.local_ranks[i] % tp for i in mesh.row_slots(row_id)]
                if t in ts:
                    slots[row_id] = grads[n_rep + ts.index(t)::len(ts)]
            dest = mesh.rank_devices[mesh.local_ranks[mesh.tp_slot(t)]]
            group = mesh.col_groups[t]
            stacks = ([torch.stack([g.to(dest) for g in gs]) for gs in
                       zip(*(slots[r] for r in range(dp)))] if group is None
                      else [s.to(dest) for s in exchange(
                          slots, dp, next(iter(slots.values())), group,
                          mesh.home)])
            summed.update(zip([(k, t) for k in split_keys],
                              _row_sums(stacks)))
        flat = []
        for k, n in spec:
            flat += ([summed[k]] if n is None
                     else [summed[(k, t)] for t in mesh.local_tps])
        with span("model.backward"):
            l2_grads = torch.autograd.grad(loss, train, materialize_grads=True)
        with span("optim.loss_terms"):
            grads = unflatten_leaves(spec, torch._foreach_add(flat, l2_grads))
        aux = {k: v.detach() for k, v in aux.items()}
        for i, k in enumerate(more):
            aux[k] = sum(terms[2 + i][r] for r in range(dp))
        aux.update(loss=loss.detach(), noise_power=noise_pwr)
        if return_grads:
            aux["grads"] = grads
        return self._apply(state, grads), aux

    # -- steps ---------------------------------------------------------------
    def _apply(self, state: TrainState, grads: dict) -> TrainState:
        """The optimizer on the parameters that `grads` holds (a split
        leaf's shards where its gradient is their list); any other
        parameter keeps its tensor."""
        sq = None
        if (self.tc.grad_clip > 0 and self.mesh is not None
                and not self.mesh.tps_local):
            # the global norm over every shard, as the one-process mesh
            # takes it
            full, tp = self._gathered(grads), self.mesh.shape["tp"]
            sq = [torch.sum(s * s) for k, v in grads.items()
                  for s in ([shard_of(k, full[k], tp, t) for t in range(tp)]
                            if isinstance(v, list) else [v])]
        new, opt_state, _, _ = self.optimizer.step(
            self._leaves(state.params, state.replicas, grads), grads,
            state.opt_state, sq=sq)
        params = dict(state.params)
        params.update(self._gathered(new))
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
            with span("data.fused_synth"):
                bits, rx_in, noise_pwr = fused_synthesize(
                    self._fused_synth_spec, b, generator, snr_db,
                    words=words)
        else:
            bits, rx_in, _, noise_pwr, _ = self.synthesize(b, snr_db,
                                                           generator)
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        loss, aux = self._loss_fn(params, bits, rx_in)
        with span("model.backward"):
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        aux = {k: v.detach() for k, v in aux.items()}
        aux.update(loss=loss.detach(), noise_power=noise_pwr)
        if return_grads:
            aux["grads"] = grads
        return self._apply(state, grads), aux

    def _train_step_fused(self, state, generator, snr_db, words,
                          return_grads):
        """Synth kernel (raw planes) -> batch moments -> fused model
        gradient kernel -> L2 gradient -> Adam (`loop.py:296-335`); the last
        two and the loss scalars in one `Adam.step` (one kernel launch on
        a card)."""
        b = self.batch_frames
        with span("data.fused_synth"):
            idx, yr, yi, nr, ni, stats = fused_synthesize(
                self._fused_synth_spec, b, generator, snr_db, raw=True,
                words=words)
            _, c, noise_pwr, _ = _combine_stats(stats.sum(0), b)
        with span("model.fused_grads"):
            grads, ce, conf = dccn_fused_grads(
                self._fused_model_spec, b, state.params, yr, yi, nr, ni, c,
                idx)
        new, opt_state, sc, used = self.optimizer.step(
            state.params, grads, state.opt_state, conf, ce,
            self.tc.reg_coeff, return_grads=return_grads)
        params = dict(state.params)
        params.update(new)
        aux = {"ce": ce, "ber": sc["ber"], "log_ber": sc["log_ber"],
               "conf": conf, "total_loss": sc["total_loss"],
               "loss": sc["loss"], "noise_power": noise_pwr}
        if return_grads:
            aux["grads"] = used
        return TrainState(params, opt_state, state.step + 1), aux

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
        found = rp is not None and ckpt.has_resume(rp)
        if self._multiprocess() and not (pd.all_true(found, self.device)
                                         or pd.all_true(not found,
                                                        self.device)):
            raise RuntimeError(f"the resume payload at {rp} is seen by some "
                               "processes only: ckpt_dir must be a "
                               "directory every process sees")
        if not found:
            return state, 0, math.inf, 0, state.params, False
        payload = ckpt.restore_resume(rp, state, self.mesh)
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
        """Process 0 writes the payload; the others wait until it has (on
        a mesh over processes they hand it their shards of the Adam
        moments first)."""
        if self._multiprocess() or pd.is_main_process():
            ckpt.save_resume(os.path.join(ckpt_dir, "resume"), state=state,
                             generator=generator, epoch=epoch,
                             best_loss=best_loss, best_epoch=best_epoch,
                             best_params=best_params,
                             batch_frames=self.batch_frames,
                             config_sig=self._config_sig(), mesh=self.mesh)

    def _main_log(self, log_fn):
        """`log_fn` in process 0, a no-op in the others."""
        return (log_fn if not self._multiprocess() or pd.is_main_process()
                else lambda *a: None)

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
        log_fn = self._main_log(log_fn)
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
            val = self.eval_step(state.params, gen, 1024,
                                 torch.full((1024,), tc.snr,
                                            device=self.device))
            # the decisions' numbers: process 0's in every process
            last_ber, epoch_loss, val_ber, val_ce = pd.agree(
                [aux["ber"], torch.stack(losses).mean(), val["ber"],
                 val["ce"]], self.device)
            with span("fit.epoch_end"):
                if grow_batch:
                    self.batch_frames = self._round_to_dp(
                        self._ideal_batch_frames(last_ber))
                if dump_constellations and pd.is_main_process():
                    dump_constellation(tc.token, val["iq_tx"], val["iq_rx"],
                                       out_dir=tc.save_dir)
                history.append({"epoch": epoch, "train_loss": epoch_loss,
                                "val_ber": val_ber, "val_loss": val_ce})
                log_fn(f"epoch {epoch}: train_ce={epoch_loss:.5f} "
                       f"val_ber={val_ber:.6f}")
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
