"""The equalizer fine-tuning stage (transfer learning).

Port of `dl_ofdm_tpu/train/equalizer_loop.py` (reference
`dev/py/ofdmreceiver_np_mp.py main()`):

  1. a DCCN receiver pretrained on AWGN (`train.loop.Trainer`);
  2. an `EqualizedReceiver` with the pretrained receiver grafted in
     (`train.transfer.graft_pretrained`);
  3. only the 'Equalizer' parameters train, with a fresh Adam state over
     them alone (`transfer.scope_mask`); the receiver takes no gradient;
  4. a per-frame SNR curriculum (`train.curriculum.sample_snr`);
  5. the channel by name (mixRayleigh by default), Jakes Doppler with
     `mobile=True`;
  6. diagnostics: the SNR estimate's MSE and the layer-normed channel
     estimate's MSE against the true channel.

`train_step_curriculum` runs on the plain data plane (`Trainer.synthesize`,
whose static FIR is the `fir_shift_accum` kernel on a card), as the JAX
package does by default (`fused_curriculum = False`, `equalizer_loop.py:96`);
assigning `fused_curriculum = True` takes the synth kernel with the true
channel (`fused_synthesize(..., want_h=True)`; its plain version on the
CPU).  With `mesh=` (`parallel/mesh.py`) the step is data parallel over
the dp rows on the plain data plane (`Trainer._synth_mesh` with the true
channel, `equalizer_loop.py:159-160`) and, with tp > 1, tensor parallel
over each row's tp ranks: the equalizer's `Dense_interp*` and
`Dense_block*` and the frozen receiver's `fft_like` and `Dense_extract`
split by JAX's rules (`parallel/tp.py`), Adam on the `Equalizer` keys'
shards.  `fit(ckpt_dir=)` resumes as
`Trainer.fit` does, its signature covering `freeze_rx` and
`fused_curriculum` (`equalizer_loop.py:192-236`).
"""
from __future__ import annotations

import torch

from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.models.equalizers import EQUALIZER_REGISTRY, EqSpec
from dl_ofdm_tpu_torch.models.receiver import EqualizedReceiver
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.ops.fused_synth import fused_synthesize
from dl_ofdm_tpu_torch.ops.norms import frame_layer_norm
from dl_ofdm_tpu_torch.parallel import distributed as pd
from dl_ofdm_tpu_torch.train import metrics as M
from dl_ofdm_tpu_torch.train.curriculum import modulation_offset_db, sample_snr
from dl_ofdm_tpu_torch.train.loop import (Trainer, TrainState,
                                         deterministic_cudnn)
from dl_ofdm_tpu_torch.train.transfer import graft_pretrained, scope_mask


class EqualizerTrainer(Trainer):
    """Trainer of the equalized receiver in front of a frozen pretrained
    DCCN.  `pretrained_rx` is the receiver's parameters keyed as its
    `state_dict()` (`params_from_flax(load_params_npz(arm))`);
    `freeze_rx=False` trains the receiver too.  `device` defaults to
    `cuda`; `mesh` as for `Trainer`."""

    def __init__(self, cfg: OFDMConfig, tc: TrainConfig,
                 channel: str = "mixRayleigh", mobile: bool = False,
                 mix: bool | None = None, pretrained_rx: dict | None = None,
                 eq_spec: EqSpec | None = None, mesh=None,
                 freeze_rx: bool = True,
                 device: str | torch.device | None = None):
        spec = EQUALIZER_REGISTRY[tc.opt] if eq_spec is None else eq_spec
        plan = build_plan(cfg)
        model = EqualizedReceiver(
            nbits=cfg.nbits, nfft=cfg.nfft, cp_len=plan.cp_len,
            nfilter=cfg.nfilter, frame_size=plan.frame_size,
            nsymbol=plan.nsymbol, pilot_size=plan.pilot_size,
            pilot_carriers=tuple(plan.pilot_carriers), keep_cp=cfg.cp,
            eq_spec=spec, compute_dtype=cfg.compute_dtype)
        super().__init__(cfg, tc, channel=channel, mobile=mobile, mix=mix,
                         model=model, device=device, mesh=mesh)
        self.pretrained_rx = pretrained_rx
        self.freeze_rx = freeze_rx
        self._eq_reg_coeff = 1e-3          # `ofdmreceiver_np_mp.py:338`
        self._snr_offset = (tc.curriculum_offset
                            if tc.curriculum_offset is not None
                            else modulation_offset_db(cfg.nbits))
        # the data plane of `train_step_curriculum` (see the module note)
        self.fused_curriculum = False
        self._trainable: list[str] = []

    def _set_trainable(self, params: dict) -> None:
        """The keys of `params` that take gradients and Adam moments: the
        Equalizer scope, or every key with `freeze_rx=False`."""
        mask = scope_mask(params, "Equalizer")
        self._trainable = [k for k in params if mask[k] or not self.freeze_rx]

    def init_state(self, generator: torch.Generator | None = None
                   ) -> TrainState:
        """Fresh parameters (flax's initializers, from `generator`), the
        pretrained receiver grafted in, and the optimizer's state."""
        self.model.reset_parameters(generator)
        params = {k: v.detach().clone()
                  for k, v in self.model.state_dict().items()}
        if self.pretrained_rx is not None:
            params = graft_pretrained(params, self.pretrained_rx)
        self._set_trainable(params)
        return self._new_state(params, self._trainable)

    def _grad_keys(self, params: dict) -> list[str]:
        return self._trainable

    # -- loss with the equalizer stage's coefficient and diagnostics ---------
    def _rank_terms(self, params: dict, bits: torch.Tensor,
                    rx_in: torch.Tensor, h_freq: torch.Tensor | None = None,
                    snr_db: torch.Tensor | None = None,
                    model: torch.nn.Module | None = None, tp=None):
        """(CE, confusion counts, metrics) of one batch, the metrics with
        `snr_mse` given snr_db and `chan_mse` given the true channel
        (`equalizer_loop.py:141-163`); tensor parallel over `tp`'s ranks
        where given."""
        logits, _, _, snr_est, chest = torch.func.functional_call(
            model or self.model, params, (rx_in,),
            None if tp is None else {"tp": tp})
        ce = M.cross_entropy(logits, bits, self.tc.double_softmax)
        conf = M.confusion_matrix(bits, M.bit_predictions(logits))
        aux = {}
        if snr_db is not None:
            # the reference's unit mismatch: a log10 estimate against dB
            aux["snr_mse"] = torch.mean((snr_est - snr_db.reshape(-1, 1)) ** 2)
        if h_freq is not None:
            aux["chan_mse"] = torch.mean(
                (frame_layer_norm(h_freq) - frame_layer_norm(chest)) ** 2)
        return ce, conf, aux

    def _global_terms(self, params: dict, ce: torch.Tensor,
                      conf: torch.Tensor):
        """(CE + 1e-3 L2, metrics) from the batch's CE and counts."""
        reg = M.l2_regularization(params)
        log_ber, ber = M.ber_from_confusion(conf)
        loss = ce + self._eq_reg_coeff * reg
        aux = {"ce": ce, "ber": ber, "log_ber": log_ber, "conf": conf,
               "total_loss": loss}
        return loss, aux

    def _loss_fn(self, params: dict, bits: torch.Tensor, rx_in: torch.Tensor,
                 h_freq: torch.Tensor | None = None,
                 snr_db: torch.Tensor | None = None):
        """(CE + 1e-3 L2, metrics with `snr_mse` and `chan_mse` where their
        inputs are given)."""
        ce, conf, more = self._rank_terms(params, bits, rx_in, h_freq, snr_db)
        loss, aux = self._global_terms(params, ce, conf)
        aux.update(more)
        return loss, aux

    # -- the step with the SNR curriculum --------------------------------------
    def _curriculum_data(self, generator: torch.Generator,
                        snr_db: torch.Tensor):
        """(bits, rx_in, h_freq, noise_power) of one curriculum batch from
        the data plane that `fused_curriculum` selects."""
        b, spec = self.batch_frames, self._fused_synth_spec
        if spec is not None and self.fused_curriculum:
            bits, rx_in, noise_pwr, h_freq = fused_synthesize(
                spec, b, generator, snr_db, want_h=True)
        else:
            bits, rx_in, h_freq, noise_pwr, _ = self.synthesize(
                b, snr_db, generator)
        return bits, rx_in, h_freq, noise_pwr

    def train_step_curriculum(self, state: TrainState,
                              generator: torch.Generator,
                              snr_db: torch.Tensor | None = None):
        """One step on `batch_frames` frames at curriculum SNRs (drawn from
        `generator` unless given); returns (state, aux).  On a mesh, a
        data-parallel step (`Trainer._mesh_step`) on the plain data plane."""
        if snr_db is None:
            snr_db = sample_snr(generator, self.batch_frames,
                                self._snr_offset, tail=self.tc.curriculum_tail)
        if self.mesh is not None:
            if self.fused_curriculum:
                raise ValueError("a mesh step takes the plain data plane "
                                 "(equalizer_loop.py:159-160)")
            bits, rx_in, h_freq, noise_pwr = self._synth_mesh(
                generator, snr_db, want_h=True)
            snrs = torch.chunk(snr_db, self.mesh.shape["dp"])
            extras = [{"h_freq": h, "snr_db": snrs[r].to(h.device)}
                      for h, r in zip(h_freq, self.mesh.local_rows)]
            return self._mesh_step(state, bits, rx_in, extras, noise_pwr)
        bits, rx_in, h_freq, noise_pwr = self._curriculum_data(generator,
                                                               snr_db)
        params = dict(state.params)
        train = [params[k].detach().requires_grad_() for k in self._trainable]
        params.update(zip(self._trainable, train))
        loss, aux = self._loss_fn(params, bits, rx_in, h_freq, snr_db)
        grads = dict(zip(self._trainable, torch.autograd.grad(loss, train)))
        aux = {k: v.detach() for k, v in aux.items()}
        aux.update(loss=loss.detach(), noise_power=noise_pwr)
        return self._apply(state, grads), aux

    def _apply(self, state: TrainState, grads: dict) -> TrainState:
        """Adam on the trainable keys only (`Trainer.train_step` hands in
        every key's gradient); the frozen keys keep their tensors."""
        return super()._apply(state, {k: grads[k] for k in self._trainable})

    def fit(self, seed: int | None = None, max_epochs: int | None = None,
            log_fn=print, init_state: TrainState | None = None,
            ckpt_dir: str | None = None, ckpt_every: int = 50):
        """Epochs of `train_step_curriculum`, an `eval_step` of 1024 frames
        at curriculum SNRs after each, best-params tracking and early stop
        (`equalizer_loop.py:192-236`).  `init_state` warm-starts;
        `ckpt_dir` makes the run resumable (see `Trainer.fit`)."""
        with deterministic_cudnn():
            return self._fit_curriculum(seed, max_epochs, log_fn, init_state,
                                        ckpt_dir, ckpt_every)

    def _fit_curriculum(self, seed, max_epochs, log_fn, init_state, ckpt_dir,
                        ckpt_every):
        tc = self.tc
        log_fn = self._main_log(log_fn)
        seed = tc.seed if seed is None else seed
        max_epochs = tc.max_epoch_num if max_epochs is None else max_epochs
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if init_state is not None:
            self._set_trainable(init_state.params)
            state = init_state
        else:
            state = self.init_state(gen)
        steps = max(1, tc.frames_per_epoch(self.cfg.nsymbol)
                    // self.batch_frames)
        state, start, best_loss, best_epoch, best_params, resumed = \
            self._maybe_resume(ckpt_dir, state, gen)
        if resumed:
            log_fn(f"resumed from {ckpt_dir}/resume at epoch {start}")
        history = []
        for epoch in range(start, max_epochs):
            losses = []
            for _ in range(steps):
                state, aux = self.train_step_curriculum(state, gen)
                losses.append(aux["ce"])
            val = self.eval_step(state.params, gen, 1024, sample_snr(
                gen, 1024, self._snr_offset, tail=tc.curriculum_tail))
            # the decisions' numbers: process 0's in every process
            epoch_loss, val_ber = pd.agree(
                [torch.stack(losses).mean(), val["ber"]], self.device)
            history.append({"epoch": epoch, "train_loss": epoch_loss,
                            "val_ber": val_ber})
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
