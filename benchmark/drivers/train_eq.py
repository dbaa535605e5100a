"""Training cells of the equalizer stage on one card:
`EqualizerTrainer.train_step_curriculum` in epochs as `EqualizerTrainer.fit`
runs them, a closed loop in one process, inside `deterministic_cudnn()`.

Set-up builds one `EqualizerTrainer` and its state from weights the
benchmark supplies: the equalizer's drawn from the seed (`draw_equalizer`,
flax's initializers), the frozen receiver's from the configuration's
committed arm, read for the program with the port's loader
(`train/checkpoint.py`) and for the reference with the benchmark's own
(`sweep.reference_params`), so that neither the port's initializer nor its
loader is shared by the two sides.  It then takes the first three steps with
the window's own call (per-frame SNRs from the curriculum, frames from the
program's plain data plane, recorded here for the check) and one epoch end
(`eval_step` on the eval frames at curriculum SNRs and the host read of
`parallel.distributed.agree`), which warms every shape the window uses.
The window continues from that state: epochs of `steps` curriculum steps
(`msg_length / nsymbol` frames an epoch, at least one step), each ended by
an `eval_step` and the host read, until `seconds` have passed at an
epoch's end.  `train_iq_per_s` is every trained frame's IQ samples over
the window's wall time, which ends on the last host read.  The trainer's
step counter (`EqualizerTrainer.curriculum_steps`) has to advance once a
step of the window.

After the window the reference (`benchmark/reference/equalizer.py`)
repeats the first three steps from the same weights, in float32, on the
batches the program's data plane produced in them (bits and receiver
input; the mixRayleigh Jakes-Doppler channel is not derived again), and
the run is correct where each step's loss, the equalizer's first gradient
(Adam's first moment after one step over 1 - b1) and its change over the
three steps agree by their norms, leaf by leaf, within the cell's limits,
and no leaf of the frozen receiver differs in a bit from the arm, as the
benchmark reads it, after the window (`frozen_moved`, the count of those
that do).

Faults planted under the timed path (`calibrate.py --fault`; the CPU tests
plant each under a whole run): `unchanged` (a step returns its state
unchanged), `half_batch` (`_rank_terms` on half of the batch) and
`tf32_conv` (the equalizer's block convolution in TF32, forward and
backward).
"""
from __future__ import annotations

import contextlib
import math
import os
import time

from benchmark import harness
from benchmark.drivers import sweep
from benchmark.drivers.train import B1, CHECK_STEPS, readings as step_readings

FAULTS = ("unchanged", "half_batch", "tf32_conv")


@contextlib.contextmanager
def planted(name: str | None):
    """One of `FAULTS` planted in the port for the block, or nothing."""
    if name is None:
        yield
        return
    import torch
    from dl_ofdm_tpu_torch.ops import complex_ops
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    patches = []

    def patch(obj, attr, new):
        patches.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if name == "unchanged":
        step = EqualizerTrainer.train_step_curriculum

        def unchanged(self, state, *a, **k):
            return state, step(self, state, *a, **k)[1]
        patch(EqualizerTrainer, "train_step_curriculum", unchanged)
    elif name == "half_batch":
        terms = EqualizerTrainer._rank_terms

        def half(self, params, bits, rx_in, h_freq=None, snr_db=None,
                 model=None, tp=None):
            h = bits.shape[0] // 2
            return terms(self, params, bits[:h], rx_in[:h],
                         None if h_freq is None else h_freq[:h],
                         None if snr_db is None else snr_db[:h], model, tp)
        patch(EqualizerTrainer, "_rank_terms", half)
    elif name == "tf32_conv":
        # the port's convolution with its guard taken out, TF32 on
        patch(complex_ops, "_cudnn_without_tf32", contextlib.nullcontext)
        patch(torch.backends.cudnn, "allow_tf32", True)
    else:
        raise ValueError(f"fault {name!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for obj, attr, old in reversed(patches):
            setattr(obj, attr, old)


def draw_equalizer(shapes: dict, seed: int, device):
    """The equalizer's parameters of `shapes` from `seed`, on `device` in
    one draw, as flax's `Dense` starts them and the fine-tuning stage
    starts from them: each weight flax's lecun_normal (a normal truncated
    at 2 std, every value beyond redrawn, scaled to variance 1 / fan-in),
    each bias zero.  The fan-in is a dense weight's input width
    ([out, in]) and a complex leaf's every axis but the last (a complex
    dense layer's [K, F], the convolution's HWIO [S, K, 1, 1]).

    Not `harness.draw_weights`' clipped normal: its 1.19x variance and its
    mass at 2 std gave the three steps' change a tail twice as long
    against the reference (`PERF.md` §6)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    while True:
        beyond = flat.abs() > 2
        n = int(beyond.sum())
        if not n:
            break
        flat[beyond] = torch.randn(n, generator=gen, device=device)
    out, i = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bias", "br", "bi"):
            std = 0.0
        else:
            fan_in = s[1] if leaf == "weight" else n // s[-1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566
        out[k] = (flat[i:i + n] * std).reshape(s).contiguous()
        i += n
    return out


def pilot_comb(nfft: int) -> list[int]:
    """The first pilot symbol's subcarriers, where the SNR estimate looks."""
    from benchmark.reference import link
    sc = link.plan(nfft).pilot_sc
    return [int(c) for c in sc[sc < nfft]]


def reference_run(cell, w0, batches, device, precision):
    """The reference's steps from `w0` on the recorded (bits, input)
    batches."""
    import torch
    from benchmark.reference import equalizer
    o = cell.config["ofdm"]
    out = equalizer.train_steps(
        w0, ((x, bits.reshape(bits.shape[0], -1)) for bits, x in batches),
        pilot_comb(o["nfft"]), o["nbits"], cell.config["train"], precision)
    out["change"] = {k: out["params"][k] - w0[k].float()
                     for k in out["params"]}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell, seed: int, seconds: float, trace, device, t_start: float,
        mode: str = "program", fault: str | None = None) -> dict:
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    from dl_ofdm_tpu_torch.train.loop import deterministic_cudnn
    if not hasattr(EqualizerTrainer, "curriculum_steps"):
        raise SystemExit(f"{cell.name}: this port's EqualizerTrainer counts "
                         "no steps (curriculum_steps); the cell needs it")
    with planted(fault), deterministic_cudnn():
        return _run(cell, seed, seconds, trace, device, t_start, mode)


def _run(cell, seed, seconds, trace, device, t_start, mode):
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.parallel import distributed as pd
    from dl_ofdm_tpu_torch.train import checkpoint as ckpt
    from dl_ofdm_tpu_torch.train.curriculum import sample_snr
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    from dl_ofdm_tpu_torch.train.loop import TrainState

    cfg, tr = cell.config, cell.traffic
    frames, ef = tr["frames_per_step"], tr["eval_frames"]
    ofdm = OFDMConfig(**cfg["ofdm"])
    tc = TrainConfig(batch_size=frames * ofdm.nsymbol, **cfg["train"])
    rx = ckpt.params_from_flax(ckpt.load_params_npz(
        os.path.join(harness.ROOT, cfg["arm"])))
    trainer = EqualizerTrainer(ofdm, tc, channel=tr["channel"],
                               mobile=tr["mobile"], device=device)
    if trainer.batch_frames != frames:
        raise ValueError(f"{trainer.batch_frames} frames a step, not "
                         f"{frames}")
    if trainer._eq_reg_coeff != cfg["eq_l2_coeff"]:
        raise ValueError(f"the equalizer's L2 coefficient is "
                         f"{trainer._eq_reg_coeff}, not {cfg['eq_l2_coeff']}")
    trainer.fused_curriculum = tr["fused_curriculum"]
    shapes = {k: tuple(v.shape)
              for k, v in trainer.model.state_dict().items()}
    eq = draw_equalizer({k: s for k, s in shapes.items()
                         if k.startswith("Equalizer.")},
                        harness.sub_seed(seed, "weights"), device)
    arm = sweep.reference_params(cfg, device)
    rx_keys = [k[len("receiver."):] for k in shapes if k not in eq]
    if sorted(rx_keys) != sorted(arm) or sorted(rx) != sorted(arm):
        raise ValueError("the arm's leaves are not the receiver's")
    # the reference's starting point, and the program's from the port's
    # loader: a leaf the loader reads wrongly shows in frozen_moved
    w0 = {k: eq[k] if k in eq else arm[k[len("receiver."):]] for k in shapes}
    params = {k: eq[k].clone() if k in eq
              else rx[k[len("receiver."):]].to(device) for k in shapes}
    trainer._set_trainable(params)
    keys = trainer._trainable
    if sorted(keys) != sorted(eq):
        raise ValueError("the trainable leaves are not the equalizer's")
    state = TrainState(params, trainer.optimizer.init(
        {k: params[k] for k in keys}), 0)
    n_params = sum(math.prod(s) for s in shapes.values())
    if n_params != cfg["parameters"] or sum(
            w0[k].numel() for k in keys) != cfg["trainable"]:
        raise ValueError("the model's parameters are not the "
                         "configuration's")
    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, "data"))
    spe = max(1, tc.frames_per_epoch(ofdm.nsymbol) // frames)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def curriculum_snr(n):
        return sample_snr(gen, n, trainer._snr_offset,
                          tail=tc.curriculum_tail)

    batches = []
    data = trainer._curriculum_data

    def recorded(generator, snr_db):
        out = data(generator, snr_db)
        batches.append((out[0], out[1]))
        return out

    if mode == "control":
        for _ in range(CHECK_STEPS):
            recorded(gen, curriculum_snr(frames))
        del trainer
        prog = reference_run(cell, w0, batches, device, "fp8")
        out = {"steps": 0, "attempted": 0, "failed": 0, "e2e": {},
               "peak_bytes": 0}
        return _checked(cell, out, prog, w0, batches, device, 0)

    trainer._curriculum_data = recorded
    losses, mu1 = [], None
    for i in range(CHECK_STEPS):
        state, aux = trainer.train_step_curriculum(state, gen)
        losses.append(aux["loss"])
        if i == 0:
            mu1 = state.opt_state["mu"]
    del trainer._curriculum_data
    params3 = state.params

    def epoch_end(state, ep_ce):
        with trace.span("eval_step"):
            val = trainer.eval_step(state.params, gen, ef,
                                    curriculum_snr(ef))
        with trace.span("host_read"):
            return pd.agree([torch.stack(ep_ce).mean(), val["ber"]], device)

    epoch_end(state, [aux["ce"]])
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    limit = min(seconds, tr["trace_seconds"]) if trace.enabled else seconds
    steps = failed = 0
    marks = []
    counted = EqualizerTrainer.curriculum_steps
    with trace.window(sync):
        t0 = time.perf_counter()
        while True:
            ep = []
            for _ in range(spe):
                with trace.span("train_step"):
                    state, aux = trainer.train_step_curriculum(state, gen)
                ep.append(aux["ce"])
            vals = epoch_end(state, ep)
            steps += spe
            failed += spe * (not all(math.isfinite(v) for v in vals))
            marks.append((time.perf_counter() - t0, steps))
            if marks[-1][0] >= limit:
                break
        t1 = time.perf_counter()
    sync()
    if EqualizerTrainer.curriculum_steps - counted != steps:
        raise RuntimeError(
            f"EqualizerTrainer.curriculum_steps advanced by "
            f"{EqualizerTrainer.curriculum_steps - counted} in {steps} steps")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    frozen_moved = sum(not torch.equal(state.params[f"receiver.{k}"], v)
                       for k, v in arm.items())
    plan = trainer.plan
    prog = {"loss": [float(v) for v in losses],
            "grad1": {k: mu1[k] / (1 - B1) for k in keys},
            "change": {k: params3[k] - w0[k] for k in keys}}
    del trainer, state, aux, params3, mu1
    out = {"steps": steps, "attempted": steps, "failed": failed,
           "peak_bytes": peak, "window_s": t1 - t0,
           "steps_per_s": harness.per_second(marks),
           "e2e": {"train_iq_per_s": steps * frames * plan.nsymbol
                   * plan.samples_per_symbol / (t1 - t0),
                   "setup_s": setup_s},
           "layer": {"steps": steps, "frames": steps * frames,
                     "frames_per_step": frames, "chips": 1,
                     "n_params": n_params, "ofdm": cfg["ofdm"],
                     "cp": plan.cp_len, "pilots": plan.pilot_size,
                     "frame_size": plan.frame_size}}
    return _checked(cell, out, prog, w0, batches, device, frozen_moved)


def _checked(cell, out, prog, w0, batches, device, frozen_moved):
    t = time.perf_counter()
    ref = reference_run(cell, w0, batches, device, "float32")
    out["readings"] = {**step_readings(prog, ref),
                       "frozen_moved": float(frozen_moved)}
    out["reference_s"] = time.perf_counter() - t
    out["loss"] = {"program": prog["loss"], "reference": ref["loss"]}
    return out
