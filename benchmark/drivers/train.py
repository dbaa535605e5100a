"""Training cells on one card: `Trainer.train_step` in epochs as `fit` runs
them, a closed loop in one process.

Set-up builds one `Trainer` and one `TrainState` from weights drawn from
the seed, drives the state through its first three steps with the
window's own call (each step's frames fresh from the step's seed words),
then one epoch end (`eval_step` on the eval frames and the host read of
`parallel.distributed.agree`), which warms every shape the window uses.
The window continues from that state: epochs of `steps` train steps
(`msg_length / nsymbol` frames an epoch, at least one step), each ended
by an `eval_step` and the host read, until `seconds` have passed at an
epoch's end.  `train_iq_per_s` is every trained frame's IQ samples over
the window's wall time, which ends on the last host read.

After the window the reference repeats the first three steps in float32
on the frames it draws itself from the same seed words, and the run is
correct where each step's loss, the first gradient (Adam's first moment
after one step over 1 - b1) and the parameters' change over the three
steps agree by their norms, leaf by leaf, within the cell's limits.
"""
from __future__ import annotations

import math
import time

from benchmark import faults, harness
from benchmark.work import SynthShape

B1 = 0.9
CHECK_STEPS = 3


def _seed_words(torch, gen, device, advance: bool):
    """The two seed words the synthesize kernel draws first in a step."""
    g = gen
    if not advance:
        g = torch.Generator(device=device)
        g.set_state(gen.get_state())
    return torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, generator=g,
                         device=device).tolist()


def _taps_fir(channel: str):
    from benchmark.reference.link import PROFILES
    if channel == "AWGN":
        return 0, 0
    delays, _, n_fir = PROFILES[channel]
    return len(delays), n_fir


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared: (loss, first gradient, change) of the program
    against the reference's."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                        ref["loss"]))
    gn = {k: float(v.double().norm()) for k, v in ref["grad1"].items()}
    med = sorted(gn.values())[len(gn) // 2]
    # leaves whose gradient is nought to rounding move by round-off alone
    moved = [k for k in gn if gn[k] >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": harness.norm_gap(prog["grad1"], ref["grad1"]),
            "change_gap": harness.norm_gap(prog["change"], ref["change"],
                                           moved)}


def reference_run(cell, w0, seeds, device, precision):
    """The reference's steps from `w0` on the frames of `seeds`."""
    import torch
    from benchmark.reference import dccn, link
    cfg, tr = cell.config, cell.traffic
    o = cfg["ofdm"]
    batches = ((x.float(), b) for b, x in (
        link.training_batch(s, tr["frames_per_step"], o["nfft"],
                            tr["channel"], tr["snr_db"], device)
        for s in seeds))
    out = dccn.train_steps(w0, batches, o["nbits"], cfg["train"], precision)
    out["change"] = {k: out["params"][k] - w0[k].float() for k in w0}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell, seed: int, seconds: float, trace, device, t_start: float,
        mode: str = "program", fault: str | None = None) -> dict:
    with faults.planted(fault):
        return _run(cell, seed, seconds, trace, device, t_start, mode)


def _run(cell, seed, seconds, trace, device, t_start, mode):
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.parallel import distributed as pd
    from dl_ofdm_tpu_torch.train.loop import Trainer, TrainState

    cfg, tr = cell.config, cell.traffic
    frames, ef = tr["frames_per_step"], tr["eval_frames"]
    ofdm = OFDMConfig(**cfg["ofdm"])
    tc = TrainConfig(snr=tr["snr_db"], batch_size=frames * ofdm.nsymbol,
                     **cfg["train"])
    trainer = Trainer(ofdm, tc, channel=tr["channel"], device=device)
    if trainer.batch_frames != frames:
        raise ValueError(f"{trainer.batch_frames} frames a step, not "
                         f"{frames}")
    fused = cfg["route"] == "fused"
    shapes = {k: tuple(v.shape) for k, v in trainer.model.state_dict().items()}
    w0 = harness.draw_weights(shapes, harness.sub_seed(seed, "weights"),
                              device)
    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, "data"))
    spe = max(1, tc.frames_per_epoch(ofdm.nsymbol) // frames)
    snr = torch.full((frames,), float(tr["snr_db"]), device=device)
    eval_snr = torch.full((ef,), float(tr["snr_db"]), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if mode == "control":
        seeds = [_seed_words(torch, gen, device, True)
                 for _ in range(CHECK_STEPS)]
        prog = reference_run(cell, w0, seeds, device, "fp8")
        out = {"steps": 0, "attempted": 0, "failed": 0, "e2e": {},
               "peak_bytes": 0}
        return _checked(cell, out, prog, w0, seeds, device)

    state = TrainState(dict(w0), trainer.optimizer.init(w0), 0)
    seeds, losses, mu1 = [], [], None
    for i in range(CHECK_STEPS):
        seeds.append(_seed_words(torch, gen, device, False))
        state, aux = trainer.train_step(state, gen, snr, fused=fused)
        losses.append(aux["loss"])
        if i == 0:
            mu1 = state.opt_state["mu"]
    params3 = state.params

    def epoch_end(state, aux, ep_losses):
        with trace.span("eval_step"):
            val = trainer.eval_step(state.params, gen, ef, eval_snr)
        with trace.span("host_read"):
            return pd.agree([aux["ber"], torch.stack(ep_losses).mean(),
                             val["ber"], val["ce"]], device)

    epoch_end(state, aux, [aux["ce"]])
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    limit = min(seconds, tr["trace_seconds"]) if trace.enabled else seconds
    steps = failed = 0
    marks = []
    with trace.window(sync):
        t0 = time.perf_counter()
        while True:
            ep = []
            for _ in range(spe):
                with trace.span("train_step"):
                    state, aux = trainer.train_step(state, gen, snr,
                                                    fused=fused)
                ep.append(aux["ce"])
            vals = epoch_end(state, aux, ep)
            steps += spe
            failed += spe * (not all(math.isfinite(v) for v in vals))
            marks.append((time.perf_counter() - t0, steps))
            if marks[-1][0] >= limit:
                break
        t1 = time.perf_counter()
    sync()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    iq = steps * frames * ofdm.nsymbol * trainer.plan.samples_per_symbol
    prog = {"loss": [float(v) for v in losses],
            "grad1": {k: v / (1 - B1) for k, v in mu1.items()},
            "change": {k: params3[k] - w0[k] for k in w0}}
    plan = trainer.plan
    n_params = sum(math.prod(s) for s in shapes.values())
    del trainer, state, aux, params3, mu1
    out = {"steps": steps, "attempted": steps, "failed": failed,
           "peak_bytes": peak, "window_s": t1 - t0,
           "steps_per_s": harness.per_second(marks),
           "e2e": {"train_iq_per_s": iq / (t1 - t0), "setup_s": setup_s},
           "layer": {"steps": steps, "frames": steps * frames,
                     "frames_per_step": frames, "chips": 1,
                     "n_params": n_params, "ofdm": cfg["ofdm"],
                     "synth": SynthShape(
                         plan.nsymbol, plan.samples_per_symbol, plan.nfft,
                         plan.frame_size, *_taps_fir(tr["channel"]))}}
    return _checked(cell, out, prog, w0, seeds, device)


def _checked(cell, out, prog, w0, seeds, device):
    t = time.perf_counter()
    ref = reference_run(cell, w0, seeds, device, "float32")
    out["readings"] = readings(prog, ref)
    out["reference_s"] = time.perf_counter() - t
    out["loss"] = {"program": prog["loss"], "reference": ref["loss"]}
    return out
