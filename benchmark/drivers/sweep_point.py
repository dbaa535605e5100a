"""Serving cells under the point_batch protocol: `eval.sweep.eval_batch` with
every frame of a call at one SNR point and in one normalization group, so
that the moments are taken over the whole call, as
`ber_sweep(point_batch=True)` and the reference code's
`ofdmreceiver_np_mp.py:89` take them; one closed-loop caller reads each
call's counts on the host before it sends the next.

The calls walk the traffic's SNR points in `ber_sweep`'s order:
`calls_per_point` calls at the first point, as many at the next, and so on
to the last, then again from the first.  Each call is `frames_per_call`
frames on fresh bits [B, frame_size, nbits] and unit noise that the
benchmark draws on the card from the call's own seed and hands the program
(`bits=`, `unit_noise=`).  Set-up loads the configuration's committed arm
with the port's loader (`train/checkpoint.py`), checks its parameter count
against the configuration's, and warms the call's shapes with two calls.
`sweep_frames_per_s` is the frames of every call over the window's wall
time; `sweep_batch_ms_p95` the 95th percentile of the calls' times from the
call to its counts on the host.

After the window, one call at each of `check_calls` SNR points that the
window reached (all of them, where it walked them once), drawn from the
seed, is evaluated again by the reference on the same draws
(`reference/qam.py`: the Gray map, the link in float64, the DCCN of
`reference/dccn.py` in float32 with TF32 off, its weights read by
`sweep.reference_params`).  The run is correct where each sampled call's
cross entropy agrees within `ce_gap`, and the bit errors of the sampled
calls together within `err_gap`: pooled, because from 21 dB the committed
curve reads no error in 20,000 frames, and a call's own ratio there would
read 1 for one bit that rounding flips.

The control is the reference in TF32, the precision below the
configuration's float32 with TF32 off.  Faults planted under the timed
path (`calibrate.py --fault`; the CPU tests plant each under a whole run):
`half_batch` (`benchmark/faults.py`: a call on half of its frames, its
counts doubled) and this module's `bit_order` (the predictions' bit axis
reversed where `eval_batch` compares them with the bits: a bit-order or
Gray-labelling fault, which no BPSK cell can see).  `faults.py`'s `altered`
swaps a call's first two points, and a point_batch call has one point: it
does not apply here.
"""
from __future__ import annotations

import contextlib
import os
import random
import time

import numpy as np

from benchmark import faults, harness
from benchmark.drivers.sweep import reference_params

FAULTS = ("half_batch", "bit_order")


@contextlib.contextmanager
def planted(name: str | None):
    """One of `FAULTS` planted in the port for the block, or nothing."""
    if name not in (None, *FAULTS):
        raise ValueError(f"fault {name!r}; one of {FAULTS}")
    if name != "bit_order":
        with faults.planted(name):
            yield
        return
    from dl_ofdm_tpu_torch.train import metrics
    predict = metrics.bit_predictions
    metrics.bit_predictions = lambda logits: predict(logits).flip(-1)
    try:
        yield
    finally:
        metrics.bit_predictions = predict


def _draws(torch, seed: int, i: int, b: int, frame: int, nbits: int, shape,
           device):
    """Call i's bits [B, frame, nbits] int32 and unit normals
    [B, S, sps, 2]."""
    g = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, f"call{i}"))
    bits = torch.randint(0, 2, (b, frame, nbits), dtype=torch.int32,
                         generator=g, device=device)
    return bits, torch.randn(shape, generator=g, device=device)


def point_of(i: int, tr: dict) -> int:
    """The SNR point (its index in `snr_db`) of call i."""
    return (i // tr["calls_per_point"]) % len(tr["snr_db"])


def sample_calls(seed: int, n: int, tr: dict) -> list[int]:
    """One call at each of `check_calls` points that the first n calls
    reached, points and calls drawn from the seed."""
    rng = random.Random(harness.sub_seed(seed, "sample"))
    by_point: dict = {}
    for i in range(n):
        by_point.setdefault(point_of(i, tr), []).append(i)
    points = sorted(rng.sample(sorted(by_point),
                               min(len(by_point), tr["check_calls"])))
    return sorted(rng.choice(by_point[p]) for p in points)


def readings(prog: list, ref: list) -> dict:
    """prog, ref: per sampled call (errors [1], ce [1]) as numpy arrays."""
    ce_gap = max(float(np.max(np.abs(pc - rc) / rc))
                 for (_, pc), (_, rc) in zip(prog, ref))
    err = sum(float(np.abs(pe - re).sum()) for (pe, _), (re, _)
              in zip(prog, ref))
    return {"ce_gap": ce_gap,
            "err_gap": err / max(sum(float(re.sum()) for re, _ in ref), 1.0)}


def run(cell, seed: int, seconds: float, trace, device, t_start: float,
        mode: str = "program", fault: str | None = None) -> dict:
    with planted(fault):
        return _run(cell, seed, seconds, trace, device, t_start, mode)


def _run(cell, seed, seconds, trace, device, t_start, mode):
    import torch
    from benchmark.reference import qam
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval import sweep
    from dl_ofdm_tpu_torch.train import checkpoint as ckpt
    from dl_ofdm_tpu_torch.train.loop import Trainer

    cfg, tr = cell.config, cell.traffic
    ofdm = OFDMConfig(**cfg["ofdm"])
    b = tr["frames_per_call"]
    trainer = Trainer(ofdm, TrainConfig(), channel=tr["channel"],
                      device=device)
    plan = trainer.plan
    if plan.frame_size != cfg["frame_size"]:
        raise ValueError(f"{plan.frame_size} data subcarriers a frame, not "
                         f"{cfg['frame_size']}")
    shape = (b, plan.nsymbol, plan.samples_per_symbol, 2)
    snr_vecs = [torch.full((b,), float(s), device=device)
                for s in tr["snr_db"]]
    one_group = torch.ones(b, 1, device=device)
    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, "channel"))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def call(i):
        bits, unit = _draws(torch, seed, i, b, plan.frame_size, ofdm.nbits,
                            shape, device)
        t = time.perf_counter()
        with trace.span("eval_batch"):
            errors, ce = sweep.eval_batch(
                trainer, snr_vecs[point_of(i, tr)], one_group, gen,
                bits=bits, unit_noise=unit)
        with trace.span("host_read"):
            out = (errors.cpu().numpy(), ce.cpu().numpy())
        return out, time.perf_counter() - t

    results, times, marks = [], [], []
    if mode == "program":
        trainer.model.load_state_dict(ckpt.params_from_flax(
            ckpt.load_params_npz(os.path.join(harness.ROOT, cfg["arm"]))))
        n_params = sum(p.numel() for p in trainer.model.parameters())
        if n_params != cfg["parameters"]:
            raise ValueError(f"the arm holds {n_params} parameters, not "
                             f"{cfg['parameters']}")
        for i in range(2):                 # warm-up calls: the call's shapes
            call(-1 - i)
        sync()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        limit = min(seconds, tr["trace_seconds"]) if trace.enabled \
            else seconds
        with trace.window(sync):
            t0 = time.perf_counter()
            while True:
                res, dt = call(len(results))
                results.append(res)
                times.append(dt)
                marks.append((time.perf_counter() - t0, len(results)))
                if marks[-1][0] >= limit:
                    break
            t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
    n = len(results) if mode == "program" else \
        tr["calls_per_point"] * len(tr["snr_db"])
    sample = sample_calls(seed, n, tr)
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    params = reference_params(cfg, device)

    def reference(i, precision):
        bits, unit = _draws(torch, seed, i, b, plan.frame_size, ofdm.nbits,
                            shape, device)
        x = qam.awgn_call(bits, unit, tr["snr_db"][point_of(i, tr)],
                          ofdm.nfft)
        errors, ce = qam.counts(params, x, bits, ofdm.nbits, precision)
        return errors.cpu().numpy(), ce.cpu().numpy()

    ref = [reference(i, "float32") for i in sample]
    if mode == "control":
        prog = [reference(i, "tf32") for i in sample]
        return {"attempted": 0, "failed": 0, "e2e": {}, "peak_bytes": 0,
                "readings": readings(prog, ref),
                "reference_s": time.perf_counter() - t}
    prog = [results[i] for i in sample]
    failed = sum(not (np.all(np.isfinite(c)) and np.all(e >= 0))
                 for e, c in results)
    bits_per_call = b * plan.frame_size * ofdm.nbits
    return {"calls": len(results), "attempted": len(results),
            "failed": failed, "peak_bytes": peak, "window_s": t1 - t0,
            "calls_per_s": harness.per_second(marks),
            "e2e": {"sweep_frames_per_s": len(results) * b / (t1 - t0),
                    "sweep_batch_ms_p95": 1e3 * float(np.quantile(
                        times, 0.95, method="linear")),
                    "setup_s": setup_s},
            "layer": {"calls": len(results), "frames": len(results) * b,
                      "frames_per_call": b, "chips": 1,
                      "ofdm": cfg["ofdm"], "sps": plan.samples_per_symbol,
                      "frame_size": plan.frame_size},
            "readings": readings(prog, ref),
            "reference_s": time.perf_counter() - t,
            "ber": float(sum(e.sum() for e, _ in results)
                         / (bits_per_call * len(results)))}
