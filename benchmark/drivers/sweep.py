"""Serving cells: the interleaved BER sweep's batch, `eval.sweep.eval_batch`,
called by one closed-loop caller that reads each call's error counts on
the host before it sends the next.

Every call evaluates `frames_per_point` frames at each of the traffic's SNR
points, interleaved through the batch as `ber_sweep` lays them out
(`interleaved_groups`), on fresh bits and unit noise that the benchmark
draws on the card from the call's own seed and hands the program
(`bits=`, `unit_noise=`).  Set-up loads the receiver's weights (the
configuration's committed arm, read with `train/checkpoint.py`) and warms
the call's shapes with two calls.  `sweep_frames_per_s` is the frames of
every call over the window's wall time; `sweep_batch_ms_p95` the 95th
percentile of the calls' times from the call to its counts on the host.

After the window, a sample of the calls drawn from the seed is evaluated
again by the reference in float32 on the same draws: the run is correct
where every sampled call's per-point cross entropy and bit-error counts
agree within the cell's limits.
"""
from __future__ import annotations

import os
import random
import time

import numpy as np

from benchmark import faults, harness


def _draws(torch, seed: int, i: int, b: int, frame: int, shape, device):
    """Call i's bits [B, frame, 1] int32 and unit normals [B, S, sps, 2]."""
    g = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, f"call{i}"))
    bits = torch.randint(0, 2, (b, frame, 1), dtype=torch.int32,
                         generator=g, device=device)
    return bits, torch.randn(shape, generator=g, device=device)


def reference_params(cfg: dict, device):
    """The arm's weights read from its npz as the reference keys them."""
    import torch
    out = {}
    with np.load(os.path.join(harness.ROOT, cfg["arm"])) as z:
        for key in z.files:
            *scope, leaf = key.split("/")
            name = ".".join(s for s in scope if s != "params")
            v = torch.from_numpy(np.asarray(z[key], np.float32))
            if leaf == "kernel":
                out[f"{name}.weight"] = v.T.contiguous()
            else:
                out[f"{name}.{leaf}"] = v
    return {k: v.to(device) for k, v in out.items()}


def readings(prog: list, ref: list) -> dict:
    """prog, ref: per sampled call (errors [P], ce [P]) as numpy arrays."""
    ce_gap = max(float(np.max(np.abs(pc - rc) / rc))
                 for (_, pc), (_, rc) in zip(prog, ref))
    err_gap = max(float(np.abs(pe - re).sum() / max(re.sum(), 1))
                  for (pe, _), (re, _) in zip(prog, ref))
    return {"ce_gap": ce_gap, "err_gap": err_gap}


def run(cell, seed: int, seconds: float, trace, device, t_start: float,
        mode: str = "program", fault: str | None = None) -> dict:
    with faults.planted(fault):
        return _run(cell, seed, seconds, trace, device, t_start, mode)


def _run(cell, seed, seconds, trace, device, t_start, mode):
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval import sweep
    from dl_ofdm_tpu_torch.train import checkpoint as ckpt
    from dl_ofdm_tpu_torch.train.loop import Trainer

    cfg, tr = cell.config, cell.traffic
    ofdm = OFDMConfig(**cfg["ofdm"])
    snrs = tr["snr_db"]
    per_point = tr["frames_per_point"]
    trainer = Trainer(ofdm, TrainConfig(), channel="AWGN", device=device)
    plan = trainer.plan
    snr_vec, onehot = sweep.interleaved_groups(snrs, per_point * len(snrs),
                                               device)
    b = snr_vec.shape[0]
    if b != per_point * len(snrs):
        raise ValueError(f"{b} frames a call, not {per_point * len(snrs)}")
    shape = (b, plan.nsymbol, plan.samples_per_symbol, 2)
    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, "channel"))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def call(i):
        bits, unit = _draws(torch, seed, i, b, plan.frame_size, shape,
                            device)
        t = time.perf_counter()
        with trace.span("eval_batch"):
            errors, ce = sweep.eval_batch(trainer, snr_vec, onehot, gen,
                                          bits=bits, unit_noise=unit)
        with trace.span("host_read"):
            out = (errors.cpu().numpy(), ce.cpu().numpy())
        return out, time.perf_counter() - t

    results, times, marks = [], [], []
    if mode == "program":
        params = ckpt.params_from_flax(ckpt.load_params_npz(
            os.path.join(harness.ROOT, cfg["arm"])))
        trainer.model.load_state_dict(params)
        del params
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
    n = len(results) if mode == "program" else tr["check_calls"]
    sample = sorted(random.Random(harness.sub_seed(seed, "sample")).sample(
        range(n), min(n, tr["check_calls"])))
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    params = reference_params(cfg, device)
    groups = onehot.argmax(1)
    ref = [_reference_call(torch, params, seed, i, b, plan, shape, snr_vec,
                           groups, len(snrs), ofdm, device, "float32")
           for i in sample]
    if mode == "control":
        prog = [_reference_call(torch, params, seed, i, b, plan, shape,
                                snr_vec, groups, len(snrs), ofdm, device,
                                "fp8") for i in sample]
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


def _reference_call(torch, params, seed, i, b, plan, shape, snr_vec, groups,
                    n_groups, ofdm, device, precision):
    from benchmark.reference import dccn, link
    bits, unit = _draws(torch, seed, i, b, plan.frame_size, shape, device)
    x = link.awgn_batch(bits[..., 0], unit, snr_vec, groups, ofdm.nfft)
    errors, ce = dccn.eval_counts(params, x, bits, groups, n_groups,
                                  ofdm.nbits, precision)
    return errors.cpu().numpy(), ce.cpu().numpy()
