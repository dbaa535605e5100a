"""Serving cells on a fading channel: the interleaved BER sweep's batch,
`eval.sweep.eval_batch`, on a static tap profile, called by one closed-loop
caller that reads each call's error counts on the host before it sends the
next.

As `sweep.py`, with the channel's tap gains drawn too: every call evaluates
`frames_per_point` frames at each of the traffic's SNR points, interleaved
through the batch as `ber_sweep` lays them out (`interleaved_groups`), on
fresh bits and unit noise that the benchmark draws on the card from the
call's own seed and hands the program (`bits=`, `unit_noise=`), and on tap
gains that the program's channel draws from a generator the benchmark
seeds for the call.  Set-up loads the receiver's weights (the traffic's
committed arm) and warms the call's shapes with two calls.
`sweep_frames_per_s` is the frames of every call over the window's wall
time; `sweep_batch_ms_p95` the 95th percentile of the calls' times from
the call to its counts on the host.

After the window, a sample of the calls drawn from the seed is evaluated
again by the reference in float32 on the same draws (the tap gains drawn
as the program's channel draws them, from the same generator; the fading
by `link.fade`): the run is correct where every sampled call's per-point
cross entropy and bit-error counts agree within the cell's limits.
"""
from __future__ import annotations

import math
import os
import random
import time

import numpy as np

from benchmark import faults, harness
from benchmark.drivers import sweep


def _taps_generator(torch, seed: int, i: int, device):
    return torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, f"taps{i}"))


def run(cell, seed: int, seconds: float, trace, device, t_start: float,
        mode: str = "program", fault: str | None = None) -> dict:
    with faults.planted(fault):
        return _run(cell, seed, seconds, trace, device, t_start, mode)


def _run(cell, seed, seconds, trace, device, t_start, mode):
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval import sweep as port_sweep
    from dl_ofdm_tpu_torch.train import checkpoint as ckpt
    from dl_ofdm_tpu_torch.train.loop import Trainer

    cfg, tr = cell.config, cell.traffic
    ofdm = OFDMConfig(**cfg["ofdm"])
    snrs = tr["snr_db"]
    per_point = tr["frames_per_point"]
    trainer = Trainer(ofdm, TrainConfig(), channel=tr["channel"],
                      device=device)
    plan = trainer.plan
    snr_vec, onehot = port_sweep.interleaved_groups(
        snrs, per_point * len(snrs), device)
    b = snr_vec.shape[0]
    if b != per_point * len(snrs):
        raise ValueError(f"{b} frames a call, not {per_point * len(snrs)}")
    shape = (b, plan.nsymbol, plan.samples_per_symbol, 2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def call(i):
        bits, unit = sweep._draws(torch, seed, i, b, plan.frame_size, shape,
                                  device)
        t = time.perf_counter()
        with trace.span("eval_batch"):
            errors, ce = port_sweep.eval_batch(
                trainer, snr_vec, onehot, _taps_generator(torch, seed, i,
                                                          device),
                bits=bits, unit_noise=unit)
        with trace.span("host_read"):
            out = (errors.cpu().numpy(), ce.cpu().numpy())
        return out, time.perf_counter() - t

    results, times, marks = [], [], []
    if mode == "program":
        params = ckpt.params_from_flax(ckpt.load_params_npz(
            os.path.join(harness.ROOT, tr["arm"])))
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
    params = sweep.reference_params(tr, device)
    groups = onehot.argmax(1)

    def reference(i, precision):
        return _reference_call(torch, params, seed, i, b, plan, shape,
                               snr_vec, groups, len(snrs), ofdm,
                               tr["channel"], device, precision)

    ref = [reference(i, "float32") for i in sample]
    if mode == "control":
        prog = [reference(i, "fp8") for i in sample]
        return {"attempted": 0, "failed": 0, "e2e": {}, "peak_bytes": 0,
                "readings": sweep.readings(prog, ref),
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
            "readings": sweep.readings(prog, ref),
            "reference_s": time.perf_counter() - t,
            "ber": float(sum(e.sum() for e, _ in results)
                         / (bits_per_call * len(results)))}


def _reference_call(torch, params, seed, i, b, plan, shape, snr_vec, groups,
                    n_groups, ofdm, channel, device, precision):
    """Call i's counts by the reference: the transmitter, the profile's
    fading with the tap gains the program's channel draws (CN(0, 1): a
    [B, taps, 2] standard normal over sqrt 2), the signal scaled to unit
    mean power over the call, the noise, the per-group normalization."""
    from benchmark.reference import dccn, link
    bits, unit = sweep._draws(torch, seed, i, b, plan.frame_size, shape,
                              device)
    n_taps = len(link.PROFILES[channel][0])
    z = torch.randn(b, n_taps, 2, device=device, generator=_taps_generator(
        torch, seed, i, device)).to(link.F64) / math.sqrt(2.0)
    p = link.plan(ofdm.nfft)
    x = link.fade(link.transmit(bits[..., 0], p).reshape(b, -1),
                  torch.complex(z[..., 0], z[..., 1]), channel, ofdm.nfft)
    x = x.reshape(b, p.nsymbol, p.sps)
    noise = torch.view_as_complex(unit.to(link.F64).contiguous())
    y = x / torch.sqrt((x.abs() ** 2).mean()) \
        + noise * link.noise_std(snr_vec)[:, None, None]
    errors, ce = dccn.eval_counts(params, link.normalize(y, groups), bits,
                                  groups, n_groups, ofdm.nbits, precision)
    return errors.cpu().numpy(), ce.cpu().numpy()
