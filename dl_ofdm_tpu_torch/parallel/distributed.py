"""Multi-host initialization and the scaling-efficiency harness.

Port of `dl_ofdm_tpu/parallel/distributed.py`.  The port's mesh is one
process (`parallel/mesh.py`), so `initialize_multihost` has nothing to do
for one process and refuses more (multi-process and multi-host
`torch.distributed` are ROADMAP.md Queue A item 13).  `scaling_efficiency`
times a step at several mesh widths, with CUDA events on a card and
`time.perf_counter` on the CPU.
"""
from __future__ import annotations

import time

import torch

from dl_ofdm_tpu_torch import resolve_device

MULTIHOST_NOT_PORTED = ("multi-process and multi-host torch.distributed "
                        "are not ported yet: ROADMAP.md Queue A item 13")


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Nothing to do for one process; raises `NotImplementedError` for
    more."""
    if num_processes is not None and num_processes > 1:
        raise NotImplementedError(MULTIHOST_NOT_PORTED)


def weak_scaling_efficiency(steps_per_sec: dict[int, float]
                            ) -> dict[int, float]:
    """Weak-scaling efficiency from a {n_devices: steps/s} rate profile.

    Under weak scaling the global batch grows with n (per-device work is
    constant), so the ideal step rate is flat across widths: efficiency at
    width n is rate(n) / rate(smallest measured width)."""
    if not steps_per_sec:
        return {}
    base = steps_per_sec[min(steps_per_sec)]
    return {n: r / base for n, r in steps_per_sec.items()}


def _seconds_per_call(fn, iters: int, device: torch.device) -> float:
    """Mean seconds of one call of `fn` over `iters` calls after one
    warm-up call: CUDA events on a card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) / iters


def scaling_efficiency(make_step, make_args, device_counts=(1, 2, 4, 8),
                       iters: int = 10, log_fn=print,
                       device: str | torch.device | None = None
                       ) -> tuple[dict[int, float], dict[int, float]]:
    """Measure the step rate at several mesh widths.

    `make_step(n)` returns a step callable for an n-rank mesh and
    `make_args(n)` its inputs, with the global batch scaled by n (weak
    scaling).  `device` is where the steps run (`cuda` by default), which
    picks the clock.  Returns ({n: steps_per_sec},
    {n: weak_scaling_efficiency})."""
    device = resolve_device(device)
    results = {}
    for n in device_counts:
        step, args = make_step(n), make_args(n)
        dt = max(_seconds_per_call(lambda: step(*args), iters, device), 1e-9)
        results[n] = 1.0 / dt
        eff = weak_scaling_efficiency(results)[n]
        log_fn(f"{n} devices: {dt * 1e3:.2f} ms/step, "
               f"scaling efficiency {eff * 100:.1f}%")
    return results, weak_scaling_efficiency(results)
