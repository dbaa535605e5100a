"""Observability: constellation dumps, throughput counters, profiler traces.

Port of `dl_ofdm_tpu/utils/observability.py` (the reference's surface,
SURVEY.md section 5.5: fp16 constellation CSV dumps `<token>_txiq.csv` /
`<token>_rxiq.csv`, `dev/py/ofdmreceiver_np.py:151-152,264-265`).
`Throughput` counts samples/s per stage, fenced on a CUDA event
(`utils.timing.fence`); `profile_trace` wraps `torch.profiler` in place
of `jax.profiler`.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from dl_ofdm_tpu_torch.utils.timing import fence


def dump_constellation(token: str, tx_iq, rx_iq, limit: int = 2048,
                       out_dir: str = ".", suffix: str = ""):
    """fp16 IQ sample dumps, the reference's naming `<token>[_mp]_txiq.csv`
    and the JAX package's bytes (`np.savetxt` of float16 [N, 2] pairs).
    `tx_iq` and `rx_iq` are tensors (any device) or arrays of IQ pairs."""
    paths = []
    for name, iq in (("txiq", tx_iq), ("rxiq", rx_iq)):
        if isinstance(iq, torch.Tensor):
            iq = iq.detach().float().cpu().numpy()
        arr = np.asarray(iq, dtype=np.float16).reshape(-1, 2)[:limit]
        p = os.path.join(out_dir, f"{token}{suffix}_{name}.csv")
        np.savetxt(p, arr, delimiter=",")
        paths.append(p)
    return paths


class Throughput:
    """Per-stage samples/s counter: `with tp.stage('io', n) as s:
    s.fence(out)`.

    A stage of device work hands its output to `s.fence(out)` before the
    block closes, so the time covers the device's work and not only its
    launch; a stage that never calls `fence` is recorded under
    `name + '(host)'`, so a launch rate cannot pass for device
    throughput."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.samples: dict[str, int] = {}

    class _Stage:
        __slots__ = ("fenced",)

        def __init__(self):
            self.fenced = False

        def fence(self, out) -> None:
            """Block until `out` is computed (a CUDA event waited on)."""
            fence(out)
            self.fenced = True

    @contextlib.contextmanager
    def stage(self, name: str, n_samples: int):
        s = self._Stage()
        t0 = time.perf_counter()
        yield s
        dt = time.perf_counter() - t0
        if not s.fenced:
            name = name + "(host)"
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.samples[name] = self.samples.get(name, 0) + n_samples

    def report(self) -> dict[str, float]:
        return {k: self.samples[k] / max(self.totals[k], 1e-12)
                for k in self.totals}


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """`torch.profiler` over the block (CPU, and CUDA where there is a
    device); on exit the Chrome trace is written to
    `<log_dir>/trace.json` (`<tmp>/torch-trace` by default; view it in
    Perfetto or chrome://tracing).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
