"""Observability: constellation dumps, throughput counters, profiler traces
and the program's spans.

Port of `dl_ofdm_tpu/utils/observability.py` (the reference's surface,
SURVEY.md section 5.5: fp16 constellation CSV dumps `<token>_txiq.csv` /
`<token>_rxiq.csv`, `dev/py/ofdmreceiver_np.py:151-152,264-265`).
`Throughput` counts samples/s per stage, fenced on a CUDA event
(`utils.timing.fence`); `profile_trace` wraps `torch.profiler` in place
of `jax.profiler`, and its traces carry the spans below.

`span(name)` marks a stretch of the host's work as `ofdm.<name>` in a
profiler's trace, on the clock of the card's kernels there, so that a gap
on the card can be put down to what the host was doing.  The names are
`<layer>.<part>`, one level a layer, and no span of one layer holds a span
of another on the single-card and data-parallel paths of
`Trainer.train_step`, `EqualizerTrainer.train_step_curriculum`,
`eval_step`, `eval.sweep.eval_batch` and both `fit`s (a layer's spans may
nest: `gather_rows` calls `exchange`; a tp row's exchanges run inside its
model and eq spans; `eval_batch` of an equalized receiver holds its eq
spans inside its model span):

  data    `tx` (bit draw, modulation), `channel`, `awgn`, `norm`
          (`Trainer.synthesize`); `fused_synth` (the fused synthesize
          kernel and its moments); `snr` (the equalizer stage's
          curriculum SNRs, `train.curriculum.sample_snr`)
  eq      the equalizer in front of the receiver (`models/equalizers.py`,
          every registry id but the legacy 13): `front` (layer norm,
          `Dense_in`, the learned DFT), `chest` (pilots, interpolation,
          the refinement blocks' dense layers and block convolutions),
          `equalize` (the division by the estimate, the power feature,
          back to time, `Dense_out`, the SNR estimate)
  model   `forward` (the receiver, its CE and counts; `eval_batch`'s
          error and CE sums), `backward` (each `torch.autograd.grad`),
          `fused_grads` (the fused DCCN gradient kernel)
  optim   `loss_terms` (BER from the counts, the L2 term and its
          gradient), `adam` (Adam and the parameter update)
  comm    `gather_rows`, `exchange` (`parallel/mesh.py`), `broadcast`,
          `agree` (`parallel/distributed.py`: the collectives and the
          host read)
  fit     `epoch_end` (`fit` after the epoch's agreed read: batch growth,
          constellation dump, log line, resume payload)

A span carries no request or step identifier: the program is one thread
and one closed-loop caller, so a step's spans are those inside its
caller's own span or its `fit` epoch.  No profiler recording, no cost but
one flag read: `span` then returns one shared null context.  A profiler
turns them on (`profile_trace`, any `torch.profiler.profile`); there is no
other switch.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from dl_ofdm_tpu_torch.utils.timing import fence

_OFF = contextlib.nullcontext()


def span(name: str):
    """`torch.profiler.record_function("ofdm." + name)` while a profiler
    records, else the shared null context (`record_function` itself costs
    microseconds with the profiler off)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function("ofdm." + name)


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
    Perfetto or chrome://tracing), the program's `ofdm.*` spans among its
    events.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
