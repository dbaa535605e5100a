"""The traced run: `torch.profiler` around the measured loop, and what the
benchmark reads from its device trace.

`Trace.span` wraps the benchmark's own calls into the program in
`record_function` spans (`bench.<name>`) while tracing, and does nothing
otherwise.  After the window, `device_ops` holds every operation that ran
on the card being read (name, start, end in ns), `kernels` the kernels
among them (memory copies and sets left out), `host_ops` the host's
operator and span intervals.  `busy_s` is the union of the device
operations' intervals; idle gaps are labelled by the innermost benchmark
span and the outermost operator the host was in at the gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import time

_NOT_KERNELS = ("Memcpy", "Memset", "cudaMemcpy", "cudaMemset")


class Trace:
    def __init__(self, enabled: bool, device_index: int = 0):
        self.enabled = enabled
        self.device_index = device_index
        self.device_ops: list = []
        self.kernels: list = []
        self.host_ops: list = []
        self.window_s = None
        self.host = None
        self._prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"bench.{name}")

    @contextlib.contextmanager
    def window(self, sync):
        """Profile the block (when enabled); `sync()` ends the device's
        work before the clock stops.  `host` then holds what the host and
        the card did over the block (`harness.HostProbe`)."""
        from benchmark.harness import HostProbe
        probe = HostProbe(self.device_index)
        if not self.enabled:
            yield
            self.host = probe.read()
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            yield
            sync()
            self.window_s = time.perf_counter() - t0
        self.host = probe.read()
        self._prof = prof
        self._read(torch)

    def _read(self, torch):
        events = self._prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                # the benchmark's own spans are mirrored on the device's
                # timeline as annotations: not operations
                if e.device_index() != self.device_index \
                        or e.is_user_annotation() \
                        or e.name().startswith("bench."):
                    continue
                op = (e.name(), start, start + dur)
                self.device_ops.append(op)
                if not e.name().startswith(_NOT_KERNELS):
                    self.kernels.append(op)
            elif dur > 0:
                self.host_ops.append((e.name(), start, start + dur))
        self.device_ops.sort(key=lambda o: o[1])
        self.kernels.sort(key=lambda o: o[1])
        self.host_ops.sort(key=lambda o: o[1])
        self._prof = None

    # -- what the trace says -------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        busy, end = 0, None
        for _, s, e in self.device_ops:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def kernel_time_s(self, match) -> tuple[float, int]:
        """(summed seconds, count) of the kernels whose name `match`
        accepts."""
        ks = [k for k in self.kernels if match(k[0])]
        return sum(e - s for _, s, e in ks) * 1e-9, len(ks)

    def top_device_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], t * 1e-9] for name, t in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps between device operations inside the window,
        each labelled by what the host was doing at its middle."""
        gaps, end = [], None
        for _, s, e in self.device_ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        starts = [h[1] for h in self.host_ops]
        out = []
        for length, g0, g1 in gaps[:n]:
            mid = (g0 + g1) // 2
            hi = bisect.bisect_right(starts, mid)
            inside = [h for h in self.host_ops[:hi] if h[2] > mid]
            spans = [h for h in inside if h[0].startswith("bench.")]
            ops = [h for h in inside if not h[0].startswith("bench.")]
            span = min(spans, key=lambda h: h[2] - h[1])[0] if spans else ""
            op = max(ops, key=lambda h: h[2] - h[1])[0] if ops else "python"
            label = f"{span} / {op}" if span else op
            out.append([label[:160], length * 1e-9])
        return out


def kernel_matcher(names):
    """A test of a traced kernel name: the function is one of `names` (a
    whole identifier, as the demangled name gives it, before its template
    arguments or parameters)."""
    import re
    pat = re.compile(r"(?:^|[\s:*&])(?:%s)\s*[<(]" % "|".join(
        re.escape(n) for n in names))
    return lambda name: pat.search(name) is not None
