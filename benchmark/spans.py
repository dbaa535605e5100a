"""The program's own spans in a traced window: which layer the host was in
while the card sat idle, and how many launches each layer issued.

The port marks its layers with `ofdm.<layer>.<part>` spans
(`dl_ofdm_tpu_torch/utils/observability.py::span`), which the profiler
records as host events, on the clock of the card's operations.  Both
readers below use only what `trace.Trace` holds: `device_ops`, `host_ops`
(the spans among them) and `window_s`.

Idle charged to a layer: the gaps between the card's operations (the
union of their intervals, from the first operation's start to the last
one's end), intersected with the layer's spans, each nanosecond going to
the innermost `ofdm.` span open at that moment, so no layer counts a
nanosecond twice; time in no `ofdm.` span goes to no layer.  Launches in a
layer: the host's kernel-launch API events (`cudaLaunch*`, `cuLaunch*`,
`cudaGraphLaunch`) that start inside its spans, the innermost span again
deciding.  Both read None where the trace holds no `ofdm.` span (a
program without them) or no operation on a card.
"""
from __future__ import annotations

import bisect

PREFIX = "ofdm."
LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")


def layer_of(name: str) -> str:
    """'ofdm.data.tx' -> 'data'."""
    return name[len(PREFIX):].split(".", 1)[0]


def program_spans(trace) -> list:
    return [h for h in trace.host_ops if h[0].startswith(PREFIX)]


def innermost(spans: list) -> list:
    """Disjoint (start, end, layer) segments, sorted, covering every
    moment some span is open, each labelled by the layer of the innermost
    span then open (the latest started; of those, the shortest)."""
    edges = sorted({t for _, s, e in spans for t in (s, e)})
    by_start = sorted(spans, key=lambda h: h[1])
    out, open_, i = [], [], 0
    for t0, t1 in zip(edges, edges[1:]):
        while i < len(by_start) and by_start[i][1] <= t0:
            open_.append(by_start[i])
            i += 1
        open_ = [h for h in open_ if h[2] > t0]
        if not open_:
            continue
        top = max(open_, key=lambda h: (h[1], h[1] - h[2]))
        lay = layer_of(top[0])
        if out and out[-1][2] == lay and out[-1][1] == t0:
            out[-1] = (out[-1][0], t1, lay)
        else:
            out.append((t0, t1, lay))
    return out


def device_gaps(trace) -> list:
    """(start, end) of each stretch between the card's operations."""
    gaps, end = [], None
    for _, s, e in trace.device_ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_by_layer(trace) -> dict | None:
    """{layer: share of the window in %} of the card's idle time, charged
    to the layer the host was in; None without `ofdm.` spans or device
    operations."""
    spans = program_spans(trace)
    if not spans or not trace.device_ops or not trace.window_s:
        return None
    segs, gaps = innermost(spans), device_gaps(trace)
    out: dict = {}
    j = 0
    for s0, s1, lay in segs:
        while j < len(gaps) and gaps[j][1] <= s0:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < s1:
            ov = min(s1, gaps[k][1]) - max(s0, gaps[k][0])
            if ov > 0:
                out[lay] = out.get(lay, 0) + ov
            k += 1
    return {lay: 100.0 * ns * 1e-9 / trace.window_s
            for lay, ns in out.items()}


def launches_by_layer(trace) -> dict | None:
    """{layer: kernel-launch API events that started inside its spans};
    None without `ofdm.` spans or device operations."""
    spans = program_spans(trace)
    if not spans or not trace.device_ops:
        return None
    segs = innermost(spans)
    starts = [s for s, _, _ in segs]
    out: dict = {}
    for name, t, _ in trace.host_ops:
        if not name.startswith(LAUNCH):
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < segs[i][1]:
            out[segs[i][2]] = out.get(segs[i][2], 0) + 1
    return out


def idle_pct(run, layer: str, per: str):
    """A layer's idle share over the window, or None where the trace or
    the run's `per` count (steps, calls) holds nothing."""
    if not getattr(run, per, None):
        return None
    idle = idle_by_layer(run.trace)
    return None if idle is None else idle.get(layer, 0.0)


def launches_per(run, layer: str, per: str):
    """A layer's launches over the run's `per` count (steps, calls)."""
    n = getattr(run, per, None)
    if not n:
        return None
    launches = launches_by_layer(run.trace)
    return None if launches is None else launches.get(layer, 0) / n
