"""`benchmark/spans.py` on hand-built trace contents: gaps cut by span
edges, nested spans of one layer charged once to the innermost, time in no
span charged to no layer, launches counted in their layer alone, and None
where the program recorded no span.  Times are in ns; the window is 1 s,
so 1e7 ns is 1 %."""
import types

import pytest

from benchmark import spans
from benchmark.trace import Trace

MS = 10 ** 6


def trace(device, host, window_s=1.0):
    t = Trace(False)
    t.device_ops = sorted(device, key=lambda o: o[1])
    t.host_ops = sorted(host, key=lambda o: o[1])
    t.window_s = window_s
    return t


def run(tr, **counts):
    return types.SimpleNamespace(trace=tr, **counts)


def k(s, e):
    return ("kernel", s * MS, e * MS)


def h(name, s, e):
    return (name, s * MS, e * MS)


def test_gaps_are_cut_by_span_edges():
    # the card idles from 10 to 50 ms; data covers 0-20, model 30-60
    tr = trace([k(0, 10), k(50, 60)],
               [h("ofdm.data.tx", 0, 20), h("ofdm.model.forward", 30, 60)])
    idle = spans.idle_by_layer(tr)
    assert idle == pytest.approx({"data": 1.0, "model": 2.0})
    # 20-30 ms lies in no span: charged to no layer
    assert sum(idle.values()) == pytest.approx(3.0)


def test_nested_spans_of_one_layer_count_once_for_the_innermost():
    # gather_rows holds exchange; the gap 0-100 ms lies inside both
    tr = trace([k(-5, 0), k(100, 105)],
               [h("ofdm.comm.gather_rows", 0, 100),
                h("ofdm.comm.exchange", 40, 60)])
    assert spans.idle_by_layer(tr) == pytest.approx({"comm": 10.0})
    segs = spans.innermost(spans.program_spans(tr))
    assert segs == [(0, 100 * MS, "comm")]


def test_innermost_span_decides_across_layers():
    # a model span inside an optim span (not a path of the program, but the
    # rule): the inner stretch goes to the model alone
    tr = trace([k(-5, 0), k(100, 105)],
               [h("ofdm.optim.adam", 0, 100),
                h("ofdm.model.backward", 20, 50)])
    assert spans.idle_by_layer(tr) == pytest.approx(
        {"optim": 7.0, "model": 3.0})


def test_time_outside_every_span_goes_to_no_layer():
    tr = trace([k(0, 10), k(90, 100)],
               [h("bench.train_step", 0, 100), h("aten::add", 10, 90),
                h("ofdm.data.norm", 40, 50)])
    assert spans.idle_by_layer(tr) == pytest.approx({"data": 1.0})


def test_busy_card_is_charged_nothing():
    # overlapping operations leave no gap inside the span
    tr = trace([k(0, 30), k(20, 60), k(60, 70)],
               [h("ofdm.model.forward", 0, 70)])
    assert spans.idle_by_layer(tr) == {}
    r = run(tr, steps=3)
    assert spans.idle_pct(r, "model", "steps") == 0.0


def test_launches_counted_only_inside_their_layer():
    tr = trace([k(0, 1)],
               [h("ofdm.optim.adam", 10, 20),
                h("cudaLaunchKernel", 11, 12), h("cudaLaunchKernel", 13, 14),
                h("cuLaunchKernel", 15, 16),
                h("ofdm.data.tx", 30, 40), h("cudaGraphLaunch", 31, 32),
                h("cudaLaunchKernelExC", 50, 51),     # in no span
                h("cudaMemcpyAsync", 12, 13),         # no launch
                h("ofdm.comm.gather_rows", 60, 70),
                h("ofdm.comm.exchange", 62, 68),
                h("cudaLaunchKernel", 63, 64)])
    assert spans.launches_by_layer(tr) == {"optim": 3, "data": 1,
                                           "comm": 1}
    assert spans.launches_per(run(tr, steps=3), "optim", "steps") == 1.0
    assert spans.launches_per(run(tr, calls=2), "data", "calls") == 0.5
    assert spans.launches_per(run(tr, calls=2), "model", "calls") == 0.0


def test_none_without_program_spans_or_counts():
    tr = trace([k(0, 10), k(50, 60)],
               [h("bench.train_step", 0, 60), h("cudaLaunchKernel", 1, 2)])
    assert spans.idle_by_layer(tr) is None
    assert spans.launches_by_layer(tr) is None
    assert spans.idle_pct(run(tr, steps=5), "data", "steps") is None
    assert spans.launches_per(run(tr, steps=5), "optim", "steps") is None
    with_spans = trace([k(0, 10), k(50, 60)], [h("ofdm.data.tx", 0, 60)])
    assert spans.idle_pct(run(with_spans, steps=0), "data", "steps") is None
    assert spans.launches_per(run(with_spans), "data", "calls") is None
    no_card = trace([], [h("ofdm.data.tx", 0, 1)])
    assert spans.idle_pct(run(no_card, steps=1), "data", "steps") is None
    assert spans.launches_per(run(no_card, steps=1), "data", "steps") \
        is None


@pytest.mark.parametrize("name,layer,per", [
    ("data_idle_pct.train", "data", "steps"),
    ("model_idle_pct.train", "model", "steps"),
    ("optim_idle_pct.train", "optim", "steps"),
    ("comm_idle_pct.train", "comm", "steps"),
    ("data_idle_pct.sweep", "data", "calls"),
    ("model_idle_pct.sweep", "model", "calls"),
])
def test_idle_readers(name, layer, per):
    from benchmark.run import layer_metric
    tr = trace([k(0, 10), k(90, 100)],
               [h(f"ofdm.{layer}.x", 20, 30), h("ofdm.fit.epoch_end", 30, 40)])
    assert layer_metric(name, run(tr, **{per: 4})) == pytest.approx(1.0)
    assert layer_metric(name, run(trace([k(0, 10)], []), **{per: 4})) \
        is None


@pytest.mark.parametrize("name,layer,per", [
    ("optim_launches_per_step", "optim", "steps"),
    ("data_launches_per_call", "data", "calls"),
])
def test_launch_readers(name, layer, per):
    from benchmark.run import layer_metric
    tr = trace([k(0, 1)], [h(f"ofdm.{layer}.x", 0, 10)]
               + [h("cudaLaunchKernel", i, i + 0.5) for i in range(8)])
    assert layer_metric(name, run(tr, **{per: 4})) == 2.0
