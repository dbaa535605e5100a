"""The port's spans (`dl_ofdm_tpu_torch/utils/observability.py::span`).

With no profiler recording, the step, the eval, the sweep's batch, a
one-process mesh step and the equalizer stage's step and eval never reach
`record_function`, and `span` hands out one shared null context.  Under
`profile_trace` each path writes exactly its documented spans to
`trace.json`, and no span of one layer holds a span of another; both
`fit`s write their epoch ends."""
import collections
import contextlib
import json

import pytest
import torch

from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval import sweep
from dl_ofdm_tpu_torch.ops.fused_synth import draw_words
from dl_ofdm_tpu_torch.parallel import mesh as tmesh
from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
from dl_ofdm_tpu_torch.train.loop import Trainer
from dl_ofdm_tpu_torch.utils import observability as obs

FRAMES = 4
DATA = {"ofdm.data.tx": 1, "ofdm.data.channel": 1, "ofdm.data.awgn": 1,
        "ofdm.data.norm": 1}
EQ = {"ofdm.eq.front": 1, "ofdm.eq.chest": 1, "ofdm.eq.equalize": 1}


def _trainer(mesh=None):
    return Trainer(OFDMConfig(nbits=1), TrainConfig(
        snr=5.0, batch_size=7 * FRAMES, msg_length=14 * FRAMES),
        channel="ETU", device="cpu", mesh=mesh)


def _snr(n=FRAMES):
    return torch.full((n,), 5.0)


def _train_step(fused):
    tt = _trainer()
    g = torch.Generator().manual_seed(0)
    state = tt.init_state(g)
    return lambda: tt.train_step(state, g, _snr(), fused=fused)


def _fused_synth_branch():
    tt = _trainer()
    g = torch.Generator().manual_seed(0)
    state = tt.init_state(g)
    words = draw_words(tt._fused_synth_spec, FRAMES,
                       torch.tensor([3, 4], dtype=torch.int64), "cpu")
    return lambda: tt.train_step(state, g, _snr(), words=words,
                                 fused=False)


def _eval_step():
    tt = _trainer()
    g = torch.Generator().manual_seed(0)
    params = tt.init_state(g).params
    return lambda: tt.eval_step(params, g, FRAMES, _snr())


def _eval_batch():
    tt = _trainer()
    g = torch.Generator().manual_seed(0)
    tt.init_state(g)
    snr_vec, onehot = sweep.interleaved_groups([0.0, 10.0], 8, "cpu")
    return lambda: sweep.eval_batch(tt, snr_vec, onehot, g)


def _eq_trainer():
    return EqualizerTrainer(OFDMConfig(nbits=1), TrainConfig(
        batch_size=7 * FRAMES, msg_length=14 * FRAMES, opt=12,
        curriculum_tail=True), channel="mixRayleigh", mobile=True,
        device="cpu")


def _eq_step():
    tt = _eq_trainer()
    g = torch.Generator().manual_seed(0)
    state = tt.init_state(g)
    return lambda: tt.train_step_curriculum(state, g)


def _eq_eval_step():
    tt = _eq_trainer()
    g = torch.Generator().manual_seed(0)
    params = tt.init_state(g).params
    return lambda: tt.eval_step(params, g, FRAMES, _snr())


def _mesh_step():
    tt = _trainer(tmesh.make_mesh(["cpu"] * 2, dp=2))
    g = torch.Generator().manual_seed(0)
    state = tt.init_state(g)
    return lambda: tt.train_step(state, g, _snr())


# each path's spans, with how often each is entered
PATHS = {
    "train_step": (lambda: _train_step(False), {
        **DATA, "ofdm.model.forward": 1, "ofdm.optim.loss_terms": 1,
        "ofdm.model.backward": 1, "ofdm.optim.adam": 1}),
    "train_step_fused": (lambda: _train_step(True), {
        "ofdm.data.fused_synth": 1, "ofdm.model.fused_grads": 1,
        "ofdm.optim.loss_terms": 1, "ofdm.optim.adam": 1}),
    "train_step_fused_synth": (_fused_synth_branch, {
        "ofdm.data.fused_synth": 1, "ofdm.model.forward": 1,
        "ofdm.optim.loss_terms": 1, "ofdm.model.backward": 1,
        "ofdm.optim.adam": 1}),
    "eval_step": (_eval_step, {
        **DATA, "ofdm.model.forward": 1, "ofdm.optim.loss_terms": 1}),
    "eval_batch": (_eval_batch, {**DATA, "ofdm.model.forward": 1}),
    # two rows: each draws and runs forward and backward; the noise power,
    # the CE terms and the gradients gathered; the L2 term's own backward
    # and its gradient added
    "mesh_step_dp2": (_mesh_step, {
        **{k: 2 for k in DATA}, "ofdm.comm.gather_rows": 3,
        "ofdm.model.forward": 2, "ofdm.model.backward": 3,
        "ofdm.optim.loss_terms": 2, "ofdm.optim.adam": 1}),
    # the curriculum's SNRs; the equalizer's three stages; the frozen
    # receiver and then the CE and counts, each under model.forward
    "eq_train_step_curriculum": (_eq_step, {
        "ofdm.data.snr": 1, **DATA, **EQ, "ofdm.model.forward": 2,
        "ofdm.optim.loss_terms": 1, "ofdm.model.backward": 1,
        "ofdm.optim.adam": 1}),
    "eq_eval_step": (_eq_eval_step, {
        **DATA, **EQ, "ofdm.model.forward": 2, "ofdm.optim.loss_terms": 1}),
}
NO_PROFILER = ("train_step", "train_step_fused", "eval_step", "eval_batch",
               "mesh_step_dp2", "eq_train_step_curriculum", "eq_eval_step")


def _spans(log_dir):
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e["name"].startswith("ofdm.")]


def _layer(name):
    return name.split(".")[1]


def _traced(fn, log_dir):
    with obs.profile_trace(str(log_dir)):
        fn()
    return _spans(log_dir)


def _assert_layers_flat(spans):
    for a, a0, a1 in spans:
        for b, b0, b1 in spans:
            if _layer(a) != _layer(b):
                assert not (a0 <= b0 and b1 <= a1 and (a0, a1) != (b0, b1)), \
                    f"{a} holds {b}"


def test_span_without_profiler_is_one_shared_null_context():
    a, b = obs.span("data.tx"), obs.span("model.forward")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            pass


@pytest.mark.parametrize("path", NO_PROFILER)
def test_paths_never_reach_record_function_without_profiler(path,
                                                            monkeypatch):
    fn = PATHS[path][0]()

    def refuse(*a, **k):
        raise AssertionError("record_function with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    fn()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_path_writes_its_spans_and_no_layer_holds_another(path, tmp_path):
    make, want = PATHS[path]
    fn = make()
    spans = _traced(fn, tmp_path)
    assert dict(collections.Counter(n for n, _, _ in spans)) == want
    _assert_layers_flat(spans)
    # the profiler is off again: the shared null context
    assert obs.span("data.tx") is obs.span("optim.adam")


def test_fit_writes_its_epoch_end(tmp_path):
    tt = _trainer()
    spans = _traced(lambda: tt.fit(max_epochs=2, grow_batch=False,
                                   log_fn=lambda *a: None), tmp_path)
    names = collections.Counter(n for n, _, _ in spans)
    assert names["ofdm.fit.epoch_end"] == 2
    assert names["ofdm.comm.agree"] == 2
    # two steps an epoch, an eval_step after each
    assert names["ofdm.optim.adam"] == 4
    assert names["ofdm.model.forward"] == 6
    _assert_layers_flat(spans)
    # the epoch end follows the agreed read, once an epoch
    agree = sorted(s for n, s, _ in spans if n == "ofdm.comm.agree")
    ends = sorted(s for n, s, _ in spans if n == "ofdm.fit.epoch_end")
    assert all(a < e for a, e in zip(agree, ends))


def test_equalizer_fit_writes_its_epoch_end(tmp_path):
    tt = _eq_trainer()
    spans = _traced(lambda: tt.fit(max_epochs=2, log_fn=lambda *a: None),
                    tmp_path)
    names = collections.Counter(n for n, _, _ in spans)
    assert names["ofdm.fit.epoch_end"] == 2
    assert names["ofdm.comm.agree"] == 2
    # two steps an epoch, an eval_step after each, every one with its SNRs
    assert names["ofdm.optim.adam"] == 4
    assert names["ofdm.data.snr"] == 6
    assert all(names[k] == 6 for k in EQ)
    assert names["ofdm.model.forward"] == 12
    _assert_layers_flat(spans)
