"""The port's checkpoints and resume payloads (`train/checkpoint.py`,
`Trainer.fit` / `EqualizerTrainer.fit` with `ckpt_dir`): `token_name`
against the JAX package's, a save/restore round trip of a `TrainState`
(params, Adam's moments and count, step), and the port's versions of
`tests/test_train.py:197-297`: a warm start from a restored checkpoint,
a crash-resumed trajectory equal to an uninterrupted one, refusal of a
payload written under another configuration (with and without the
sidecar), for the basic trainer, the equalizer stage and a dp mesh of
CPU virtual ranks.  Resumed and uninterrupted runs are compared bit for
bit: parameters, Adam's moments, histories, the generator's state."""
import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from dl_ofdm_tpu.train import checkpoint as jckpt
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
from dl_ofdm_tpu_torch.train import checkpoint as ckpt
from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
from dl_ofdm_tpu_torch.train.loop import Trainer, deterministic_cudnn

QUIET = dict(log_fn=lambda *a: None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: these fits are many small operations,
    which torch's thread pool slows down many times over when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
CFG = OFDMConfig(nbits=1)
TC = TrainConfig(snr=5.0, batch_size=56, msg_length=392, max_epoch_num=6,
                 early_stop=50)


@pytest.mark.parametrize("token,nbits,snr,cp,opt,channel", list(
    itertools.product(["OFDM", "OFDM_Dense3"], [1, 4], [5.0, 12.7], [True, False],
                      [None, 0, 12], [None, "mixRayleigh"])))
def test_token_name_matches_jax(token, nbits, snr, cp, opt, channel):
    assert ckpt.token_name(token, nbits, snr, cp, opt, channel) == \
        jckpt.token_name(token, nbits, snr, cp, opt, channel)


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert a.opt_state["count"] == b.opt_state["count"]
    for x, y in ((a.params, b.params), (a.opt_state["mu"], b.opt_state["mu"]),
                 (a.opt_state["nu"], b.opt_state["nu"])):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k


def test_save_restore_round_trip(tmp_path):
    tr = Trainer(OFDMConfig(nbits=2), TrainConfig(batch_size=21),
                 channel="AWGN", device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = tr.init_state(gen)
    for _ in range(2):
        state, _ = tr.train_step(state, gen, torch.full((3,), 6.0))
    path = ckpt.save(str(tmp_path / "ck"), state)
    assert os.path.isdir(path) and os.listdir(path) == [ckpt.STATE_FILE]
    with np.load(os.path.join(path, ckpt.STATE_FILE)) as data:
        # params and moments under their flax paths (kernels [in, out])
        np.testing.assert_array_equal(
            data["params/Dense_extract/kernel"],
            state.params["Dense_extract.weight"].numpy().T)
        assert "opt/mu/fft_like/wr" in data.files and int(data["step"]) == 2
    back = ckpt.restore(path, tr.init_state(torch.Generator().manual_seed(9)))
    _assert_states_equal(back, state)
    assert ckpt.has_checkpoint(path) and not ckpt.has_checkpoint(
        str(tmp_path / "none"))
    other = Trainer(OFDMConfig(nbits=1), TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, other.init_state())


def test_fit_warm_start_resumes_from_checkpoint(tmp_path):
    """fit(init_state=...) continues from a restored state and keeps the
    equalizer stage's receiver frozen (`tests/test_train.py:197-230`)."""
    tc = TrainConfig(batch_size=14, msg_length=98, max_epoch_num=1,
                     early_stop=5, opt=0)
    rx = Trainer(CFG, tc, device="cpu").init_state(
        torch.Generator().manual_seed(0)).params
    eq = EqualizerTrainer(CFG, tc, channel="ETU", pretrained_rx=rx,
                          device="cpu")
    state1, _ = eq.fit(**QUIET)
    path = ckpt.save(str(tmp_path / "eqm"), state1)
    eq2 = EqualizerTrainer(CFG, tc, channel="ETU", pretrained_rx=rx,
                           device="cpu")
    warm = ckpt.restore(path, eq2.init_state(torch.Generator().manual_seed(9)))
    state2, info = eq2.fit(seed=11, init_state=warm, **QUIET)
    assert info["best_epoch"] == 0 and np.isfinite(info["best_loss"])
    assert state2.opt_state["count"] == 2 * state1.opt_state["count"]
    for k, v in state2.params.items():
        assert v.is_contiguous(), k
        if k.startswith("receiver."):
            assert torch.equal(v, state1.params[k]), k
    assert any(not torch.equal(v, state1.params[k])
               for k, v in state2.params.items() if k.startswith("Equalizer"))


def _crash_resume(make, tmp_path, epochs=4, stop=2, every=2, **fit):
    """(uninterrupted (state, info), resumed (state, info), both trainers):
    a run of `epochs`, and one stopped after `stop` epochs and restarted by
    a fresh trainer from its payload."""
    a = make()
    straight = a.fit(max_epochs=epochs, **QUIET, **fit)
    d = str(tmp_path / "wip")
    make().fit(max_epochs=stop, ckpt_dir=d, ckpt_every=every, **QUIET, **fit)
    b = make()
    resumed = b.fit(max_epochs=epochs, ckpt_dir=d, ckpt_every=every,
                    **QUIET, **fit)
    return straight, resumed, (a, b)


def _assert_same_trajectory(straight, resumed, first):
    (sa, ia), (sb, ib) = straight, resumed
    _assert_states_equal(sa, sb)
    hist_a = {h["epoch"]: h for h in ia["history"]}
    assert [h["epoch"] for h in ib["history"]] == list(
        range(first, len(hist_a)))
    for h in ib["history"]:
        assert h == hist_a[h["epoch"]]
    assert (ia["best_epoch"], ia["best_loss"]) == (ib["best_epoch"],
                                                   ib["best_loss"])


def test_fit_crash_resume_trajectory_identical(tmp_path):
    """A fit resumed from its mid-run payload ends bit-identical to an
    uninterrupted one (`tests/test_train.py:241-267`)."""
    straight, resumed, (a, b) = _crash_resume(
        lambda: Trainer(CFG, TC, channel="AWGN", device="cpu"), tmp_path,
        grow_batch=False)
    _assert_same_trajectory(straight, resumed, first=2)
    assert b.batch_frames == a.batch_frames


def test_resume_restores_cursor_batch_and_generator(tmp_path):
    """`_maybe_resume` takes the cursor, the (grown) batch size and the
    generator's state from the payload; best params that are the state's
    own are written once and come back as the state's."""
    tr = Trainer(CFG, TC, device="cpu")
    gen = torch.Generator().manual_seed(3)
    state = tr.init_state(gen)
    torch.rand(5, generator=gen)                 # a generator mid-stream
    ckpt.save_resume(str(tmp_path / "resume"), state=state, generator=gen,
                     epoch=3, best_loss=0.25, best_epoch=2,
                     best_params=state.params, batch_frames=24,
                     config_sig=tr._config_sig())
    with np.load(tmp_path / "resume" / ckpt.STATE_FILE) as data:
        assert bool(data["best_is_state"])
        assert not any(k.startswith("best/") for k in data.files)
    fresh = Trainer(CFG, TC, device="cpu")
    gen2 = torch.Generator().manual_seed(99)
    st, start, best_loss, best_epoch, best, resumed = fresh._maybe_resume(
        str(tmp_path), fresh.init_state(gen2), gen2)
    assert resumed and (start, best_loss, best_epoch) == (4, 0.25, 2)
    assert fresh.batch_frames == 24 and best is st.params
    assert torch.equal(gen2.get_state(), gen.get_state())
    _assert_states_equal(st, state)


def test_resume_refuses_config_mismatch(tmp_path):
    """`tests/test_train.py:270-297`: a payload written under one
    configuration is refused by a fit with another, also when the sidecar
    is gone (the signature inside the payload)."""
    d = str(tmp_path / "wip")
    tc = dataclasses.replace(TC, max_epoch_num=4)
    Trainer(CFG, tc, device="cpu").fit(max_epochs=2, grow_batch=False,
                                       ckpt_dir=d, ckpt_every=2, **QUIET)
    sig = ckpt.resume_sig(os.path.join(d, "resume"))
    assert sig == Trainer(CFG, tc, device="cpu")._config_sig()
    tr2 = Trainer(CFG, dataclasses.replace(tc, init_learning=5e-4),
                  device="cpu")
    with pytest.raises(RuntimeError, match="different configuration"):
        tr2.fit(grow_batch=False, ckpt_dir=d, ckpt_every=2, **QUIET)
    os.remove(os.path.join(d, "resume.sig"))
    with pytest.raises(RuntimeError, match="different configuration"):
        tr2.fit(grow_batch=False, ckpt_dir=d, ckpt_every=2, **QUIET)
    _, info = Trainer(CFG, tc, device="cpu").fit(
        grow_batch=False, ckpt_dir=d, ckpt_every=2, **QUIET)
    assert [h["epoch"] for h in info["history"]] == [2, 3]


def test_equalizer_fit_crash_resume_identical(tmp_path):
    """The equalizer stage resumes bit-identically, its Adam state over the
    Equalizer scope only; the signature covers `freeze_rx` and
    `fused_curriculum`."""
    tc = TrainConfig(snr=5.0, batch_size=21, msg_length=84, opt=2,
                     max_epoch_num=4, early_stop=50)

    def make(freeze_rx=True, fused=False):
        eq = EqualizerTrainer(CFG, tc, channel="EPA", freeze_rx=freeze_rx,
                              device="cpu")
        eq.fused_curriculum = fused
        return eq

    straight, resumed, _ = _crash_resume(make, tmp_path, every=1)
    _assert_same_trajectory(straight, resumed, first=2)
    assert all(k.startswith("Equalizer.")
               for k in resumed[0].opt_state["mu"])
    sigs = {make(f, c)._config_sig() for f in (True, False)
            for c in (True, False)}
    assert len(sigs) == 4


def test_mesh_fit_crash_resume_identical(tmp_path):
    """On a dp mesh of CPU virtual ranks: the payload holds one copy of the
    params and the replicas are rebuilt from it; the rank generators come
    from the restored generator."""
    def make():
        return Trainer(CFG, dataclasses.replace(TC, batch_size=28,
                                                msg_length=112),
                       device="cpu", mesh=make_mesh(["cpu"] * 2, dp=2))

    straight, resumed, _ = _crash_resume(make, tmp_path, epochs=3, stop=2,
                                         every=1, grow_batch=False)
    _assert_same_trajectory(straight, resumed, first=2)
    for rep in resumed[0].replicas:
        for k, v in rep.items():
            assert torch.equal(v, straight[0].params[k])


def test_fit_restores_cudnn_setting(monkeypatch):
    """`fit` runs under cuDNN's deterministic algorithms (its default
    backward-filter algorithm sums a convolution's weight gradient in a
    varying order on a card) and gives the caller's setting back."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    for before in (False, True):
        torch.backends.cudnn.deterministic = before
        with deterministic_cudnn():
            assert torch.backends.cudnn.deterministic
        assert torch.backends.cudnn.deterministic is before
    torch.backends.cudnn.deterministic = False
    eq = EqualizerTrainer(CFG, TrainConfig(batch_size=14, msg_length=14,
                                           opt=12), channel="EPA",
                          device="cpu")
    step, seen = eq.train_step_curriculum, []

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.deterministic)
        return step(*a, **k)

    eq.train_step_curriculum = spy
    eq.fit(max_epochs=1, **QUIET)
    assert seen == [True] and torch.backends.cudnn.deterministic is False
