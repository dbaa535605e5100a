"""The port's equalizer transfer-learning stage against the JAX package:
the composed receivers, a committed equalizer arm's forward pass,
`graft_pretrained` and `scope_mask`, the stage's loss and its gradients,
one masked Adam step against `optax.masked`, the SNR curriculum, the
`EqualizerTrainer` step on each data plane, and `cross_channel_sweep`.

Tolerances: float32 on both sides with sums in other orders; 1e-4 of the
output's scale for forward passes, 1e-3 of each leaf's largest gradient
(the arm's ZF division amplifies rounding), Adam updates to 1e-6 (a
few ulp of the 1e-3 learning rate)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.eval import sweep as jsweep
from dl_ofdm_tpu.models import receiver as jrecv
from dl_ofdm_tpu.models.equalizers import EQUALIZER_REGISTRY as JREG
from dl_ofdm_tpu.train import checkpoint as jckpt
from dl_ofdm_tpu.train import curriculum as jcur
from dl_ofdm_tpu.train import transfer as jtransfer
from dl_ofdm_tpu.train.equalizer_loop import EqualizerTrainer as JEqTrainer
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval import sweep as tsweep
from dl_ofdm_tpu_torch.models import receiver as trecv
from dl_ofdm_tpu_torch.models.equalizers import EQUALIZER_REGISTRY as TREG
from dl_ofdm_tpu_torch.train import checkpoint as tckpt
from dl_ofdm_tpu_torch.train import curriculum as tcur
from dl_ofdm_tpu_torch.train import transfer as ttransfer
from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
from dl_ofdm_tpu_torch.train.loop import TrainState

ARMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "runs", "arms")
BASE = os.path.join(ARMS, "OFDM_Dense3_2mod_snr10_cpTrue.npz")
ARM = os.path.join(ARMS,
                   "OFDM_Dense3_2mod_snr10_cpTrue_Equalizer12_mixRayleigh.npz")


def _flat(tree):
    return tckpt.params_from_flax(jax.tree.map(np.asarray, tree))


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# a narrow receiver: 16 subcarriers, 4 of CP, 3 symbols, 8 filters
SMALL = dict(nbits=2, nfft=16, cp_len=4, nfilter=8, frame_size=24,
             nsymbol=3, pilot_size=4)


@pytest.mark.parametrize("opt", [0, 12])
def test_equalized_receiver_matches_jax(opt, rng):
    x = rng.normal(size=(4, 3, 20, 2)).astype(np.float32)
    kw = dict(SMALL, pilot_carriers=(1, 5, 9, 13))
    jmod = jrecv.EqualizedReceiver(eq_spec=JREG[opt], **kw)
    params = jmod.init(jax.random.PRNGKey(opt), jnp.asarray(x))["params"]
    tmod = trecv.EqualizedReceiver(eq_spec=TREG[opt], **kw)
    tmod.load_state_dict(_flat(params), strict=True)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b, 1e-4)


@pytest.mark.parametrize("keep_cp", [True, False])
def test_single_graph_equalized_rx_matches_jax(keep_cp, rng):
    x = rng.normal(size=(4, 3, 20, 2)).astype(np.float32)
    jmod = jrecv.SingleGraphEqualizedRx(keep_cp=keep_cp, **SMALL)
    params = jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(
            np.float32),
        jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    tmod = trecv.SingleGraphEqualizedRx(keep_cp=keep_cp, **SMALL)
    tmod.load_state_dict(_flat(params), strict=True)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b, 1e-4)


@pytest.fixture(scope="module")
def arm():
    """The committed QPSK opt-12 arm: its params (flax tree), the port's
    trainer with them loaded, and JAX's trainer (CPU)."""
    params = tckpt.load_params_npz(ARM)
    base = tckpt.params_from_flax(tckpt.load_params_npz(BASE))
    tt = EqualizerTrainer(OFDMConfig(nbits=2), TrainConfig(
        snr=10.0, batch_size=28, opt=12), channel="mixRayleigh",
        pretrained_rx=base, device="cpu")
    tt.model.load_state_dict(tckpt.params_from_flax(params), strict=True)
    jt = JEqTrainer(JCfg(nbits=2), JTc(snr=10.0, batch_size=28, opt=12),
                    channel="mixRayleigh",
                    pretrained_rx=jckpt.load_params_npz(BASE))
    return params, tt, jt


def test_committed_arm_forward_matches_jax(arm, rng):
    params, tt, jt = arm
    x = rng.normal(size=(6, 7, 80, 2)).astype(np.float32)
    want = jt.model.apply({"params": jax.tree.map(jnp.asarray, params)},
                          jnp.asarray(x))
    with torch.no_grad():
        got = tt.model(torch.from_numpy(x))
    for name, a, b in zip(("logits", "fft_out", "equalized", "snr_db",
                           "chest"), got, want):
        assert tuple(a.shape) == b.shape, name
        _close(a, b, 1e-4)


def test_params_round_trip_through_a_two_scope_arm():
    tree = tckpt.load_params_npz(ARM)
    assert set(tree) == {"Equalizer", "receiver"}
    sd = tckpt.params_from_flax(tree)
    assert sd["Equalizer.BlockConv0.wr"].shape == (7, 64, 1, 1)
    assert sd["Equalizer.Dense_in.weight"].shape == (128, 160)
    back = tckpt.params_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_graft_pretrained_and_scope_mask_match_jax():
    fresh = {"Equalizer": {"Dense_in": {"kernel": np.zeros((2, 3)),
                                        "bias": np.zeros(3)}},
             "receiver": {"fft_like": {"wr": np.zeros((4, 5))}}}
    pre = {"fft_like": {"wr": np.ones((4, 5))}}
    want = jtransfer.graft_pretrained(fresh, pre)
    got = ttransfer.graft_pretrained(_flat(fresh), _flat(pre))
    assert set(got) == set(_flat(want))
    for k, v in _flat(want).items():
        assert torch.equal(got[k].to(v.dtype), v), k
    jmask = jtransfer.scope_mask(want)
    tmask = ttransfer.scope_mask(got)
    assert tmask == {"Equalizer.Dense_in.weight": True,
                     "Equalizer.Dense_in.bias": True,
                     "receiver.fft_like.wr": False}
    assert sorted(jax.tree.leaves(jmask)) == sorted(tmask.values())
    with pytest.raises(KeyError):
        ttransfer.graft_pretrained({"Equalizer.x": torch.zeros(1)},
                                   _flat(pre))


def _batch(rng, b):
    bits = rng.integers(0, 2, size=(b, 320, 2)).astype(np.int32)
    rx = rng.normal(size=(b, 7, 80, 2)).astype(np.float32)
    h = rng.normal(size=(b, 7, 64, 2)).astype(np.float32)
    snr = rng.uniform(0, 30, size=(b,)).astype(np.float32)
    return bits, rx, h, snr


def test_loss_and_gradients_match_jax(arm, rng):
    params, tt, jt = arm
    bits, rx, h, snr = _batch(rng, 5)
    jp = jax.tree.map(jnp.asarray, params)
    (jloss, jaux), jgrads = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        jp, jnp.asarray(bits), jnp.asarray(rx), jnp.asarray(h),
        jnp.asarray(snr))
    tp = {k: v.requires_grad_() for k, v in
          tckpt.params_from_flax(params).items()}
    loss, aux = tt._loss_fn(tp, torch.from_numpy(bits), torch.from_numpy(rx),
                            torch.from_numpy(h), torch.from_numpy(snr))
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for key in ("ce", "ber", "snr_mse", "chan_mse", "total_loss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-4, err_msg=key)
    assert torch.equal(aux["conf"], torch.tensor(
        np.asarray(jaux["conf"])).to(aux["conf"].dtype))
    want = _flat(jgrads)
    assert set(grads) == set(want)
    for k, g in grads.items():
        scale = float(want[k].abs().max()) or 1.0
        assert float((g - want[k]).abs().max()) <= 1e-3 * scale, k


def test_masked_adam_step_matches_optax_masked(rng):
    tree = tckpt.load_params_npz(ARM)
    tc = TrainConfig(opt=12)
    jopt, jmask = jtransfer.masked_optimizer(JTc(opt=12), tree)
    gtree = jax.tree.map(
        lambda v, m: (rng.normal(size=v.shape) * m).astype(np.float32),
        tree, jmask)
    jstate = jopt.init(tree)
    jupd, jstate = jopt.update(gtree, jstate, tree)
    jupd2, _ = jopt.update(gtree, jstate, tree)
    params = tckpt.params_from_flax(tree)
    mask = ttransfer.scope_mask(params)
    tt = EqualizerTrainer(OFDMConfig(nbits=2), tc, device="cpu")
    state = tt.init_state(torch.Generator().manual_seed(0))
    assert set(state.params) == set(params)
    assert tt._trainable == [k for k in state.params if mask[k]]
    state = TrainState(params, tt.optimizer.init(
        {k: params[k] for k in tt._trainable}), 0)
    assert set(state.opt_state["mu"]) == {k for k, m in mask.items() if m}
    # the frozen leaves' gradients are not zeroed here: they must not count
    grads = {k: g if mask[k] else torch.ones_like(g)
             for k, g in _flat(gtree).items()}
    for jstep in (jupd, jupd2):
        want = _flat(jstep)
        upd, _ = tt.optimizer.update({k: grads[k] for k in tt._trainable},
                                     state.opt_state)
        # every key's gradient in, as `Trainer.train_step` hands them over
        new = tt._apply(state, grads)
        for k, v in new.params.items():
            if mask[k]:
                np.testing.assert_allclose(upd[k].numpy(), want[k].numpy(),
                                           atol=1e-6, rtol=1e-5, err_msg=k)
                assert torch.equal(v, state.params[k] + upd[k]), k
            else:
                # optax.masked passes the zeroed gradient through
                assert torch.count_nonzero(want[k]) == 0, k
                assert v is params[k], k
        state = new


def test_sample_snr_matches_the_pmf_in_distribution():
    n = 100_000
    g = torch.Generator().manual_seed(0)
    for tail, grid, pmf in ((False, jcur.SNR_GRID, jcur.SNR_PMF),
                            (True, jcur.SNR_TAIL_GRID, jcur.SNR_TAIL_PMF)):
        np.testing.assert_array_equal(
            (tcur.SNR_TAIL_GRID if tail else tcur.SNR_GRID), grid)
        s = tcur.sample_snr(g, n, 2.5, tail=tail).numpy()
        assert s.dtype == np.float32 and s.shape == (n,)
        counts = np.asarray([np.sum(np.isclose(s, v + 2.5)) for v in grid])
        assert counts.sum() == n
        sigma = np.sqrt(n * pmf * (1 - pmf))
        assert np.all(np.abs(counts - n * pmf) <= 3 * sigma), (tail, counts)
    for nbits in (1, 2, 3, 4):
        assert tcur.modulation_offset_db(nbits) == \
            jcur.modulation_offset_db(nbits)


def test_equalizer_trainer_steps_keep_the_receiver_frozen():
    base = tckpt.params_from_flax(tckpt.load_params_npz(BASE))
    tt = EqualizerTrainer(OFDMConfig(nbits=2), TrainConfig(
        snr=10.0, batch_size=28, opt=12), channel="mixRayleigh",
        pretrained_rx=base, device="cpu")
    assert tt._fused_model_spec is None and not tt.fused_curriculum
    g = torch.Generator().manual_seed(0)
    state = tt.init_state(g)
    eq0 = {k: v.clone() for k, v in state.params.items()}
    for fused in (False, True, False):
        tt.fused_curriculum = fused
        state, aux = tt.train_step_curriculum(state, g)
        assert all(np.isfinite(float(aux[k])) for k in
                   ("loss", "ce", "snr_mse", "chan_mse")), fused
    assert state.step == 3 and state.opt_state["count"] == 3
    for k, v in state.params.items():
        if k.startswith("receiver."):
            assert torch.equal(v, base[k[len("receiver."):]]), k
        else:
            assert not torch.equal(v, eq0[k]), k
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        tt.fit(max_epochs=1, ckpt_dir="x")
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        EqualizerTrainer(OFDMConfig(nbits=2), TrainConfig(), mesh=object(),
                         device="cpu")


def test_equalizer_trainer_fit_and_unfrozen_receiver():
    tt = EqualizerTrainer(OFDMConfig(nbits=1), TrainConfig(
        snr=5.0, batch_size=21, msg_length=42, opt=2), channel="EPA",
        freeze_rx=False, device="cpu")
    state, info = tt.fit(max_epochs=2, log_fn=lambda *a: None)
    assert [h["epoch"] for h in info["history"]] == [0, 1]
    assert tt._trainable == list(state.params) and state.step == 4
    assert "receiver.fft_like.wr" in state.opt_state["mu"]
    for h in info["history"]:
        assert np.isfinite([h["train_loss"], h["val_ber"]]).all()


def test_cross_channel_sweep_writes_jax_csv_names(tmp_path, monkeypatch):
    params = tckpt.params_from_flax(tckpt.load_params_npz(ARM))
    chans, snrs = ("ETU", "Flat"), (0, 30)

    def make_trainer(chan, mobile):
        return EqualizerTrainer(OFDMConfig(nbits=2), TrainConfig(opt=12),
                                channel=chan, mobile=mobile, device="cpu")

    out = tsweep.cross_channel_sweep(
        make_trainer, params, torch.Generator().manual_seed(3),
        token="TOK", opt=12, train_channel="mixRayleigh", mobile=True,
        save_dir=str(tmp_path / "t"), snrs=snrs, frames_per_point=24,
        batch_frames=24, test_channels=chans, log_fn=lambda *a: None,
        point_batch=True)
    assert set(out) == set(chans)
    for res in out.values():
        assert np.all(np.isfinite(res.ber)) and res.ber.shape == (2,)
    # JAX's names, from its function with its sweep stubbed out
    monkeypatch.setattr(jsweep, "ber_sweep", lambda *a, **k: jsweep.SweepResult(
        np.asarray(snrs, float), np.zeros(2), np.zeros(2)))
    jsweep.cross_channel_sweep(
        lambda c, m: None, None, jax.random.PRNGKey(0), token="TOK", opt=12,
        train_channel="mixRayleigh", mobile=True,
        save_dir=str(tmp_path / "j"), snrs=snrs, test_channels=chans,
        log_fn=lambda *a: None)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    assert tsweep.CROSS_TEST_CHANNELS == jsweep.CROSS_TEST_CHANNELS
    with open(tmp_path / "t" / sorted(os.listdir(tmp_path / "t"))[0]) as f:
        assert f.readline().strip() == "SNR,BER,Loss"
