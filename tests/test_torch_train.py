"""The port's training slice against the JAX package: the DCCN's init,
the metrics, the optimizer, two fused-route steps end to end on the same
random words, the autograd route, `fit`, and the params archive."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.ops import fused_synth as jfs
from dl_ofdm_tpu.ops.fused_model import reg_grads as jreg_grads
from dl_ofdm_tpu.train import checkpoint as jckpt
from dl_ofdm_tpu.train import metrics as JM
from dl_ofdm_tpu.train.loop import Trainer as JTrainer
from dl_ofdm_tpu.train.loop import make_optimizer as jmake_optimizer
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
from dl_ofdm_tpu_torch.train import checkpoint as tckpt
from dl_ofdm_tpu_torch.train import metrics as TM
from dl_ofdm_tpu_torch.train.loop import Trainer, TrainState, make_optimizer


def _flat(tree):
    return tckpt.params_from_flax(jax.tree.map(np.asarray, tree))


def _assert_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **tol)


def test_dccn_init_matches_flax():
    """lecun_normal kernels (truncated normal, fan-in variance) and zero
    biases, as flax initializes them."""
    jt = JTrainer(JCfg(nbits=1), JTc(), channel="AWGN")
    flax_w = np.asarray(jt.init_state(jax.random.PRNGKey(0)).params[
        "Dense_extract"]["kernel"])
    rx = DCCNReceiver(nbits=1, nfft=64, cp_len=16, nfilter=64,
                      frame_size=320)
    rx.reset_parameters(torch.Generator().manual_seed(0))
    for name, v in rx.state_dict().items():
        if name.endswith("bias") or name.endswith((".br", ".bi")):
            assert torch.count_nonzero(v) == 0, name
    w = rx.Dense_extract.weight
    assert abs(float(w.detach().std()) / float(flax_w.std()) - 1.0) < 0.05
    bound = 2 * (1 / 896) ** 0.5 / 0.87962566
    assert float(w.detach().abs().max()) <= bound + 1e-7


@pytest.mark.parametrize("double_softmax", [False, True])
def test_metrics_match_jax(double_softmax, rng):
    logits = rng.normal(size=(4, 30, 2, 2)).astype(np.float32)
    bits = rng.integers(0, 2, size=(4, 30, 2)).astype(np.int32)
    want = JM.cross_entropy(jnp.asarray(logits), jnp.asarray(bits),
                            double_softmax)
    got = TM.cross_entropy(torch.from_numpy(logits), torch.from_numpy(bits),
                           double_softmax)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    pred = (logits[..., 1] > logits[..., 0]).astype(np.int32)
    jconf = JM.confusion_matrix(jnp.asarray(bits), jnp.asarray(pred))
    tconf = TM.confusion_matrix(torch.from_numpy(bits), torch.from_numpy(pred))
    np.testing.assert_array_equal(tconf.numpy(), np.asarray(jconf))
    for a, b in zip(TM.ber_from_confusion(tconf), JM.ber_from_confusion(jconf)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_l2_regularization_matches_jax():
    jt = JTrainer(JCfg(nbits=2), JTc(), channel="AWGN")
    params = jt.init_state(jax.random.PRNGKey(1)).params
    params = jax.tree.map(lambda v: v + 0.1, params)     # nonzero biases
    np.testing.assert_allclose(float(TM.l2_regularization(_flat(params))),
                               float(JM.l2_regularization(params)), rtol=1e-6)


@pytest.mark.parametrize("grad_clip", [0.0, 0.05])
def test_optimizer_matches_optax(grad_clip, rng):
    """Three Adam steps across a staircase boundary (lr_decay_steps=2), with
    global-norm clipping off and on."""
    tc = TrainConfig(lr_decay_steps=2, lr_decay_rate=0.5, grad_clip=grad_clip)
    jopt = jmake_optimizer(JTc(lr_decay_steps=2, lr_decay_rate=0.5,
                               grad_clip=grad_clip))
    topt = make_optimizer(tc)
    params = {"a.weight": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jst, tst = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()}
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tst = topt.update({k: torch.from_numpy(v)
                                 for k, v in g.items()}, tst)
        tp = {k: v + tupd[k] for k, v in tp.items()}
        _assert_close({k: v.numpy() for k, v in tp.items()}, jp,
                      rtol=1e-6, atol=1e-7)


def _jax_step(jt, params, opt_state, key, snr, rc):
    """JAX's fused step on the CPU: emulate -> (combine inside) -> autodiff
    of the CE on rx -> reg_grads -> optax, jitted as one program."""
    spec = jt._fused_synth_spec
    n = snr.shape[0]

    @jax.jit
    def step(params, opt_state, key, snr):
        bits, rx, _, _ = jfs.emulate_fused_synthesize(spec, n, key, snr,
                                                      debug=True)

        def ce_fn(p):
            return JM.cross_entropy(jt.model.apply({"params": p}, rx)[0],
                                    bits)

        grads = jax.grad(ce_fn)(params)
        logits = jt.model.apply({"params": params}, rx)[0]
        _, ber = JM.ber_from_confusion(
            JM.confusion_matrix(bits, JM.bit_predictions(logits)))
        grads = jax.tree.map(lambda g, r: g + r, grads,
                             jreg_grads(params, ber, rc))
        upd, opt_state = jt.optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, grads

    return step(params, opt_state, key, snr)


def _words(spec, n, key):
    kb, kt1, kt2, kn1, kn2, _, _ = jax.random.split(key, 7)

    def bits(k, shape):
        return np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(
            np.int64)

    return {"idx": bits(kb, (n, spec.frame_size)),
            "tap_u1": bits(kt1, (n, spec.taps)),
            "tap_u2": bits(kt2, (n, spec.taps)),
            "noise_u1": bits(kn1, (n, spec.length)),
            "noise_u2": bits(kn2, (n, spec.length))}


def test_two_fused_steps_match_jax():
    """The slice end to end: two fused-route steps (plain versions of both
    kernels) from the same params on the same words as JAX's emulated
    synthesize, its combine, autodiff, reg_grads and optax."""
    n, rc = 6, 1e-2       # a large reg_coeff makes the L2 term count
    jcfg, jtc = JCfg(nbits=2), JTc(batch_size=7 * n, snr=4.0, reg_coeff=rc,
                                   fused_model_matmul_dtype="float32")
    jt = JTrainer(jcfg, jtc, channel="mixAll")
    jt._fused_synth_spec = jfs.build_synth_spec(
        jt.plan, [None if jt.channel._passthrough[i] else p
                  for i, p in enumerate(jt.channel.profiles)], 2)
    params = jt.init_state(jax.random.PRNGKey(3)).params
    opt_state = jt.optimizer.init(params)
    tt = Trainer(OFDMConfig(nbits=2), TrainConfig(
        batch_size=7 * n, snr=4.0, reg_coeff=rc,
        fused_model_matmul_dtype="float32"), channel="mixAll", device="cpu")
    assert tt._fused_model_spec is not None and not tt._use_fused_model
    tparams = _flat(params)
    state = TrainState(tparams, tt.optimizer.init(tparams), 0)
    snr = np.full(n, 4.0, np.float32)
    for step in range(2):
        key = jax.random.PRNGKey(100 + step)
        params, opt_state, jgrads = _jax_step(jt, params, opt_state, key,
                                              jnp.asarray(snr), rc)
        state, aux = tt.train_step(
            state, None, torch.from_numpy(snr),
            words=_words(tt._fused_synth_spec, n, key), fused=True,
            return_grads=True)
        _assert_close({k: v.numpy() for k, v in aux["grads"].items()},
                      _flat(jgrads), rtol=2e-4, atol=1e-7)
        # Adam divides by sqrt(nu) + 1e-8: a gradient entry near 1e-8,
        # where the two sides' float32 sums differ in their last digits,
        # can move by a few % of the learning rate (1e-3); every other
        # entry agrees to 1e-6
        got = {k: v.numpy() for k, v in state.params.items()}
        want = _flat(params)
        _assert_close(got, want, rtol=0, atol=1e-4)
        far = sum(int((np.abs(got[k] - want[k].numpy()) > 1e-6).sum())
                  for k in got)
        assert far <= 1e-4 * sum(v.size for v in got.values())
    assert state.step == 2 and state.opt_state["count"] == 2


def test_routes_agree_on_cpu():
    """The autograd route and the fused route (plain versions) give the
    same gradients on the same words, L2 term included."""
    n = 5
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(
        batch_size=7 * n, reg_coeff=1e-2,
        fused_model_matmul_dtype="float32"), channel="ETU", device="cpu")
    state = tt.init_state(torch.Generator().manual_seed(0))
    words = _words(tt._fused_synth_spec, n, jax.random.PRNGKey(7))
    snr = torch.full((n,), 6.0)
    outs = [tt.train_step(state, None, snr, words=words, fused=f,
                          return_grads=True) for f in (True, False)]
    (s_f, a_f), (s_a, a_a) = outs
    _assert_close({k: v.numpy() for k, v in a_f["grads"].items()},
                  {k: v.numpy() for k, v in a_a["grads"].items()},
                  rtol=2e-4, atol=1e-7)
    for key in ("ce", "ber", "loss", "total_loss"):
        np.testing.assert_allclose(float(a_f[key]), float(a_a[key]),
                                   rtol=1e-5)
    assert torch.equal(a_f["conf"], a_a["conf"])


def test_fit_runs_and_routes_default_to_autograd_on_cpu():
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(
        batch_size=42, msg_length=84, snr=5.0), channel="AWGN", device="cpu")
    assert not tt._use_fused_model
    state, info = tt.fit(max_epochs=2, log_fn=lambda *a: None)
    assert [h["epoch"] for h in info["history"]] == [0, 1]
    assert state.step == 4 and info["best_epoch"] in (0, 1)
    for h in info["history"]:
        assert np.isfinite([h["train_loss"], h["val_ber"], h["val_loss"]]).all()
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        tt.fit(max_epochs=1, ckpt_dir="x")
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        tt.fit(max_epochs=1, dump_constellations=True)


@pytest.mark.parametrize("ber", [0.5, 0.05, 1e-3, 1e-5])
def test_ideal_batch_frames_matches_jax(ber):
    jt = JTrainer(JCfg(nbits=2), JTc(batch_size=700), channel="AWGN")
    tt = Trainer(OFDMConfig(nbits=2), TrainConfig(batch_size=700),
                 channel="AWGN", device="cpu")
    assert tt._ideal_batch_frames(ber) == jt._ideal_batch_frames(ber)


def test_params_round_trip_and_archive(tmp_path):
    jt = JTrainer(JCfg(nbits=4), JTc(), channel="AWGN")
    tree = jax.tree.map(np.asarray, jt.init_state(
        jax.random.PRNGKey(2)).params)
    back = tckpt.params_to_flax(tckpt.params_from_flax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    path = tckpt.export_params_npz(str(tmp_path / "arm.npz"),
                                   tckpt.params_from_flax(tree))
    loaded = jckpt.load_params_npz(path)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
