"""The port's Jakes-Doppler (mobile) training path against the JAX
package: the fused synthesize spec's Doppler fields, its plain version on
the very words JAX's `emulate_fused_synthesize` draws (Doppler rows and
the true channel), one fused-route step of a mobile `Trainer` end to end,
and the mobile trainer's plain data plane through `train_step`,
`eval_step`, `fit` and `ber_sweep`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.ops import fused_synth as jfs
from dl_ofdm_tpu.ops.fused_model import reg_grads as jreg_grads
from dl_ofdm_tpu.train import metrics as JM
from dl_ofdm_tpu.train.loop import Trainer as JTrainer
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
from dl_ofdm_tpu_torch.ops import fused_synth as tfs
from dl_ofdm_tpu_torch.train import checkpoint as tckpt
from dl_ofdm_tpu_torch.train.loop import Trainer, TrainState

# jitted: one compile of the whole emulator instead of one per eager op
_emulate = jax.jit(jfs.emulate_fused_synthesize, static_argnums=(0, 1, 4, 5))


def _trainers(channel, nbits, **tc):
    jt = JTrainer(JCfg(nbits=nbits), JTc(**tc), channel=channel, mobile=True)
    tt = Trainer(OFDMConfig(nbits=nbits), TrainConfig(**tc), channel=channel,
                 mobile=True, device="cpu")
    return jt, tt


@pytest.mark.parametrize("channel,nbits,cycle", [
    ("mixRayleigh", 1, [i % 3 == 0 for i in range(12)]),
    ("mixAll", 2, [i % 4 == 0 and i % 5 != 0 for i in range(20)]),
    ("ETU", 4, [True])])
def test_mobile_spec_matches_jax(channel, nbits, cycle):
    jt, tt = _trainers(channel, nbits)
    js, ts = jt._fused_synth_spec, tt._fused_synth_spec
    assert ts.mobile and js.mobile
    assert ts.dop_cycle.tolist() == js.dop_cycle.tolist() == cycle
    for name in ("nfft", "t_sym", "taps", "fir_u", "off_u", "n_classes"):
        assert getattr(ts, name) == getattr(js, name), name
    for name in ("fd_cls", "jakes_base_r", "jakes_base_i", "hb_r", "hb_i",
                 "hbias_cls"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    np.testing.assert_array_equal(tfs._sym_window_masks(ts),
                                  jfs._sym_window_masks(js))
    if channel == "mixRayleigh":
        assert ts.fd_cls.tolist() == [5.0, 300.0, 70.0, 5.0]
        assert abs(ts.t_sym - 80 / 0.96e6) < 1e-15


def test_static_trainer_spec_is_not_mobile():
    jt = JTrainer(JCfg(nbits=1), JTc(), channel="mixRayleigh")
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(), channel="mixRayleigh",
                 device="cpu")
    assert not tt._fused_synth_spec.mobile and not jt._fused_synth_spec.mobile
    np.testing.assert_array_equal(tt._fused_synth_spec.hb_r,
                                  jt._fused_synth_spec.hb_r)


def _jax_words(js, n, key):
    """Every word `emulate_fused_synthesize` draws from `key`, the Jakes
    phases' included (kj1, kj2)."""
    kb, kt1, kt2, kn1, kn2, kj1, kj2 = jax.random.split(key, 7)

    def bits(k, shape):
        return np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(
            np.int64)

    words = {"idx": bits(kb, (n, js.frame_size)),
             "tap_u1": bits(kt1, (n, js.taps)),
             "tap_u2": bits(kt2, (n, js.taps)),
             "noise_u1": bits(kn1, (n, js.length)),
             "noise_u2": bits(kn2, (n, js.length))}
    if js.mobile:
        sstaps = js.jakes_base_r.size
        words.update(jakes_u1=bits(kj1, (n, sstaps)),
                     jakes_u2=bits(kj2, (n, sstaps)))
    return words


@pytest.mark.parametrize("channel,nbits,n,want_h", [
    ("mixRayleigh", 1, 12, False), ("mixAll", 2, 20, True),
    ("ETU", 3, 12, True)])
def test_plain_version_matches_jax_emulator(channel, nbits, n, want_h):
    jt, tt = _trainers(channel, nbits)
    js, ts = jt._fused_synth_spec, tt._fused_synth_spec
    key = jax.random.PRNGKey(nbits + 40)
    snr = np.linspace(0.0, 12.0, n).astype(np.float32)
    jout = _emulate(js, n, key, jnp.asarray(snr), True, want_h)
    words = _jax_words(js, n, key)
    std = tfs.noise_std(torch.from_numpy(snr))
    got = tfs.fused_synthesize_ref(ts, n, std, words=words, want_h=want_h)
    for a, w in zip(got[1:5], jout[-1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5)
    out = tfs.fused_synthesize(ts, n, None, torch.from_numpy(snr),
                               words=words, want_h=want_h)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]),
                               atol=1e-5)
    np.testing.assert_allclose(float(out[2]), float(jout[2]), rtol=1e-5)
    if want_h:
        assert got[6].shape == (n, 7, 64, 2)
        np.testing.assert_allclose(out[3].numpy(), np.asarray(jout[3]),
                                   atol=1e-5)
    # Doppler rows differ from what the static path gives on the same words
    dop = tfs.doppler_rows(ts, n)
    static = tfs.fused_synthesize_ref(
        tfs.build_synth_spec(tt.plan, [None if tt.channel._passthrough[i]
                                       else p for i, p in
                                       enumerate(tt.channel.profiles)],
                             nbits), n, std, words=words)
    moved = (static[1] - got[1]).abs().amax(1) > 1e-6
    assert moved.tolist() == dop.tolist()


def test_static_want_h_matches_jax_emulator():
    """want_h on a static mix (mixAll: AWGN rows' H is 1): [B, nfft, 2]
    from the kernel's plain version, broadcast over symbols by the wrapper."""
    jt = JTrainer(JCfg(nbits=2), JTc(), channel="mixAll")
    tt = Trainer(OFDMConfig(nbits=2), TrainConfig(), channel="mixAll",
                 device="cpu")
    js, ts = jt._fused_synth_spec, tt._fused_synth_spec
    n, key = 7, jax.random.PRNGKey(5)
    snr = np.full(n, 3.0, np.float32)
    jout = _emulate(js, n, key, jnp.asarray(snr), False, True)
    words = _jax_words(js, n, key)
    raw = tfs.fused_synthesize(ts, n, None, torch.from_numpy(snr),
                               words=words, want_h=True, raw=True)
    assert raw[6].shape == (n, 64, 2)
    out = tfs.fused_synthesize(ts, n, None, torch.from_numpy(snr),
                               words=words, want_h=True)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(jout[3]), atol=1e-5)
    np.testing.assert_array_equal(out[3][0].numpy(), np.stack(
        [np.ones((7, 64)), np.zeros((7, 64))], -1).astype(np.float32))


def test_doppler_draws_use_streams_5_and_6():
    """The plain version's own words: static rows keep their draws bit for
    bit, the Jakes phases come from streams 5 and 6, SS*taps words a row."""
    _, tt = _trainers("mixRayleigh", 1)
    ts = tt._fused_synth_spec
    seeds = torch.tensor([7, 2**31 + 3], dtype=torch.int64)
    words = tfs.draw_words(ts, 6, seeds)
    assert words["jakes_u1"].shape == (6, 48 * 9)
    rows = torch.arange(6)
    assert torch.equal(words["jakes_u2"], tfs.philox_words(seeds, rows, 6,
                                                           48 * 9))
    static = tfs.draw_words(dataclasses.replace(ts, mobile=False), 6, seeds)
    for k, v in static.items():
        assert torch.equal(words[k], v), k


def _jax_step(jt, params, opt_state, key, snr, rc):
    """JAX's fused step on the CPU: emulate -> autodiff of the CE on rx ->
    reg_grads -> optax, jitted as one program."""
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


def test_mobile_fused_step_matches_jax():
    """One fused-route step of the mobile trainer (plain versions of both
    kernels) against JAX's fused chain on the same words, at the
    tolerances of `test_torch_train.py::test_two_fused_steps_match_jax`."""
    n, rc = 12, 1e-2
    tc = dict(batch_size=7 * n, snr=4.0, reg_coeff=rc,
              fused_model_matmul_dtype="float32")
    jt, tt = _trainers("mixRayleigh", 1, **tc)
    assert tt._fused_model_spec is not None and not tt._use_fused_model
    params = jt.init_state(jax.random.PRNGKey(3)).params
    opt_state = jt.optimizer.init(params)
    tparams = tckpt.params_from_flax(jax.tree.map(np.asarray, params))
    state = TrainState(tparams, tt.optimizer.init(tparams), 0)
    snr = np.full(n, 4.0, np.float32)
    key = jax.random.PRNGKey(100)
    params, opt_state, jgrads = _jax_step(jt, params, opt_state, key,
                                          jnp.asarray(snr), rc)
    state, aux = tt.train_step(
        state, None, torch.from_numpy(snr),
        words=_jax_words(jt._fused_synth_spec, n, key), fused=True,
        return_grads=True)
    want_g = tckpt.params_from_flax(jax.tree.map(np.asarray, jgrads))
    want_p = tckpt.params_from_flax(jax.tree.map(np.asarray, params))
    assert set(aux["grads"]) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(aux["grads"][k].numpy(), want_g[k].numpy(),
                                   rtol=2e-4, atol=1e-7, err_msg=k)
    far = 0
    for k in want_p:
        got = state.params[k].numpy()
        np.testing.assert_allclose(got, want_p[k].numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
        far += int((np.abs(got - want_p[k].numpy()) > 1e-6).sum())
    assert far <= 1e-4 * sum(v.numel() for v in want_p.values())
    assert state.step == 1


def test_mobile_trainer_trains_and_serves_on_cpu():
    """bench.py's configuration on mixRayleigh mobile, cut to a few frames:
    both routes of `train_step`, `eval_step`, `fit` and `ber_sweep` run on
    the CPU and give finite numbers."""
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(
        batch_size=7 * 12, msg_length=7 * 24, snr=5.0), channel="mixRayleigh",
        mobile=True, device="cpu")
    assert tt.channel.has_doppler and tt.channel.mix
    gen = torch.Generator().manual_seed(0)
    state = tt.init_state(gen)
    snr = torch.full((12,), 5.0)
    for fused in (False, True):
        state, aux = tt.train_step(state, gen, snr, fused=fused)
        assert torch.isfinite(aux["loss"]) and int(aux["conf"].sum()) == 12 * 320
    val = tt.eval_step(state.params, gen, 6, torch.full((6,), 5.0))
    assert torch.isfinite(val["ce"])
    _, info = tt.fit(max_epochs=1, log_fn=lambda *a: None, grow_batch=False)
    assert np.isfinite(info["history"][0]["train_loss"])
    res = ber_sweep(tt, gen, snrs=[0, 10, 20], frames_per_point=24,
                    batch_frames=12, log_fn=lambda *a: None)
    assert np.all(np.isfinite(res.ber)) and np.all(res.ber <= 1.0)


def test_sweep_reaches_the_doppler_channel(monkeypatch):
    """`ber_sweep` needs no change for mobile trainers: its frames go
    through `trainer.synthesize`, whose channel takes the Jakes path on the
    Doppler frames."""
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(), channel="mixRayleigh",
                 mobile=True, device="cpu")
    seen = []
    call = type(tt.channel).__call__

    def spy(ch, tx, generator=None, **kw):
        out = call(ch, tx, generator, **kw)
        seen.append(out.h_freq)
        return out

    monkeypatch.setattr(type(tt.channel), "__call__", spy)
    ber_sweep(tt, torch.Generator().manual_seed(1), snrs=[5],
              frames_per_point=6, batch_frames=6, log_fn=lambda *a: None,
              point_batch=True)
    h = seen[0]
    assert h.shape == (6, 7, 64, 2)
    assert float((h[0] - h[0, :1]).abs().max()) > 0      # frame 0: Doppler
    assert float((h[1] - h[1, :1]).abs().max()) == 0     # frame 1: static
