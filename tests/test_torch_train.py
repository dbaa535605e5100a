"""The port's training slice against the JAX package: the DCCN's init,
the metrics, the optimizer, two fused-route steps end to end on the same
random words, the autograd route, `fit`, and the params archive."""
import os

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


def _adam_leaves(gen):
    """Dense and other leaves of the fused route's kinds: 2-D weights (one
    gradient a transposed view, as the model kernel hands the head's), a
    bias, a strided 1-D gradient (`dfb[0::2]`) and a 0-dim leaf."""
    shapes = {"Dense_a.weight": (6, 5), "Dense_a.bias": (6,),
              "Dense_h.weight": (4, 3), "fft_like.wr": (5, 7),
              "fft_like.br": (7,), "other.scale": ()}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}

    def grads():
        g = {k: 0.1 * torch.randn(s, generator=gen) for k, s in shapes.items()}
        g["Dense_h.weight"] = (0.1 * torch.randn(3, 4, generator=gen)).T
        g["fft_like.br"] = 0.1 * torch.randn(14, generator=gen)[0::2]
        return g
    return params, grads


# (confusion counts or None, reg_coeff): BER 0.25, BER 0 (no counts at
# all: the sum clamped to 1), no L2 term (the autograd route's leaves)
ADAM_CASES = {"ber_quarter": ([[40, 10], [15, 35]], 0.5),
              "ber_zero_total_clamped": ([[0, 0], [0, 0]], 0.5),
              "no_counts": (None, 0.0)}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_fused_adam_ref_matches_foreach_path(case):
    """Five steps across a staircase boundary (lr_decay_steps=2) of
    `fused_adam_ref` against `reg_grads`, `_foreach_add` and
    `Adam.update` (the fused route's path before the kernel): parameters,
    moments and the gradients used, bit for bit."""
    from dl_ofdm_tpu_torch.ops.fused_adam import AdamHyper, fused_adam_ref
    from dl_ofdm_tpu_torch.ops.fused_model import reg_grads
    counts, rc = ADAM_CASES[case]
    gen = torch.Generator().manual_seed(7)
    params, draw = _adam_leaves(gen)
    opt = make_optimizer(TrainConfig(lr_decay_steps=2, lr_decay_rate=0.5))
    want_p, want_s = dict(params), opt.init(params)
    got_p, got_s = dict(params), opt.init(params)
    conf = None if counts is None else torch.tensor(counts)
    ce = torch.tensor(0.6)
    keys = list(params)
    for _ in range(5):
        g = draw()
        if conf is not None:
            _, ber = TM.ber_from_confusion(conf)
            reg_g = reg_grads(want_p, ber, rc)
            g_want = dict(zip(keys, torch._foreach_add(
                [g[k] for k in keys], [reg_g[k] for k in keys])))
        else:
            g_want = g
        upd, want_s = opt.update(g_want, want_s)
        want_p = {k: want_p[k] + upd[k] for k in keys}
        count = got_s["count"]
        hp = AdamHyper(opt.b1, opt.b2, opt.eps, opt.learning_rate(count),
                       count + 1)
        out = fused_adam_ref(keys, [got_p[k] for k in keys],
                             [g[k] for k in keys],
                             [got_s["mu"][k] for k in keys],
                             [got_s["nu"][k] for k in keys], hp, conf, ce,
                             rc, return_grads=True)
        got_p = dict(zip(keys, out.params))
        got_s = {"count": count + 1, "mu": dict(zip(keys, out.mu)),
                 "nu": dict(zip(keys, out.nu))}
        assert (out.scalars is None) == (conf is None)
        for k in keys:
            assert torch.equal(dict(zip(keys, out.grads))[k], g_want[k]), k
            assert torch.equal(got_p[k], want_p[k]), k
            for m in ("mu", "nu"):
                assert torch.equal(got_s[m][k], want_s[m][k]), (m, k)
    assert got_s["count"] == want_s["count"] == 5


@pytest.mark.parametrize("counts", [[[40, 10], [15, 35]], [[0, 0], [0, 0]]])
def test_fused_adam_ref_loss_scalars_match_global_terms(counts):
    """reg, BER, log BER, loss and total loss of `fused_adam_ref` against
    `M.l2_regularization` and `Trainer._global_terms` on the same leaves
    and counts."""
    from dl_ofdm_tpu_torch.ops.fused_adam import AdamHyper, fused_adam_ref
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(reg_coeff=0.5),
                 channel="AWGN", device="cpu")
    params = tt.init_state(torch.Generator().manual_seed(3)).params
    params = {k: v + 0.1 for k, v in params.items()}    # nonzero biases
    keys = list(params)
    conf, ce = torch.tensor(counts), torch.tensor(0.6)
    zeros = [torch.zeros_like(params[k]) for k in keys]
    out = fused_adam_ref(keys, [params[k] for k in keys], zeros, zeros,
                         zeros, AdamHyper(0.9, 0.999, 1e-8, 1e-3, 1), conf,
                         ce, 0.5)
    loss, aux = tt._global_terms(params, ce, conf)
    want = {"reg": TM.l2_regularization(params), "ber": aux["ber"],
            "log_ber": aux["log_ber"], "loss": loss,
            "total_loss": aux["total_loss"]}
    assert set(out.scalars) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(out.scalars[k]), float(v),
                                   rtol=1e-6, err_msg=k)


def test_fused_step_on_cpu_keeps_aux_state_and_inputs():
    """The fused route on the CPU (the L2 term, then `Adam.update`): aux's
    keys, the state's structure, and the step's inputs (the parameters and
    moments it started from) unwritten."""
    n = 4
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=7 * n),
                 channel="ETU", device="cpu")
    state = tt.init_state(torch.Generator().manual_seed(0))
    w0 = {k: v.clone() for k, v in state.params.items()}
    gen = torch.Generator().manual_seed(1)
    snr = torch.full((n,), 5.0)
    s1, a1 = tt.train_step(state, gen, snr, fused=True)
    mu1 = {k: v.clone() for k, v in s1.opt_state["mu"].items()}
    s2, a2 = tt.train_step(s1, gen, snr, fused=True, return_grads=True)
    assert set(a1) == {"ce", "ber", "log_ber", "conf", "total_loss", "loss",
                       "noise_power"}
    assert set(a2) == set(a1) | {"grads"}
    assert set(a2["grads"]) == set(w0)
    for a in (a1, a2):
        assert all(a[k].dim() == 0 and a[k].dtype == torch.float32
                   for k in ("ber", "log_ber", "total_loss", "loss"))
    for s, step in ((s1, 1), (s2, 2)):
        assert s.step == step and s.replicas is None
        assert s.opt_state["count"] == step
        assert set(s.params) == set(s.opt_state["mu"]) == set(
            s.opt_state["nu"]) == set(w0)
        assert all(s.params[k].shape == w0[k].shape for k in w0)
    for k, v in w0.items():
        assert torch.equal(state.params[k], v), k
        assert torch.count_nonzero(state.opt_state["mu"][k]) == 0, k
        assert torch.equal(s1.opt_state["mu"][k], mu1[k]), k
    assert not all(torch.equal(s2.params[k], w0[k]) for k in w0)


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


@pytest.mark.parametrize("grad_clip", [0.0, 0.05])
def test_fused_step_matches_the_composition_it_takes_on_the_cpu(grad_clip):
    """Three fused-route steps on the CPU (`train_step(fused=True,
    words=...)`, through `Adam.step`'s plain path) against the composition
    written out: the synthesize chain's plain version, `_combine_stats`,
    `dccn_fused_grads_ref`, BER and L2 from the counts, `reg_grads` plus
    `_foreach_add`, `Adam.update` and the parameter add.  Parameters, both
    moments and every aux value, bit for bit; with `grad_clip` the
    clipping takes part."""
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    from dl_ofdm_tpu_torch.ops.fused_model import (dccn_fused_grads_ref,
                                                   reg_grads)
    n, rc = 4, 1e-2
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(
        batch_size=7 * n, reg_coeff=rc, grad_clip=grad_clip,
        lr_decay_steps=2, lr_decay_rate=0.5,
        fused_model_matmul_dtype="float32"), channel="ETU", device="cpu")
    spec = tt._fused_synth_spec
    state = tt.init_state(torch.Generator().manual_seed(0))
    params, opt = dict(state.params), tt.optimizer
    opt_state = opt.init(params)
    snr = torch.full((n,), 5.0)
    for step in range(3):
        words = _words(spec, n, jax.random.PRNGKey(20 + step))
        state, aux = tt.train_step(state, None, snr, words=words, fused=True)
        idx, yr, yi, nr, ni, stats = tfs.fused_synthesize(
            spec, n, None, snr, raw=True, words=words)
        _, c, noise_pwr, _ = tfs._combine_stats(stats.sum(0), n)
        grads, ce, conf = dccn_fused_grads_ref(
            tt._fused_model_spec, n, params, yr, yi, nr, ni, c, idx)
        log_ber, ber = TM.ber_from_confusion(conf)
        loss = ce + ber * rc * TM.l2_regularization(params)
        reg_g = reg_grads(params, ber, rc)
        keys = list(grads)
        grads = dict(zip(keys, torch._foreach_add(
            [grads[k] for k in keys], [reg_g[k] for k in keys])))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        assert grad_clip == 0 or float(norm) > grad_clip
        upd, opt_state = opt.update(grads, opt_state)
        params.update(zip(keys, torch._foreach_add(
            [params[k] for k in keys], [upd[k] for k in keys])))
        want = {"ce": ce, "ber": ber, "log_ber": log_ber, "conf": conf,
                "total_loss": loss + log_ber, "loss": loss,
                "noise_power": noise_pwr}
        assert set(aux) == set(want)
        for k, v in want.items():
            assert torch.equal(aux[k], v), (step, k)
        assert set(state.params) == set(params)
        for k in params:
            assert torch.equal(state.params[k], params[k]), (step, k)
            for m in ("mu", "nu"):
                assert torch.equal(state.opt_state[m][k],
                                   opt_state[m][k]), (step, m, k)
        assert state.step == state.opt_state["count"] == step + 1


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


def test_fit_runs_and_routes_default_to_autograd_on_cpu(tmp_path):
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(
        batch_size=42, msg_length=84, snr=5.0, save_dir=str(tmp_path),
        token="T"), channel="AWGN", device="cpu")
    assert not tt._use_fused_model
    state, info = tt.fit(max_epochs=2, log_fn=lambda *a: None)
    assert [h["epoch"] for h in info["history"]] == [0, 1]
    assert state.step == 4 and info["best_epoch"] in (0, 1)
    for h in info["history"]:
        assert np.isfinite([h["train_loss"], h["val_ber"], h["val_loss"]]).all()
    # resume payloads (ROADMAP.md Queue A item 5) and constellation dumps
    # (item 11), which raised before they were ported
    tt.fit(max_epochs=1, ckpt_dir=str(tmp_path / "x"), ckpt_every=1,
           dump_constellations=True, log_fn=lambda *a: None)
    assert os.path.isfile(tmp_path / "x" / "resume" / "state.npz")
    for name in ("txiq", "rxiq"):
        rows = np.loadtxt(tmp_path / f"T_{name}.csv", delimiter=",")
        assert rows.shape == (2048, 2)


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
