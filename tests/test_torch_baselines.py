"""The port's classical baselines (`dl_ofdm_tpu_torch/baselines/`) against
the JAX package's (`dl_ofdm_tpu/baselines/`), on the CPU, at a few frames:

  * `pdp` and `interp` (host NumPy copies): equal to 1e-12, the 'block'
    pilot scheme's nearest-pilot fallback included;
  * `cmatvec_iq` and `solve_iq`: within 1e-5 of the largest value;
  * the MATLAB Gray tables bit-equal, `demod_nearest` equal indices;
  * `MatlabLink`'s stages on JAX's own draws (symbols, tap gains, Jakes
    phases, noise) injected into the port: within 1e-5 of the largest
    value, on EVA and ETU, static, symbol-averaged mobile and per-sample;
  * `estimate` for ids 1-10: within 1e-4 of the largest value; ids 5-6
    (and `cp_enhanced_frame`) within 1e-3, because their ill-conditioned
    L x L solves amplify float32 rounding.  In the first symbol the
    previous symbol's samples are zero, so Xcp is triangular and
    Xcp^H Xcp + 1e-9 I has a condition number up to ~1e9: float32
    rounding in another order moves its solution by O(1) in both
    packages.  That symbol is held to JAX in float64 (`jax.enable_x64`
    and float64 tensors: within 1e-6), the other six in float32 (1e-3);
  * `run_point` on JAX's draws: bit and symbol errors within 1 of JAX's
    per 10,000 bits (ids 5-6: within 5, for the same reason: a frame
    whose first symbol is ill-conditioned decodes differently in the two
    packages, by up to a symbol's bits, so these two run 512 frames,
    enough for a rate: at 128 frames one of three keys differed by 15 per
    10,000 bits, at 512 frames every key by 0.4-2.0);
  * `run_benchmark`'s files: names, shapes and bytes equal to JAX's when
    both are fed the same BER arrays; the float32 setting restored.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.baselines import classical_rx as jrx
from dl_ofdm_tpu.baselines import estimators as jest
from dl_ofdm_tpu.baselines import interp as jinterp
from dl_ofdm_tpu.baselines import pdp as jpdp
from dl_ofdm_tpu.baselines.cp_enhanced import cp_enhanced_frame as jcp
from dl_ofdm_tpu.baselines.matlab_link import MatlabLink as JLink
from dl_ofdm_tpu.channel.doppler import SS
from dl_ofdm_tpu.config import OFDMConfig as JCfg
from dl_ofdm_tpu.ofdm import constellation as jcon
from dl_ofdm_tpu.ofdm.plan import build_plan as jbuild
from dl_ofdm_tpu.ops import cfloat as jcf
from dl_ofdm_tpu_torch.baselines import classical_rx as trx
from dl_ofdm_tpu_torch.baselines import estimators as torch_est
from dl_ofdm_tpu_torch.baselines import interp as tinterp
from dl_ofdm_tpu_torch.baselines import pdp as tpdp
from dl_ofdm_tpu_torch.baselines.cp_enhanced import cp_enhanced_frame as tcp
from dl_ofdm_tpu_torch.baselines.matlab_link import MatlabLink as TLink
from dl_ofdm_tpu_torch.config import OFDMConfig as TCfg
from dl_ofdm_tpu_torch.ofdm import constellation as tcon
from dl_ofdm_tpu_torch.ofdm.plan import build_plan as tbuild
from dl_ofdm_tpu_torch.ops import cfloat as tcf

FRAMES = 16
FRAMES_CP = 512            # ids 5-6 (see the module docstring)
SNR_DB = 10.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: many small operations, which torch's
    thread pool slows down when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, rel: float):
    """max |got - want| within `rel` of max |want|."""
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _plans(**kw):
    return jbuild(JCfg(**kw)), tbuild(TCfg(**kw))


# -- pdp, interp ---------------------------------------------------------------

@pytest.mark.parametrize("channel", ["eva", "etu", "epa", "custom"])
def test_pdp_equal(channel):
    from dl_ofdm_tpu.channel.profiles import get_profile
    prof = get_profile(channel, 0.96e6, weighting="physical")
    args = (prof.tap_delay_ns * 1e-9, prof.tap_pow_db)
    assert tpdp.rms_delay_spread(*args) == jpdp.rms_delay_spread(*args)
    trms = jpdp.rms_delay_spread(*args)[0] * 0.96e6
    for uniform in (True, False):
        want = jpdp.mmse_pdp(prof.n_taps, 64, trms, uniform)
        got = tpdp.mmse_pdp(prof.n_taps, 64, trms, uniform)
        assert got.dtype == np.complex128
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("pilot", ["lte", "scattered", "comb", "block"])
def test_interp_operators_equal(pilot):
    """Both operators on each pilot scheme's geometry; 'block' puts every
    pilot in one symbol, where Delaunay fails and the nearest pilot
    stands in."""
    jplan, _ = _plans(pilot=pilot)
    pilot_xy = np.stack([jplan.pilot_freq + 1, jplan.pilot_sym + 1],
                        -1).astype(np.float64)
    gm, gt = np.meshgrid(np.arange(1, 65), np.arange(1, 8))
    eval_xy = np.stack([gm.ravel(), gt.ravel()], -1).astype(np.float64)
    for name in ("biharmonic_operator", "linear_operator"):
        want = getattr(jinterp, name)(pilot_xy, eval_xy)
        got = getattr(tinterp, name)(pilot_xy, eval_xy)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if pilot == "block":
        a = tinterp.linear_operator(pilot_xy, eval_xy)
        assert np.all(a.sum(1) == 1) and np.all(a.max(1) == 1)


def test_interp_random_points_equal(rng):
    pts = rng.uniform(0, 10, (15, 2))
    evals = rng.uniform(-1, 11, (60, 2))
    for name in ("biharmonic_operator", "linear_operator"):
        np.testing.assert_allclose(getattr(tinterp, name)(pts, evals),
                                   getattr(jinterp, name)(pts, evals),
                                   rtol=0, atol=1e-12)


# -- cfloat, constellation ------------------------------------------------------

def test_cmatvec_iq_matches_jax(rng):
    w = rng.normal(size=(64, 64, 2)).astype(np.float32)
    x = rng.normal(size=(5, 7, 64, 2)).astype(np.float32)
    _close(tcf.cmatvec_iq(_t(w), _t(x)), jcf.cmatvec_iq(w, x), 1e-5)


@pytest.mark.parametrize("n", [4, 16])
def test_solve_iq_matches_jax_and_numpy(rng, n):
    a = rng.normal(size=(12, n, n, 2)).astype(np.float32)
    a[..., 0] += n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(12, n, 2)).astype(np.float32)
    got = tcf.solve_iq(_t(a), _t(b))
    _close(got, jcf.solve_iq(a, b), 1e-5)
    want = np.linalg.solve(a[..., 0] + 1j * a[..., 1],
                           (b[..., 0] + 1j * b[..., 1])[..., None])[..., 0]
    _close(got, np.stack([want.real, want.imag], -1), 1e-5)


def test_solve_iq_singular_gives_non_finite_without_raising():
    a = torch.zeros(2, 3, 3, 2)
    out = tcf.solve_iq(a, torch.ones(2, 3, 2))
    assert out.shape == (2, 3, 2) and not torch.isfinite(out).all()


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_matlab_table_bit_equal_and_demod_nearest(m, rng):
    want = jcon._matlab_table_np(m)
    got = tcon._matlab_table_np(m)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    table = tcon.matlab_gray_table(m)
    jtab = np.asarray(jcon.matlab_gray_table(m))
    assert np.array_equal(table[:, 0].numpy(), jtab.real)
    assert np.array_equal(table[:, 1].numpy(), jtab.imag)
    y = (rng.normal(size=(50, 40, 2)) * 2).astype(np.float32)
    idx = tcon.demod_nearest(_t(y), table)
    jidx = jcon.demod_nearest(jnp.asarray(y[..., 0] + 1j * y[..., 1]),
                              jcon.matlab_gray_table(m))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


# -- the link on JAX's draws ----------------------------------------------------

def _fade_draws(jlink: JLink, key, b: int) -> dict:
    """The draws JAX's `fade(key, ...)` makes, as the port's keywords."""
    p = jlink.profile
    if jlink.channel == "awgn":
        return {}
    if jlink.fd > 0.1:
        kr, ki = jax.random.split(key)
        return {"theta": tuple(
            _t(jax.random.uniform(k, (b, SS, p.n_taps), minval=0.0,
                                  maxval=2 * np.pi, dtype=jnp.float32))
            for k in (kr, ki))}
    return {"z": _t(jax.random.normal(key, (b, p.n_taps, 2))
                    / np.sqrt(2.0))}


def _batch_draws(jlink: JLink, k, nb: int) -> dict:
    """What JAX's `one_batch(k, ...)` draws (`classical_rx.py:53-56`)."""
    k1, k2, k3 = jax.random.split(k, 3)
    plan = jlink.plan
    sym = jax.random.randint(k1, (nb, plan.frame_size), 0, jlink.m)
    noise = jax.random.normal(
        k3, (nb, plan.nsymbol, plan.samples_per_symbol, 2))
    return {"sym_idx": _t(sym).long(), "unit_noise": _t(noise),
            **_fade_draws(jlink, k2, nb)}


def _point_draws(jlink: JLink, key, eq_idx: int, n_frames: int,
                 batch: int = 2000) -> list:
    """Every draw of JAX's `run_point(key, ...)`, in its order
    (`classical_rx.py:94-109`)."""
    out = []
    if eq_idx == 10:
        kf1, kf2, key = jax.random.split(key, 3)
        nb = min(batch, n_frames)
        sym = jax.random.randint(kf1, (nb, jlink.plan.frame_size), 0,
                                 jlink.m)
        out.append({"sym_idx": _t(sym).long(),
                    **_fade_draws(jlink, kf2, nb)})
    remaining = n_frames
    while remaining > 0:
        nb = min(batch, remaining)
        key, k = jax.random.split(key)
        out.append(_batch_draws(jlink, k, nb))
        remaining -= nb
    return out


def _jax_stages(jlink: JLink):
    """JAX's link stages, each jitted (one compile instead of one per
    operation): transmit(key, b), fade(key, wave) -> (y, g),
    awgn_measured(key, y, snr), rx_front(y)."""
    return (jax.jit(jlink.transmit, static_argnums=1),
            jax.jit(lambda k, w: (lambda o: (o.y, o.g))(jlink.fade(k, w))),
            jax.jit(jlink.awgn_measured), jax.jit(jlink.rx_front))


def _links(channel, m=2, mobile=False, per_sample=False, **cfg):
    jplan, tplan = _plans(**cfg)
    return (JLink(jplan, m, channel, mobile, per_sample=per_sample),
            TLink(tplan, m, channel, mobile, per_sample=per_sample,
                  device="cpu"))


@pytest.mark.parametrize("channel,m,mobile,per_sample", [
    ("eva", 2, False, False), ("etu", 16, False, False),
    ("eva", 4, True, False), ("etu", 8, True, True),
    ("awgn", 16, False, False)])
def test_link_stages_match_jax(channel, m, mobile, per_sample):
    jlink, tlink = _links(channel, m, mobile, per_sample)
    d = _batch_draws(jlink, jax.random.PRNGKey(3), 6)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    transmit, fade, awgn, rx_front = _jax_stages(jlink)
    jidx, jwave = transmit(k1, 6)
    idx, wave = tlink.transmit(6, sym_idx=d["sym_idx"])
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(wave, jwave, 1e-5)
    jy, jg = fade(k2, jwave)
    ch = tlink.fade(_t(jwave), z=d.get("z"), theta=d.get("theta"))
    _close(ch.y, jy, 1e-5)
    _close(ch.g, jg, 1e-5)
    jy = awgn(k3, jy, SNR_DB)
    y = tlink.awgn_measured(_t(ch.y), SNR_DB, unit_noise=d["unit_noise"])
    _close(y, jy, 1e-5)
    jrxf = rx_front(jy)
    rxf = tlink.rx_front(_t(jy))
    _close(rxf, jrxf, 1e-5)
    _close(tlink.pilot_ls(_t(jrxf)), jlink.pilot_ls(jrxf), 1e-5)
    assert np.array_equal(tlink.demodulate(_t(jrxf)).numpy(),
                          np.asarray(jlink.demodulate(jrxf)))
    be, se, tb, ts = tlink.count_errors(idx, tlink.demodulate(_t(jrxf)))
    want = jlink.count_errors(jidx, jlink.demodulate(jrxf))
    assert (int(be), int(se), tb, ts) == tuple(int(v) for v in want)


def test_link_draws_from_a_generator():
    """Without injected draws the link draws from the caller's generator:
    the same seed gives the same frames, and the noise has the measured
    power."""
    _, tlink = _links("eva", 4, mobile=True)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        _, wave = tlink.transmit(40, g)
        y = tlink.fade(wave, g).y
        outs.append(tlink.awgn_measured(y, 0.0, g))
    assert torch.equal(outs[0], outs[1])
    p_sig = float(tcf.abs2_iq(y).mean())
    p_noise = float(tcf.abs2_iq(outs[0] - y).mean())
    assert p_noise == pytest.approx(p_sig, rel=0.05)


# -- estimators -------------------------------------------------------------

@pytest.fixture(scope="module")
def eva_batch():
    """One EVA batch of JAX's link, its receiver inputs as numpy arrays,
    and both packages' contexts."""
    jlink, _ = _links("eva")
    transmit, fade, awgn, rx_front = _jax_stages(jlink)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    y, g = fade(k2, transmit(k1, 8)[1])
    y = awgn(k3, y, 15.0)
    rxf = rx_front(y)
    arrays = {n: np.asarray(v) for n, v in (
        ("rx", rxf), ("hhat", jlink.pilot_ls(rxf)), ("g", g), ("y", y))}
    return (arrays, jrx.get_context(jlink.plan, "eva"),
            trx.get_context(tbuild(TCfg()), "eva", "cpu"))


@pytest.mark.parametrize("eq_idx", range(1, 11))
def test_estimate_matches_jax(eva_batch, eq_idx):
    a, jctx, tctx = eva_batch
    snr_lin, beta = 10 ** 1.5, 1.0
    jw = tw = None
    if eq_idx in (8, 9):
        rhh = jctx.rhh_uni if eq_idx == 8 else jctx.rhh_exp
        jw = jest.precompute_prior_w(rhh, beta, snr_lin)
        tw = torch_est.precompute_prior_w(rhh, beta, snr_lin, "cpu")
    if eq_idx == 10:
        jw = jest.precompute_longterm_w(jnp.asarray(a["g"]), beta, snr_lin)
        tw = torch_est.precompute_longterm_w(_t(a["g"]), beta, snr_lin)
    if jw is not None:
        _close(tw, jw, 1e-6)
    jg, jx = jest.estimate(eq_idx, jctx, *(jnp.asarray(a[n]) for n in
                                          ("rx", "hhat", "g")),
                           snr_lin, beta, w_prior=jw,
                           y_time=jnp.asarray(a["y"]))
    tg, tx = torch_est.estimate(eq_idx, tctx, *(_t(a[n]) for n in
                                           ("rx", "hhat", "g")),
                            snr_lin, beta, w_prior=tw, y_time=_t(a["y"]))
    assert (tx is None) == (jx is None)
    if eq_idx not in (5, 6):
        _close(tg, jg, 1e-4)
        return
    # symbols 1-6 in float32; the first in float64 (the module docstring)
    for got, want in ((tg, jg), (tx, jx)):
        _close(got[:, 1:], np.asarray(want)[:, 1:], 1e-3)


def _cp_inputs(source: str, rng):
    """(rx, g0, y) float64: random grids, or an EVA batch of JAX's link
    with estimator 5's initial channel (the symbol mean of the spline
    estimate)."""
    if source == "random":
        return tuple(rng.normal(size=(5, 7, n, 2)) for n in (64, 64, 80))
    jlink, _ = _links("eva")
    transmit, fade, awgn, rx_front = _jax_stages(jlink)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(8), 3)
    y = awgn(k3, fade(k2, transmit(k1, 6)[1])[0], 20.0)
    rxf = rx_front(y)
    hls = jest._interp_grid(jrx.get_context(jlink.plan, "eva").a_spline,
                            jlink.pilot_ls(rxf), 7, 64)
    g0 = jnp.broadcast_to(hls.mean(axis=1, keepdims=True), hls.shape)
    return tuple(np.asarray(v, np.float64) for v in (rxf, g0, y))


@pytest.mark.parametrize("source", ["random", "link"])
def test_cp_enhanced_frame_matches_jax(source, rng):
    """The data grid and the re-estimated channel: in float64 every
    symbol within 1e-6 of JAX's, in float32 symbols 1-6 within 1e-3 (the
    module docstring says why the first is not held in float32)."""
    ins = _cp_inputs(source, rng)
    with jax.enable_x64(True):
        want64 = [np.asarray(v) for v in jcp(*map(jnp.asarray, ins), 16)]
    assert want64[0].dtype == np.float64
    got64 = tcp(*map(_t, ins), 16)
    for got, want in zip(got64, want64):
        _close(got, want, 1e-6)
    ins32 = [v.astype(np.float32) for v in ins]
    want32 = jcp(*map(jnp.asarray, ins32), 16)
    got32 = tcp(*map(_t, ins32), 16)
    for got, want in zip(got32, want32):
        assert got.dtype == torch.float32
        _close(got[:, 1:], np.asarray(want)[:, 1:], 1e-3)


def test_estimate_rejects_unknown_id(eva_batch):
    a, _, tctx = eva_batch
    with pytest.raises(ValueError, match="Unsupported estimator 11"):
        torch_est.estimate(11, tctx, _t(a["rx"]), _t(a["hhat"]), _t(a["g"]),
                       10.0, 1.0, y_time=_t(a["y"]))


# -- run_point on JAX's draws --------------------------------------------------

def _counts_close(tlink, jlink, eq_idx, key, n_frames, per: int):
    plan = jlink.plan
    jctx = jrx.get_context(plan, jlink.channel)
    tctx = trx.get_context(tlink.plan, tlink.channel, "cpu")
    beta = jest.BETAS[jlink.m]
    jber, jser = jrx.run_point(jlink, jctx, eq_idx, key, SNR_DB, n_frames,
                               beta=beta)
    ber, ser = trx.run_point(
        tlink, tctx, eq_idx, None, SNR_DB, n_frames, beta=beta,
        draws=iter(_point_draws(jlink, key, eq_idx, n_frames)))
    bits = n_frames * plan.frame_size * jlink.nbits
    syms = n_frames * plan.frame_size
    allowed = math.ceil(per * bits / 10000)
    assert abs(ber - jber) * bits <= allowed + 1e-6, (ber, jber)
    assert abs(ser - jser) * syms <= allowed + 1e-6, (ser, jser)
    return ber


@pytest.mark.parametrize("eq_idx", range(1, 11))
def test_run_point_on_jax_draws_eva(eq_idx):
    jlink, tlink = _links("eva")
    cp = eq_idx in (5, 6)                       # see the module docstring
    ber = _counts_close(tlink, jlink, eq_idx, jax.random.PRNGKey(eq_idx),
                        FRAMES_CP if cp else FRAMES, 5 if cp else 1)
    assert 0 < ber < 0.5


@pytest.mark.parametrize("channel,m,mobile,per_sample,eq_idx", [
    ("awgn", 16, False, False, 1), ("etu", 4, True, False, 2),
    ("eva", 2, True, True, 10)])
def test_run_point_on_jax_draws_other_links(channel, m, mobile, per_sample,
                                            eq_idx):
    jlink, tlink = _links(channel, m, mobile, per_sample)
    _counts_close(tlink, jlink, eq_idx, jax.random.PRNGKey(11), FRAMES, 1)


def test_run_point_batches_and_restores_precision(monkeypatch):
    """Frames split into batches as JAX splits them (6 frames in batches of
    4: the draws of two batches), one read of the counts a point, and the
    caller's float32 setting back after."""
    jlink, tlink = _links("eva")
    ctx = trx.get_context(tlink.plan, "eva", "cpu")
    draws = _point_draws(jlink, jax.random.PRNGKey(2), 2, 6, batch=4)
    assert [d["sym_idx"].shape[0] for d in draws] == [4, 2]
    torch.set_float32_matmul_precision("high")
    seen = []
    real = tlink.count_errors

    def spy(*args):
        seen.append(torch.get_float32_matmul_precision())
        return real(*args)

    monkeypatch.setattr(tlink, "count_errors", spy)
    try:
        trx.run_point(tlink, ctx, 2, None, SNR_DB, 6, batch=4,
                      draws=iter(draws))
        assert seen == ["highest", "highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")


# -- run_benchmark's files ---------------------------------------------------------

def _fake_point(link, ctx, eq_idx, key, snr_db, n_frames, batch=2000,
                beta=1.0, draws=None):
    """A deterministic (ber, ser) of the link's order and the SNR."""
    return 1.0 / (link.m * (snr_db + 20.0)), 0.5 / (link.m + snr_db + 20.0)


@pytest.mark.parametrize("kw", [
    dict(channel="EVA", eq_idx=5),
    dict(channel="AWGN", eq_idx=1, longcp=False),
    dict(channel="EVA", eq_idx=10, mobile=True),
    dict(channel="ETU", eq_idx=2, mobile=True, per_sample=True),
    dict(channel="EVA", eq_idx=7, mods=(2, 16), tag="_allmod"),
    dict(channel="EPA", eq_idx=3, mobile=True, per_sample=True,
         mods=(4,), tag="_qpsk")])
def test_run_benchmark_files_match_jax(tmp_path, monkeypatch, kw):
    import scipy.io as sio
    monkeypatch.setattr(jrx, "run_point", _fake_point)
    monkeypatch.setattr(trx, "run_point", _fake_point)
    kw = dict(kw)
    longcp = kw.pop("longcp", True)
    jplan, tplan = _plans(longcp=longcp)
    snrs = (0, 10)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jb, js, jpath = jrx.run_benchmark(jplan, longcp=longcp, snrs=snrs,
                                      save_dir=str(jdir),
                                      log_fn=lambda *a: None, **kw)
    tb, ts, tpath = trx.run_benchmark(tplan, longcp=longcp, snrs=snrs,
                                      save_dir=str(tdir),
                                      log_fn=lambda *a: None, device="cpu",
                                      **kw)
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert len(os.listdir(tdir)) == 3
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    assert tb.shape == (5, 2)
    for name in os.listdir(jdir):
        a = (jdir / name).read_bytes()
        b = (tdir / name).read_bytes()
        if name.endswith(".mat"):
            # the 116-byte text header holds the time the file was made
            assert a[128:] == b[128:]
            ma, mb = sio.loadmat(jdir / name), sio.loadmat(tdir / name)
            for k in ("berofdm_all", "serofdm_all", "mat_name"):
                np.testing.assert_array_equal(ma[k], mb[k])
        else:
            assert a == b, name


def test_run_benchmark_refuses_what_jax_refuses(tmp_path):
    _, tplan = _plans()
    with pytest.raises(ValueError, match="tag="):
        trx.run_benchmark(tplan, "EVA", 1, mods=(2,), save_dir=str(tmp_path),
                          device="cpu")
    with pytest.raises(ValueError, match="modulation orders"):
        trx.run_benchmark(tplan, "EVA", 1, mods=(3,), tag="_x",
                          save_dir=str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trx.run_benchmark(tplan, "EVA", 1, save_dir=str(tmp_path))


def test_run_benchmark_end_to_end_restores_precision(tmp_path):
    """A real (tiny) sweep with its `.mat` exports: the run logs the
    float32 setting it ran under, the caller's comes back after."""
    _, tplan = _plans()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    logs = []
    try:
        ber, ser, path = trx.run_benchmark(
            tplan, "EVA", 2, n_frames=3, snrs=(5, 25),
            save_dir=str(tmp_path), log_fn=logs.append, save_tx_data=True,
            device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        torch.set_float32_matmul_precision("highest")
    assert "precision highest, allow_tf32 False" in logs[0]
    assert os.path.basename(path) == "BER_OFDM_EVA_LS-Spline_lte_64_Gray.csv"
    assert np.all((ber[1] > 0) & (ber[1] < 0.5)) and np.all(ber[2:] == 0)
    assert sorted(os.listdir(tmp_path / "mat")) == [
        "ofdm_eva_BPSK_25dB.mat", "ofdm_eva_BPSK_5dB.mat"]
    import scipy.io as sio
    mat = sio.loadmat(tmp_path / "mat" / "ofdm_eva_BPSK_5dB.mat")
    assert mat["y"].shape == (7 * 80, 3) and mat["y"].dtype == np.complex64
    assert mat["txbits"].shape == mat["rxbits"].shape == (3 * 320, 1)
