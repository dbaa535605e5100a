"""Tensor parallelism (tp > 1) of the port against the JAX package's, on
CPU virtual ranks: `shard_params` shards equal to JAX's `addressable_shards`
(the DCCN and the opt-12 equalized receiver), `gather_params` its
inverse, gradients on dp 4 x tp 2 at nfft 256 against JAX's tp gradients
and the port's single-device ones (the port's case of
`tests/test_parallel.py:277-317`), the tp step and `fit`, the equalizer
stage on tp, the sweeps on tp bit-identical to dp, and a resumed fit on
tp bit-identical to an uninterrupted one.

The JAX side runs on the 8 virtual CPU devices of `tests/conftest.py`.
Tolerances: shards bit-equal (slices of the same arrays); gradients
rtol 2e-4, atol 1e-6, the tolerance of `tests/test_parallel.py:312-313`
(float32 sums in other orders: the row-parallel `Dense_extract` sums
partial products), for the equalizer in float64 (in float32 its
single-device gradients are noisier than that; see its test) and for
bf16 1e-2 of each leaf's largest value (`tests/test_torch_bf16.py`);
sweeps and resumes bit-identical."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.models.equalizers import EQUALIZER_REGISTRY as JREG
from dl_ofdm_tpu.parallel import mesh as jmesh
from dl_ofdm_tpu.train.equalizer_loop import EqualizerTrainer as JEqTrainer
from dl_ofdm_tpu.train.loop import Trainer as JTrainer
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval import sweep as tsweep
from dl_ofdm_tpu_torch.parallel import mesh as tmesh
from dl_ofdm_tpu_torch.train import checkpoint as tckpt
from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
from dl_ofdm_tpu_torch.train.loop import Trainer

QUIET = dict(log_fn=lambda *a: None)


@pytest.fixture
def jax8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()


def _mesh(dp, tp=1):
    return tmesh.make_mesh(["cpu"] * (dp * tp), dp=dp, tp=tp)


def _flat(tree):
    return tckpt.params_from_flax(jax.tree.map(np.asarray, tree))


def _close(got: dict, want: dict, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


# -- 1. shards ------------------------------------------------------------------

@pytest.mark.parametrize("receiver", ["dccn", "equalized_opt12"])
def test_shard_params_equal_jax_addressable_shards(receiver, jax8):
    """Every rank of a dp 4 x tp 2 mesh holds bit for bit the slice of
    each leaf that JAX's `NamedSharding` puts on the device at the same
    place of JAX's mesh; `gather_params` gives the full parameters back."""
    cfg, tc = JCfg(nbits=1), JTc(opt=12)
    jt = (JTrainer(cfg, tc) if receiver == "dccn"
          else JEqTrainer(cfg, tc, eq_spec=JREG[12]))
    jparams = jt.init_state(jax.random.PRNGKey(0)).params
    jm = jmesh.make_mesh(jax8, dp=4, tp=2)
    jsharded = jmesh.shard_params(jm, jparams)
    mesh = _mesh(4, 2)
    full = _flat(jparams)
    shards = tmesh.shard_params(mesh, full)
    dims = tmesh.shard_dims(mesh, full)
    split = {k for k, d in dims.items() if d is not None}
    want_split = ({"fft_like.wr", "fft_like.wi", "fft_like.br",
                   "fft_like.bi", "Dense_extract.weight"}
                  if receiver == "dccn" else
                  {f"receiver.{k}" for k in ("fft_like.wr", "fft_like.wi",
                                             "fft_like.br", "fft_like.bi",
                                             "Dense_extract.weight")}
                  | {f"Equalizer.Dense_{n}.{p}" for n in
                     ("interp0", "interp1", "block0")
                     for p in ("weight", "bias")})
    assert split == want_split
    for dev in jax8:
        (d, t), = np.argwhere(jm.devices == dev)
        local = _flat(jax.tree.map(
            lambda a: next(s.data for s in a.addressable_shards
                           if s.device == dev), jsharded))
        rank = shards[d * 2 + t]
        assert set(rank) == set(local)
        for k, v in rank.items():
            assert v.is_contiguous() and torch.equal(v, local[k]), k
    gathered = tmesh.gather_params(mesh, shards, dims)
    assert all(torch.equal(gathered[k], full[k]) for k in full)
    assert all(shards[0][k].data_ptr() != full[k].data_ptr() for k in full)


def test_tp_axis_and_undivided_leaves_stay_replicated():
    mesh = _mesh(1, 3)
    params = {"fft_like.wr": torch.zeros(5, 6), "fft_like.br": torch.zeros(6),
              "Dense_extract.weight": torch.zeros(4, 7),
              "Dense_extract.bias": torch.zeros(4),
              "Equalizer.Dense_block0.weight": torch.zeros(9, 2),
              "Dense_llr.weight": torch.zeros(3, 3)}
    assert tmesh.shard_dims(mesh, params) == {
        "fft_like.wr": 1, "fft_like.br": 0, "Dense_extract.weight": None,
        "Dense_extract.bias": None, "Equalizer.Dense_block0.weight": 0,
        "Dense_llr.weight": None}
    assert tmesh.tp_axis("Dense_extract.weight", 2) == 1
    assert tmesh.tp_axis("fft_like.br", 0) is None
    assert set(tmesh.shard_dims(_mesh(2), params).values()) == {None}
    m = tmesh.make_mesh(["cpu"] * 4, dp=2, tp=2)
    assert m.tp_devices(1) == [torch.device("cpu")] * 2
    assert len(m.rank_devices) == 4


# -- 2. gradients -------------------------------------------------------------------

def test_big_grid_tp_gradients_match_jax_and_single_device(jax8, rng):
    """nfft 256, dp 4 x tp 2: the port's mesh gradients (split leaves
    gathered) against JAX's tp-sharded gradients and the port's
    single-device ones, on one fixed batch."""
    jcfg = JCfg(nbits=1, nfft=256, nfilter=256)
    jtc = JTc(snr=5.0, batch_size=112, msg_length=224)
    jm = jmesh.make_mesh(jax8, dp=4, tp=2)
    jt = JTrainer(jcfg, jtc, channel="ETU", mesh=jm)
    st = jt.init_state(jax.random.PRNGKey(0))
    b = jt.batch_frames
    bits = rng.integers(0, 2, (b, jt.plan.frame_size, 1)).astype(np.int32)
    rx = rng.normal(size=(b, 7, 320, 2)).astype(np.float32)
    want = _flat(jax.jit(lambda p, x, y: jax.grad(
        lambda q: jt._loss_fn(q, x, y)[0])(p))(st.params, jnp.asarray(bits),
                                                jnp.asarray(rx)))

    cfg = OFDMConfig(nbits=1, nfft=256, nfilter=256)
    tc = TrainConfig(snr=5.0, batch_size=112, msg_length=224)
    mesh = _mesh(4, 2)
    tt = Trainer(cfg, tc, channel="ETU", device="cpu", mesh=mesh)
    assert tt.batch_frames == b and tt._tp
    params = _flat(jax.device_get(st.params))
    state = tt._new_state(params, list(params))
    tb, tr = tmesh.shard_batch(mesh, (torch.from_numpy(bits),
                                      torch.from_numpy(rx)))
    _, aux = tt._mesh_step(state, tb, tr, [{}] * 4, torch.tensor(0.0),
                           return_grads=True)
    assert isinstance(aux["grads"]["Dense_extract.weight"], list)
    got = tt._gathered(aux["grads"])
    ts = Trainer(cfg, tc, channel="ETU", device="cpu")
    train = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = ts._loss_fn(train, torch.from_numpy(bits), torch.from_numpy(rx))
    single = dict(zip(train, torch.autograd.grad(loss, list(train.values()))))
    _close(got, want)
    _close(single, want)
    _close(got, single)


def test_bf16_tp_gradients_match_single_device(rng):
    """`compute_dtype='bfloat16'` on dp 1 x tp 2: `fft_like` in the bf16
    mode on each rank's columns, `Dense_extract`'s partial products summed
    in float32 and rounded once; the gradients within 1e-2 of each leaf's
    largest value of the single-device ones (the bf16 tolerance of
    `tests/test_torch_bf16.py`)."""
    cfg = OFDMConfig(nbits=1, compute_dtype="bfloat16")
    tc = TrainConfig(snr=5.0, batch_size=56, msg_length=112)
    mesh = _mesh(1, 2)
    tt = Trainer(cfg, tc, channel="AWGN", device="cpu", mesh=mesh)
    ts = Trainer(cfg, tc, channel="AWGN", device="cpu")
    params = ts.init_state(torch.Generator().manual_seed(0)).params
    state = tt._new_state(params, list(params))
    b = tt.batch_frames
    bits = torch.from_numpy(rng.integers(0, 2, (b, tt.plan.frame_size, 1))
                            .astype(np.int32))
    rx = torch.from_numpy(rng.normal(size=(b, 7, 80, 2)).astype(np.float32))
    _, aux = tt._mesh_step(state, [bits], [rx], [{}], torch.tensor(0.0),
                           return_grads=True)
    got = tt._gathered(aux["grads"])
    train = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = ts._loss_fn(train, bits, rx)
    want = dict(zip(train, torch.autograd.grad(loss, list(train.values()))))
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= 1e-2 * float(
            w.abs().max()), k


def test_tp_train_step_and_fit():
    """The tp step keeps the ranks' shards the gathered parameters' blocks,
    rows identical; Adam's moments of split leaves are shard lists."""
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(
        snr=5.0, batch_size=100, msg_length=200), channel="mixRayleigh",
        device="cpu", mesh=_mesh(2, 2))
    assert tt.batch_frames == 14 and not tt._use_fused_model
    g = torch.Generator().manual_seed(0)
    state = tt.init_state(g)
    snr = torch.full((14,), 5.0)
    for _ in range(2):
        state, aux = tt.train_step(state, g, snr)
        assert np.isfinite(float(aux["loss"]))
        assert int(aux["conf"].sum()) == 14 * tt.plan.frame_size
    assert state.step == 2 and len(state.replicas) == 4
    mu = state.opt_state["mu"]
    assert isinstance(mu["fft_like.wr"], list) and len(mu["fft_like.wr"]) == 2
    assert mu["fft_like.wr"][0].shape == (80, 32)
    assert isinstance(mu["Dense_llr.weight"], torch.Tensor)
    again = tmesh.shard_params(tt.mesh, state.params)
    for got, want in zip(state.replicas, again):
        assert all(torch.equal(got[k], want[k]) for k in want)
    _, info = tt.fit(max_epochs=2, grow_batch=False, **QUIET)
    assert np.isfinite(info["best_loss"]) and len(info["history"]) == 2


# -- 3. the equalizer stage on tp ------------------------------------------------------

def test_equalizer_tp_gradients_match_single_device(rng):
    """opt 12 on dp 1 x tp 2 (as `chip_smoke.py` phase 25c): the Equalizer
    keys' gradients (its split `Dense_interp*` / `Dense_block*` gathered)
    against the single-device ones.  In float64 they agree within rtol
    2e-4, atol 1e-6.  In float32 that tolerance is below float32's own
    error on this model (the single-device gradient of `BlockConv0.br`
    is 5e-5 of its largest value away from the float64 one: sums over
    the frame with cancellation), so there the tp gradients' worst error
    against the float64 ones, relative to each leaf's largest value, must
    be within twice the single-device float32 gradients'.  The frozen
    receiver takes none and stays as it was."""
    base = Trainer(OFDMConfig(nbits=1), TrainConfig(), device="cpu")
    rx_params = base.init_state(torch.Generator().manual_seed(0)).params
    tc = TrainConfig(snr=5.0, batch_size=56, msg_length=112, opt=12)
    mesh = _mesh(1, 2)
    tt = EqualizerTrainer(OFDMConfig(nbits=1), tc, channel="mixRayleigh",
                          pretrained_rx=rx_params, device="cpu", mesh=mesh)
    ts = EqualizerTrainer(OFDMConfig(nbits=1), tc, channel="mixRayleigh",
                          pretrained_rx=rx_params, device="cpu")
    state = tt.init_state(torch.Generator().manual_seed(1))
    assert isinstance(state.opt_state["mu"]["Equalizer.Dense_interp0.weight"],
                      list)
    assert set(state.opt_state["mu"]) == {
        k for k in state.params if k.startswith("Equalizer.")}
    ts._set_trainable(state.params)
    b = tt.batch_frames
    bits = torch.from_numpy(rng.integers(0, 2, (b, tt.plan.frame_size, 1))
                            .astype(np.int32))
    rx = torch.from_numpy(rng.normal(size=(b, 7, 80, 2)).astype(np.float32))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        params = {k: v.to(dtype) for k, v in state.params.items()}
        st = tt._new_state(params, tt._trainable)
        tb, tr = tmesh.shard_batch(mesh, (bits, rx.to(dtype)))
        new, aux = tt._mesh_step(st, tb, tr, [{}], torch.tensor(0.0),
                                 return_grads=True)
        train = {k: params[k].clone().requires_grad_()
                 for k in ts._trainable}
        loss, _ = ts._loss_fn({**params, **train}, bits, rx.to(dtype))
        grads[dtype] = (tt._gathered(aux["grads"]), dict(zip(
            train, torch.autograd.grad(loss, list(train.values())))))
    tp64, one64 = grads[torch.float64]
    assert set(tp64) == set(one64) == set(tt._trainable)
    _close(tp64, one64)
    tp32, one32 = grads[torch.float32]

    def worst(g):
        return max(float((g[k].double() - v).abs().max() / v.abs().max())
                   for k, v in one64.items())

    assert worst(tp32) <= 2 * worst(one32), (worst(tp32), worst(one32))
    for rep in [new.params] + new.replicas:
        for k, v in rep.items():
            if k.startswith("receiver.") and tt._dims[k] is None:
                assert torch.equal(v.float(),
                                   rx_params[k[len("receiver."):]]), k
    assert torch.equal(new.params["receiver.Dense_extract.weight"].float(),
                       rx_params["Dense_extract.weight"])
    g = torch.Generator().manual_seed(2)
    state, aux = tt.train_step_curriculum(state, g)
    assert all(np.isfinite(float(aux[k]))
               for k in ("ce", "loss", "snr_mse", "chan_mse"))


def test_single_graph_equalized_rx_on_tp_matches_single_device(rng):
    """`SingleGraphEqualizedRx` as a trainer's model on dp 1 x tp 2: its
    `fft_like`, `Dense_interp*` and `Dense_extract` split, the gradients
    in float64 within rtol 2e-4, atol 1e-6 of the single-device ones."""
    from dl_ofdm_tpu_torch.models.receiver import SingleGraphEqualizedRx
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    cfg = OFDMConfig(nbits=1, nfilter=32)
    tc = TrainConfig(snr=5.0, batch_size=28, msg_length=56)
    plan = build_plan(cfg)

    def make(mesh=None):
        model = SingleGraphEqualizedRx(1, 64, plan.cp_len, 32,
                                       plan.frame_size, 7, plan.pilot_size)
        return Trainer(cfg, tc, channel="AWGN", model=model.double(),
                       device="cpu", mesh=mesh)

    tt, ts = make(_mesh(1, 2)), make()
    assert {k for k, d in tt._dims.items() if d is not None} == {
        f"{n}.{p}" for n, ps in (("fft_like", ("wr", "wi", "br", "bi")),
                                 ("Dense_interp0", ("weight", "bias")),
                                 ("Dense_interp1", ("weight", "bias")),
                                 ("Dense_extract", ("weight",)))
        for p in ps}
    params = {k: v.double() for k, v in ts.init_state(
        torch.Generator().manual_seed(0)).params.items()}
    b = tt.batch_frames
    bits = torch.from_numpy(rng.integers(0, 2, (b, plan.frame_size, 1))
                            .astype(np.int32))
    rx = torch.from_numpy(rng.normal(size=(b, 7, 80, 2)))
    _, aux = tt._mesh_step(tt._new_state(params, list(params)), [bits], [rx],
                           [{}], torch.tensor(0.0), return_grads=True)
    train = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = ts._loss_fn(train, bits, rx)
    _close(tt._gathered(aux["grads"]), dict(zip(train, torch.autograd.grad(
        loss, list(train.values())))))


# -- 4. the sweeps on tp -------------------------------------------------------------------

@pytest.mark.parametrize("point_batch", [False, True])
def test_tp_sweep_bit_identical_to_dp(point_batch):
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=14,
                                                  msg_length=98),
                 channel="EPA", device="cpu")
    tt.init_state(torch.Generator().manual_seed(0))
    runs = [tsweep.ber_sweep(tt, torch.Generator().manual_seed(5),
                             snrs=(0, 10), frames_per_point=64,
                             batch_frames=32, point_batch=point_batch,
                             mesh=mesh, **QUIET)
            for mesh in (_mesh(2), _mesh(2, 2))]
    assert np.array_equal(runs[0].ber, runs[1].ber)
    assert np.array_equal(runs[0].loss, runs[1].loss)
    assert np.all(np.isfinite(runs[1].ber))


# -- 5. checkpoints and resume on tp ---------------------------------------------------------

def test_tp_checkpoint_round_trip_gathers_to_flax_layout(tmp_path):
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(snr=5.0, batch_size=28,
                                                  msg_length=56),
                 device="cpu", mesh=_mesh(1, 2))
    g = torch.Generator().manual_seed(0)
    state, _ = tt.train_step(tt.init_state(g), g, torch.full((4,), 5.0))
    path = tckpt.save(str(tmp_path / "ck"), state)
    with np.load(os.path.join(path, "state.npz")) as data:
        assert data["opt/mu/fft_like/wr"].shape == (80, 64)
        assert data["opt/nu/Dense_extract/kernel"].shape == (896, 640)
    got = tckpt.restore(path, tt.init_state(g))
    assert got.step == 1 and got.opt_state["count"] == 1
    for m in ("mu", "nu"):
        for k, v in state.opt_state[m].items():
            w = got.opt_state[m][k]
            assert isinstance(w, list) == isinstance(v, list), k
            for a, b in zip(w if isinstance(w, list) else [w],
                            v if isinstance(v, list) else [v]):
                assert torch.equal(a, b), k
    assert all(torch.equal(got.params[k], v) for k, v in state.params.items())


def test_tp_fit_crash_resume_identical(tmp_path):
    """dp 2 x tp 2: a fit stopped after 2 epochs and resumed by a fresh
    trainer ends bit-identical to 3 straight epochs (params, shards, Adam's
    shard moments, history)."""
    tc = TrainConfig(snr=5.0, batch_size=28, msg_length=112, early_stop=50)

    def make():
        return Trainer(OFDMConfig(nbits=1), tc, device="cpu",
                       mesh=_mesh(2, 2))

    straight = make().fit(max_epochs=3, grow_batch=False, **QUIET)
    d = str(tmp_path / "wip")
    make().fit(max_epochs=2, ckpt_dir=d, ckpt_every=1, grow_batch=False,
               **QUIET)
    resumed = make().fit(max_epochs=3, ckpt_dir=d, ckpt_every=1,
                         grow_batch=False, **QUIET)
    (sa, ia), (sb, ib) = straight, resumed
    assert sa.step == sb.step and [h["epoch"] for h in ib["history"]] == [2]
    assert ib["history"][0] == ia["history"][2]
    for a, b in ((sa.params, sb.params), *zip(sa.replicas, sb.replicas)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for m in ("mu", "nu"):
        for k, v in sa.opt_state[m].items():
            w = sb.opt_state[m][k]
            for x, y in zip(v if isinstance(v, list) else [v],
                            w if isinstance(w, list) else [w]):
                assert torch.equal(x, y), (m, k)
    assert dataclasses.asdict(tc) == dataclasses.asdict(make().tc)
