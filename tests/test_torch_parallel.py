"""The port's device mesh against the JAX package's, on virtual CPU ranks:
`make_mesh` and the partitioning rules, the ring exchange's plain version
against the Pallas `_dma_ring_exchange` (interpret mode), the halo FIR
with both exchanges, the dp gradients, the mesh train step and `fit`, the
equalizer stage on a mesh, both mesh sweep protocols, the scaling harness,
and the entry points on a mesh with tp > 1 (`tests/test_torch_tp.py` holds
tensor parallelism to JAX).

The JAX side runs on the 8 virtual CPU devices of `tests/conftest.py`, as
`tests/test_parallel.py` does; the port lists the CPU once per rank.
Tolerances: the halo FIR within 1e-6 of the largest output of JAX's (XLA
on the CPU may contract the tap loop's multiply-adds, which the port
rounds one by one: a few ulp) and bit-equal to the port's own
`fir_same_iq` (the same operations in the same order); gradients
rtol 2e-4, atol 2e-5 (float32 sums in other orders), as
`tests/test_parallel.py:251-275`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.models.equalizers import EQUALIZER_REGISTRY as JREG
from dl_ofdm_tpu.parallel import halo as jhalo
from dl_ofdm_tpu.parallel import mesh as jmesh
from dl_ofdm_tpu.train.equalizer_loop import EqualizerTrainer as JEqTrainer
from dl_ofdm_tpu.train.loop import Trainer as JTrainer
from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval import sweep as tsweep
from dl_ofdm_tpu_torch.parallel import distributed as tdist
from dl_ofdm_tpu_torch.parallel import halo as thalo
from dl_ofdm_tpu_torch.parallel import mesh as tmesh
from dl_ofdm_tpu_torch.train import checkpoint as tckpt
from dl_ofdm_tpu_torch.train import metrics as TM
from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
from dl_ofdm_tpu_torch.train.loop import Trainer, TrainState


@pytest.fixture
def jax8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()


def _cpu_mesh(dp, tp=1):
    return tmesh.make_mesh(["cpu"] * (dp * tp), dp=dp, tp=tp)


def _flat(tree):
    return tckpt.params_from_flax(jax.tree.map(np.asarray, tree))


def _iq(x):
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def _trainer(mesh=None, batch=112, channel="mixRayleigh", **tc):
    return Trainer(OFDMConfig(nbits=1), TrainConfig(
        snr=5.0, batch_size=batch, msg_length=batch * 2, **tc),
        channel=channel, device="cpu", mesh=mesh)


# -- 1. the mesh -------------------------------------------------------------

def test_make_mesh_shape_repeats_and_errors():
    m = tmesh.make_mesh(["cpu", torch.device("cpu"), "cpu", "cpu"], dp=2,
                        tp=2)
    assert m.shape == {"dp": 2, "tp": 2} and m.axis_names == ("dp", "tp")
    assert m.devices.shape == (2, 2) and m.dp_devices == [
        torch.device("cpu")] * 2
    assert tmesh.make_mesh(["cpu"] * 3).shape == {"dp": 3, "tp": 1}
    with pytest.raises(ValueError, match="dp\\*tp=4 != device count 3"):
        tmesh.make_mesh(["cpu"] * 3, dp=2, tp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.make_mesh()


def _jax_param_paths(params):
    return ["/".join(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]


@pytest.mark.parametrize("receiver", ["dccn", "equalized_opt12"])
def test_param_sharding_rules_match_jax(receiver):
    """Every parameter of the DCCN and of the opt-12 `EqualizedReceiver`,
    by its flax path and by its port `state_dict` key."""
    cfg, tc = JCfg(nbits=2), JTc(opt=12)
    if receiver == "dccn":
        jt, tt = JTrainer(cfg, tc), Trainer(OFDMConfig(nbits=2),
                                            TrainConfig(), device="cpu")
    else:
        jt = JEqTrainer(cfg, tc, eq_spec=JREG[12])
        tt = EqualizerTrainer(OFDMConfig(nbits=2), TrainConfig(opt=12),
                              device="cpu")
    jparams = jt.init_state(jax.random.PRNGKey(0)).params
    paths = _jax_param_paths(jparams)
    specs = {p: tuple(jmesh.param_sharding_rules(p)) for p in paths}
    assert any(specs.values())          # some rule applies
    for p in paths:
        assert tmesh.param_sharding_rules(p) == specs[p], p
    keys = list(tt.model.state_dict())
    zero = torch.zeros(1)
    assert sorted(_jax_param_paths(tckpt.params_to_flax(
        dict.fromkeys(keys, zero)))) == sorted(paths)
    for k in keys:
        (path,) = _jax_param_paths(tckpt.params_to_flax({k: zero}))
        assert tmesh.param_sharding_rules(k) == specs[path], k


def test_shard_batch_and_params_place_a_replica_per_rank():
    mesh = _cpu_mesh(4)
    x = torch.arange(24.0).reshape(8, 3)
    bits = torch.arange(8)
    xs, bs = tmesh.shard_batch(mesh, (x, bits))
    assert [s.shape[0] for s in xs] == [2] * 4
    assert torch.equal(torch.cat(xs), x) and torch.equal(torch.cat(bs), bits)
    assert tmesh.shard_batch(mesh, {"x": x})["x"][3].shape == (2, 3)
    with pytest.raises(ValueError, match="equal shards"):
        tmesh.shard_batch(mesh, torch.zeros(6))
    params = {"a": torch.ones(3)}
    reps = tmesh.shard_params(mesh, params)
    assert len(reps) == 4 and all(torch.equal(r["a"], params["a"])
                                  for r in reps)
    assert len({r["a"].data_ptr() for r in reps} | {params["a"].data_ptr()}
               ) == 5


def test_rank_generators_draw_different_streams():
    devs = _cpu_mesh(4).dp_devices
    gens = tmesh.rank_generators(torch.Generator().manual_seed(3), devs)
    draws = [torch.randn(16, generator=g) for g in gens]
    assert all(not torch.equal(draws[i], draws[j])
               for i in range(4) for j in range(i))
    again = tmesh.rank_generators(torch.Generator().manual_seed(3), devs)
    assert torch.equal(torch.randn(16, generator=again[2]), draws[2])


# -- 2. the ring exchange ----------------------------------------------------

@pytest.mark.parametrize("p,hl,hr", [(4, 6, 6), (4, 8, 1), (1, 3, 2)])
def test_ring_exchange_ref_matches_pallas_dma(jax8, rng, p, hl, hr):
    """The plain version against JAX's `_dma_ring_exchange` in interpret
    mode inside `shard_map` on p devices (P = 1: a rank exchanges with
    itself), on the same inputs: equal buffers."""
    from jax import shard_map

    b = 3
    lt = rng.normal(size=(p * b, hl, 2)).astype(np.float32)
    rh = rng.normal(size=(p * b, hr, 2)).astype(np.float32)
    mesh = jax.sharding.Mesh(np.asarray(jax8[:p]), ("dp",))
    fn = shard_map(
        lambda a, c: jhalo._dma_ring_exchange(a, c, "dp", p, True),
        mesh=mesh, in_specs=(P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp")), check_vma=False)
    want_l, want_r = (np.asarray(v) for v in jax.jit(fn)(lt, rh))
    got_l, got_r = thalo.ring_exchange(
        list(torch.chunk(torch.from_numpy(lt), p)),
        list(torch.chunk(torch.from_numpy(rh), p)))
    np.testing.assert_array_equal(torch.cat(got_l).numpy(), want_l)
    np.testing.assert_array_equal(torch.cat(got_r).numpy(), want_r)
    assert thalo._dma_ring_exchange is thalo.ring_exchange


def test_ring_exchange_refuses_mixed_devices_and_bad_slices():
    x = torch.zeros(2, 3, 2)
    with pytest.raises(ValueError, match="ranks on"):
        thalo.ring_exchange([x, x.to("meta")], [x, x.to("meta")])
    with pytest.raises(ValueError, match="CUDA device"):
        thalo.ring_exchange_kernel([x], [x])


# -- 3. the halo FIR -----------------------------------------------------------

@pytest.mark.parametrize("f", [9, 13])
@pytest.mark.parametrize("off_mode", ["same", "causal"])
@pytest.mark.parametrize("p", [4, 8])
def test_halo_fir_matches_jax_convolve_and_fir_same_iq(jax8, rng, p,
                                                       off_mode, f):
    """Both exchanges against JAX's halo FIR with the same exchange (1e-6),
    np.convolve (1e-4) and the port's `fir_same_iq` of the whole block
    (bit-equal)."""
    from jax import shard_map

    b, l = 2, p * 24
    x = (rng.normal(size=(b, l)) + 1j * rng.normal(size=(b, l))).astype(
        np.complex64)
    h = (rng.normal(size=(b, f)) + 1j * rng.normal(size=(b, f))).astype(
        np.complex64)
    off = (f - 1) // 2 if off_mode == "same" else 0
    xi, hi = _iq(x), _iq(h)
    # a 1-D mesh: the interpreter's DMA discharge takes one named axis
    jm = jax.sharding.Mesh(np.asarray(jax8[:p]), ("dp",))
    tm = _cpu_mesh(p)
    whole = fir_same_iq(torch.from_numpy(xi), torch.from_numpy(hi),
                        np.full(b, off)).numpy()
    full = np.stack([np.convolve(x[i], h[i], mode="full")[off:off + l]
                     for i in range(b)])
    for exchange in ("ppermute", "dma"):
        fn = shard_map(
            lambda xs, hs: jhalo.halo_fir_same_iq(xs, hs, off, "dp",
                                                  exchange=exchange),
            mesh=jm, in_specs=(P(None, "dp", None), P(None, None, None)),
            out_specs=P(None, "dp", None), check_vma=False)
        want = np.asarray(jax.jit(fn)(jnp.asarray(xi), jnp.asarray(hi)))
        got = torch.cat(thalo.halo_fir_same_iq(
            list(torch.chunk(torch.from_numpy(xi), p, dim=1)),
            torch.from_numpy(hi), off, tm, exchange=exchange), dim=1).numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale,
                                   err_msg=exchange)
        np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], full,
                                   atol=1e-4, err_msg=exchange)
        np.testing.assert_array_equal(got, whole, err_msg=exchange)


def test_halo_fir_refuses_short_shards_and_unknown_exchange():
    x = [torch.zeros(1, 4, 2)] * 2
    with pytest.raises(ValueError, match="shorter than its halo"):
        thalo.halo_fir_same_iq(x, torch.zeros(1, 13, 2), 6, ["cpu"] * 2)
    with pytest.raises(ValueError, match="offset"):
        thalo.halo_fir_same_iq(x, torch.zeros(1, 3, 2), 3, ["cpu"] * 2)
    with pytest.raises(ValueError, match="nccl"):
        thalo.halo_fir_same_iq(x, torch.zeros(1, 3, 2), 1, ["cpu"] * 2,
                               exchange="nccl")


# -- 4. dp gradients -------------------------------------------------------------

def test_dp_gradients_match_jax_mesh_and_single_device(jax8, rng):
    """One global batch split by `shard_batch`: the port's dp = 4 gradients
    against JAX's mesh gradients (dp 4, tp 1) and the port's single-device
    gradients."""
    jtc = JTc(snr=5.0, batch_size=112, msg_length=224)
    jt = JTrainer(JCfg(nbits=1), jtc, channel="mixRayleigh")
    jparams = jt.init_state(jax.random.PRNGKey(0)).params
    b = jt.batch_frames
    bits = rng.integers(0, 2, (b, jt.plan.frame_size, 1)).astype(np.int32)
    rx = rng.normal(size=(b, 7, 80, 2)).astype(np.float32)
    jm = jmesh.make_mesh(jax8[:4], dp=4, tp=1)
    jm_tr = JTrainer(JCfg(nbits=1), jtc, channel="mixRayleigh", mesh=jm)
    bits_m, rx_m = jmesh.shard_batch(jm, (jnp.asarray(bits), jnp.asarray(rx)))
    params_m = jax.device_put(jparams, NamedSharding(jm, P()))
    want = _flat(jax.jit(jax.grad(jm_tr._loss_fn, has_aux=True))(
        params_m, bits_m, rx_m)[0])

    mesh = _cpu_mesh(4)
    tt, ts = _trainer(mesh), _trainer()
    params = _flat(jparams)
    state = TrainState(params, tt.optimizer.init(params), 0,
                       tmesh.shard_params(mesh, params))
    tb, tr = tmesh.shard_batch(mesh, (torch.from_numpy(bits),
                                      torch.from_numpy(rx)))
    _, aux = tt._mesh_step(state, tb, tr, [{}] * 4, torch.tensor(0.0),
                           return_grads=True)
    train = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = ts._loss_fn(train, torch.from_numpy(bits), torch.from_numpy(rx))
    single = dict(zip(train, torch.autograd.grad(loss, list(train.values()))))
    for k in want:
        for got in (aux["grads"][k], single[k]):
            np.testing.assert_allclose(got.numpy(), want[k].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)


# -- 5. the mesh train step and fit -----------------------------------------------

def test_mesh_train_step_keeps_replicas_identical():
    tt = _trainer(_cpu_mesh(4), batch=100)
    assert tt.batch_frames == 16 and not tt._use_fused_model
    g = torch.Generator().manual_seed(0)
    state = tt.init_state(g)
    snr = torch.full((16,), 5.0)
    for _ in range(2):
        state, aux = tt.train_step(state, g, snr)
        assert np.isfinite(float(aux["loss"]))
        assert int(aux["conf"].sum()) == 16 * tt.plan.frame_size
    assert state.step == 2 and len(state.replicas) == 4
    for rep in state.replicas:
        assert all(torch.equal(rep[k], state.params[k]) for k in rep)
    with pytest.raises(ValueError, match="autograd route"):
        tt.train_step(state, g, snr, fused=True)


def test_mesh_shards_differ_and_noise_power_is_their_mean():
    tt = _trainer(_cpu_mesh(4), channel="AWGN")
    g = torch.Generator().manual_seed(5)
    bits, rx, h, npwr = tt._synth_mesh(g, torch.full((16,), 5.0),
                                       want_h=True)
    assert len(bits) == 4 and all(r.shape[0] == 4 for r in rx)
    assert all(not torch.equal(bits[i], bits[j])
               for i in range(4) for j in range(i))
    assert len(h) == 4 and 0 < float(npwr) < 1
    assert tt._synth_mesh(g, torch.full((16,), 5.0))[2] is None


def test_mesh_fit_at_dp_8():
    tt = _trainer(_cpu_mesh(8))
    assert tt.batch_frames == 16
    _, info = tt.fit(max_epochs=3, log_fn=lambda *a: None, grow_batch=False)
    assert np.isfinite(info["best_loss"]) and len(info["history"]) == 3
    tt.batch_frames = 17
    assert tt._round_to_dp(tt._ideal_batch_frames(0.5)) % 8 == 0


# -- 6. the equalizer stage on a mesh --------------------------------------------

def test_mesh_equalizer_step_keeps_the_receiver_frozen():
    base = Trainer(OFDMConfig(nbits=1), TrainConfig(), device="cpu")
    rx_params = base.init_state(torch.Generator().manual_seed(0)).params
    tt = EqualizerTrainer(OFDMConfig(nbits=1), TrainConfig(
        snr=5.0, batch_size=112, msg_length=224, opt=0),
        channel="mixRayleigh", pretrained_rx=rx_params, device="cpu",
        mesh=_cpu_mesh(4))
    g = torch.Generator().manual_seed(1)
    state = tt.init_state(g)
    state, aux = tt.train_step_curriculum(state, g)
    assert all(np.isfinite(float(aux[k]))
               for k in ("ce", "loss", "snr_mse", "chan_mse"))
    for rep in [state.params] + state.replicas:
        for k, v in rx_params.items():
            assert torch.equal(rep[f"receiver.{k}"], v), k
    assert set(state.opt_state["mu"]) == {
        k for k in state.params if k.startswith("Equalizer.")}
    tt.fused_curriculum = True
    with pytest.raises(ValueError, match="plain data plane"):
        tt.train_step_curriculum(state, g)


# -- 7. the mesh sweeps ------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_trainer():
    tt = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=14,
                                                  msg_length=98),
                 channel="AWGN", device="cpu")
    tt.init_state(torch.Generator().manual_seed(0))
    return tt


def test_mesh_interleaved_sweep_matches_single_device(sweep_trainer):
    snrs = (0, 10)
    single = tsweep.ber_sweep(sweep_trainer, torch.Generator().manual_seed(5),
                              snrs=snrs, frames_per_point=512,
                              batch_frames=128, log_fn=lambda *a: None)
    mesh = tsweep.ber_sweep(sweep_trainer, torch.Generator().manual_seed(6),
                            snrs=snrs, frames_per_point=512,
                            batch_frames=128, log_fn=lambda *a: None,
                            mesh=_cpu_mesh(4))
    assert np.all(np.isfinite(mesh.ber)) and np.all(np.isfinite(mesh.loss))
    np.testing.assert_allclose(mesh.ber, single.ber, atol=0.06)
    np.testing.assert_allclose(mesh.loss, single.loss, rtol=0.2)


@pytest.mark.parametrize("n_pts,batch_frames,dp", [(2, 128, 4), (41, 7872, 4),
                                                   (3, 5, 4), (2, 50, 8)])
def test_mesh_interleaved_layout_covers_every_point_on_every_rank(
        n_pts, batch_frames, dp):
    snr, onehot = tsweep.interleaved_groups(list(range(n_pts)), batch_frames,
                                            "cpu", dp)
    rep = snr.shape[0] // n_pts
    assert rep % dp == 0 and rep >= 4 * dp
    for shard in torch.chunk(onehot, dp):
        assert torch.equal(shard.sum(0), torch.full((n_pts,), rep / dp))
    if (n_pts, batch_frames) == (41, 7872):
        assert rep == 192           # 48 frames a point and rank


def test_mesh_point_batch_sweep_matches_its_reconstruction(sweep_trainer):
    """The sharded point_batch protocol against a single-process
    reconstruction from the same per-rank generators: whole-batch moments,
    one forward pass; within 8.5 flipped bits (reduction order)."""
    tt, mesh, b, snr = sweep_trainer, _cpu_mesh(4), 256, 5.0
    res = tsweep.ber_sweep(tt, torch.Generator().manual_seed(7), snrs=(snr,),
                           frames_per_point=b, batch_frames=b,
                           log_fn=lambda *a: None, mesh=mesh,
                           point_batch=True)
    gens = tmesh.rank_generators(torch.Generator().manual_seed(7),
                                 mesh.dp_devices)
    shards = [tt.synthesize(b // 4, torch.full((b // 4,), snr), g,
                            normalize=False) for g in gens]
    bits = torch.cat([s[0] for s in shards])
    y = torch.cat([s[1] for s in shards])
    rx = ((y - y.mean(0, keepdim=True))
          * torch.rsqrt(y.var(0, unbiased=False, keepdim=True) + 1e-9)
          / 2 ** 0.5)
    with torch.no_grad():
        logits = tt.model(rx)[0]
    err = int((TM.bit_predictions(logits) != bits).sum())
    n_bits = b * tt.plan.frame_size
    np.testing.assert_allclose(res.ber[0], err / n_bits, atol=8.5 / n_bits)


def test_mesh_point_batch_frames_are_exact_and_moments_two_pass(
        sweep_trainer, rng):
    """`ADVICE.md`'s two faults, not copied: a batch that dp does not
    divide is refused, a frame count that is not whole batches is logged,
    and the moments equal `torch.var(unbiased=False)` of the concatenated
    batch to 1e-6 where E[x^2] - mean^2 in float32 does not."""
    mesh = _cpu_mesh(4)
    with pytest.raises(ValueError, match="not a multiple of dp 4"):
        tsweep.ber_sweep(sweep_trainer, torch.Generator(), snrs=(0,),
                         frames_per_point=100, batch_frames=30, mesh=mesh,
                         point_batch=True, log_fn=lambda *a: None)
    logs = []
    tsweep.ber_sweep(sweep_trainer, torch.Generator().manual_seed(1),
                     snrs=(0,), frames_per_point=20, batch_frames=8,
                     mesh=mesh, point_batch=True, log_fn=logs.append)
    assert logs[0] == "point_batch: 16 frames a point (2 calls of 8), not 20"
    # a large offset over a small spread: one-pass variance cancels
    ys = [torch.from_numpy((1000.0 + rng.normal(size=(64, 5, 2)))
                           .astype(np.float32)) for _ in range(4)]
    mean, var = tsweep.global_moments(ys, torch.device("cpu"))
    cat = torch.cat(ys)
    torch.testing.assert_close(var, cat.var(0, unbiased=False, keepdim=True),
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(mean, cat.mean(0, keepdim=True), atol=1e-6,
                               rtol=1e-6)
    one_pass = (cat * cat).mean(0, keepdim=True) - cat.mean(0,
                                                            keepdim=True) ** 2
    assert float((one_pass - var).abs().max()) > 1e-2


def test_cross_channel_sweep_passes_the_mesh_on(sweep_trainer, tmp_path):
    params = sweep_trainer.model.state_dict()
    res = tsweep.cross_channel_sweep(
        lambda chan, mobile: Trainer(OFDMConfig(nbits=1), TrainConfig(),
                                     channel=chan, device="cpu"),
        params, torch.Generator().manual_seed(2), "tok", 0, "AWGN",
        save_dir=str(tmp_path), snrs=(0,), frames_per_point=8,
        batch_frames=8, test_channels=("EPA",), point_batch=True,
        log_fn=lambda *a: None, mesh=_cpu_mesh(2))
    assert np.isfinite(res["EPA"].ber).all()
    assert (tmp_path / "Test_DCCN_tok_Equalizer0_AWGN_test_chan_EPA.csv"
            ).exists()


# -- 8. scaling ----------------------------------------------------------------------

def test_weak_scaling_efficiency_formula():
    assert tdist.weak_scaling_efficiency({1: 10.0, 2: 10.0, 8: 10.0}) == {
        1: 1.0, 2: 1.0, 8: 1.0}
    prof = tdist.weak_scaling_efficiency({1: 10.0, 2: 9.0, 4: 8.0})
    assert prof[1] == 1.0 and prof[2] == pytest.approx(0.9)
    assert prof[4] == pytest.approx(0.8)
    assert tdist.weak_scaling_efficiency({}) == {}


def test_scaling_efficiency_harness_on_cpu_ranks(monkeypatch):
    """The harness on CPU virtual ranks; `initialize_multihost` does
    nothing for one process and refuses what it cannot do before any
    rendezvous (a real 2-process group: `tests/test_torch_distributed.py`)."""
    info = tdist.initialize_multihost()             # one process: no-op
    assert (info.world, info.backend) == (1, None)
    with pytest.raises(ValueError, match="'nccl' needs a card"):
        tdist.initialize_multihost("localhost:1234", 2, 0, backend="nccl",
                                   device="cpu")
    with pytest.raises(ValueError, match="outside 0...1"):
        tdist.initialize_multihost("localhost:1234", 2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdist.initialize_multihost("localhost:1234", 2, 0)
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not match WORLD_SIZE 3"):
        tdist.initialize_multihost("localhost:1234", 2, 0, device="cpu")

    def make_step(n):
        return lambda shards: [torch.sum(s * s, dim=-1) for s in shards]

    def make_args(n):
        return (tmesh.shard_batch(_cpu_mesh(n), torch.ones(n * 4, 128)),)

    logs = []
    res, eff = tdist.scaling_efficiency(make_step, make_args,
                                        device_counts=(1, 2), iters=2,
                                        log_fn=logs.append, device="cpu")
    assert set(res) == {1, 2} and all(v > 0 for v in res.values())
    assert eff[1] == 1.0 and eff[2] == res[2] / res[1]
    assert len(logs) == 2 and logs[1].startswith("2 devices: ")


# -- 9. tp > 1 ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["Trainer", "EqualizerTrainer", "ber_sweep",
                                   "shard_params"])
def test_tensor_parallel_mesh_raises(entry, sweep_trainer):
    """The four entry points that raised on tp > 1 before tensor
    parallelism was ported (ROADMAP.md Queue A item 12) now run on a
    dp 2 x tp 2 mesh and match the dp-only mesh: the trainer's gradients
    on one batch (split leaves gathered), the equalizer stage's metrics
    on one curriculum step from the same generator, the sweep bit for
    bit, and the shards (`tests/test_torch_tp.py` holds them to JAX)."""
    mesh, dp = _cpu_mesh(2, tp=2), _cpu_mesh(2)
    if entry == "Trainer":
        tts = [_trainer(m) for m in (mesh, dp)]
        params = tts[1].init_state(torch.Generator().manual_seed(0)).params
        b = tts[0].batch_frames
        g = torch.Generator().manual_seed(1)
        bits = torch.randint(0, 2, (b, tts[0].plan.frame_size, 1),
                             generator=g, dtype=torch.int32)
        rx = torch.randn(b, 7, 80, 2, generator=g)
        grads = []
        for tt, m in zip(tts, (mesh, dp)):
            tb, tr = tmesh.shard_batch(m, (bits, rx))
            _, aux = tt._mesh_step(tt._new_state(params, list(params)), tb,
                                   tr, [{}] * 2, torch.tensor(0.0),
                                   return_grads=True)
            grads.append(tt._gathered(aux["grads"]))
        assert isinstance(aux["grads"]["fft_like.wr"], torch.Tensor)
        for k in params:
            np.testing.assert_allclose(grads[0][k].numpy(),
                                       grads[1][k].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)
    elif entry == "EqualizerTrainer":
        rx_params = sweep_trainer.model.state_dict()
        tc = TrainConfig(snr=5.0, batch_size=56, msg_length=112, opt=0)
        out = []
        for m in (mesh, dp):
            tt = EqualizerTrainer(OFDMConfig(nbits=1), tc, channel="EPA",
                                  pretrained_rx=rx_params, device="cpu",
                                  mesh=m)
            g = torch.Generator().manual_seed(3)
            out.append(tt.train_step_curriculum(tt.init_state(g), g))
        (st_tp, aux_tp), (st_dp, aux_dp) = out
        for k in ("ce", "snr_mse", "chan_mse", "loss"):
            np.testing.assert_allclose(float(aux_tp[k]), float(aux_dp[k]),
                                       rtol=1e-5, err_msg=k)
        for k, v in rx_params.items():
            assert torch.equal(st_tp.params[f"receiver.{k}"], v), k
    elif entry == "ber_sweep":
        res = [tsweep.ber_sweep(sweep_trainer, torch.Generator().manual_seed(4),
                                snrs=(0,), frames_per_point=16,
                                batch_frames=8, mesh=m, log_fn=lambda *a: None)
               for m in (mesh, dp)]
        assert np.array_equal(res[0].ber, res[1].ber)
        assert np.array_equal(res[0].loss, res[1].loss)
    else:
        params = {"fft_like.wr": torch.arange(12.0).reshape(3, 4),
                  "a": torch.ones(3)}
        shards = tmesh.shard_params(mesh, params)
        assert len(shards) == 4
        for r, rank in enumerate(shards):
            assert torch.equal(rank["fft_like.wr"],
                               params["fft_like.wr"][:, 2 * (r % 2):
                                                     2 * (r % 2) + 2])
            assert torch.equal(rank["a"], params["a"])
        dims = tmesh.shard_dims(mesh, params)
        back = tmesh.gather_params(mesh, shards, dims)
        assert all(torch.equal(back[k], v) for k, v in params.items())
        reps = tmesh.shard_params(dp, params)
        assert torch.equal(reps[1]["fft_like.wr"], params["fft_like.wr"])
