"""The port's multi-process data and tensor parallelism on the CPU: two
processes of a gloo group and four (`torch.multiprocessing.spawn`, once
each for the module; `tests/torch_dist_worker.py` is what each runs)
against the one-process meshes of virtual ranks of the same grids and
against JAX's meshes.

What is held: `initialize_multihost` from torchrun's variables and from
its arguments, and its refusals; the mesh's layout over processes; one
step's gradients within rtol 2e-4 / atol 2e-5 of JAX's dp-2 mesh
gradients (as `tests/test_torch_parallel.py` holds the one-process mesh);
three steps, `fit`, a resumed `fit`, the equalizer stage's step and both
sweep protocols bit-identical to the one-process dp-2 mesh (the rows'
sums are taken in row order in both, and the CPU kernels are
deterministic), replicas identical in both processes, only process 0
logging and writing resume payloads; the halo FIR across processes (both
exchanges, and two ranks a process) bit-equal to `fir_same_iq` of the
whole block.

Tensor parallelism with tp rows across processes, at dp 1 x tp 2 (two
processes, one rank each), dp 1 x tp 4 (two processes, two ranks each),
dp 2 x tp 2 and dp 1 x tp 4 (four processes, one rank each): each mesh's
layout; one step's gradients within rtol 2e-4 / atol 1e-6 of JAX's tp
mesh on its 8 virtual CPU devices (the tolerance of
`tests/test_torch_tp.py`) and bit-identical to the one-process mesh of
the same grid, as are three steps, `fit`, a resumed `fit`, a checkpoint
round trip, the equalizer stage (its gradients in float64, the receiver
frozen, Adam on the `Equalizer` keys only), `SingleGraphEqualizedRx` on
tp (float64) and both sweep protocols; only process 0 writes.  Every
rendezvous is on a free port or a file in the module's temporary
directory, so parallel test workers never collide."""
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.parallel import mesh as jmesh
from dl_ofdm_tpu.train.loop import Trainer as JTrainer
from dl_ofdm_tpu_torch.parallel import distributed as tdist
from dl_ofdm_tpu_torch.parallel import mesh as tmesh
from dl_ofdm_tpu_torch.train import checkpoint as tckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

WORLD = 2
# (processes, dp, tp) of the tp layouts
TP_CASES = [(w, dp, tp) for w, grids in W.TP_LAYOUTS.items()
            for dp, tp, _ in grids]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _equal(a, b) -> bool:
    """Nested dicts and lists of tensors equal leaf for leaf."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _inputs():
    """The step's inputs made from a seed, JAX's initial parameters and
    its trainer config."""
    rng = np.random.default_rng(0)
    jtc = JTc(snr=5.0, batch_size=112, msg_length=224)
    jt = JTrainer(JCfg(nbits=1), jtc, channel="mixRayleigh")
    jparams = jt.init_state(jax.random.PRNGKey(0)).params
    b = jt.batch_frames
    bits = rng.integers(0, 2, (b, jt.plan.frame_size, 1)).astype(np.int32)
    rx = rng.normal(size=(b, 7, 80, 2)).astype(np.float32)
    params = tckpt.params_from_flax(jax.tree.map(np.asarray, jparams))
    inputs = {"bits": bits, "rx": rx,
              "x": rng.normal(size=(3, 80, 2)).astype(np.float32),
              "h": rng.normal(size=(3, 13, 2)).astype(np.float32),
              **{f"p.{k}": v.numpy() for k, v in params.items()}}
    return inputs, jparams, jtc


def _spawn(fn, world: int, work: str, inputs: dict) -> list:
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    torch.multiprocessing.spawn(fn, args=(world, _free_port(), work),
                                nprocs=world, join=True)
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _with_params(inputs: dict) -> dict:
    out = {k: v for k, v in inputs.items() if not k.startswith("p.")}
    out["params"] = {k[2:]: v for k, v in inputs.items()
                     if k.startswith("p.")}
    return out


def _tp_single(inputs: dict, dp: int, tp: int, work: str) -> dict:
    """`tp_scenario` on the one-process mesh of the grid, on the workers'
    thread count (a CPU convolution's sums depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(W.THREADS)
    try:
        return W.tp_scenario(tmesh.make_mesh(["cpu"] * (dp * tp), dp=dp,
                                             tp=tp), _with_params(inputs),
                             os.path.join(work, f"single{dp}x{tp}"))
    finally:
        torch.set_num_threads(threads)


def _jax_tp_grads(jparams, jtc, inputs, dp: int, tp: int) -> dict:
    """JAX's gradients on its dp x tp mesh of virtual CPU devices, the
    parameters sharded by its rules."""
    jm = jmesh.make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)
    jt = JTrainer(JCfg(nbits=1), jtc, channel="mixRayleigh", mesh=jm)
    bits, rx = jnp.asarray(inputs["bits"]), jnp.asarray(inputs["rx"])
    return tckpt.params_from_flax(jax.tree.map(np.asarray, jax.jit(
        lambda p: jax.grad(lambda q: jt._loss_fn(q, bits, rx)[0])(p))(
            jmesh.shard_params(jm, jparams))))


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    """The four processes' results, the one-process meshes' and JAX's
    gradients, for the 4-process tp grids."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    work = str(tmp_path_factory.mktemp("dist4"))
    inputs, jparams, jtc = _inputs()
    multi = _spawn(W.worker4, 4, work, inputs)
    grids = [(dp, tp) for dp, tp, _ in W.TP_LAYOUTS[4]]
    return {"multi": [m["tp"] for m in multi],
            "single": {g: _tp_single(inputs, *g, work) for g in grids},
            "jax": {g: _jax_tp_grads(jparams, jtc, inputs, *g)
                    for g in grids}}


@pytest.fixture
def tp_run(request, runs, runs4):
    """(each process's tp results, the one-process mesh's, JAX's
    gradients) of one tp case."""
    world, dp, tp = request.param
    if world == WORLD:
        multi = [m["tp"][(dp, tp)] for m in runs[0]]
        return multi, runs[4]["single"][(dp, tp)], runs[4]["jax"][(dp, tp)]
    r = runs4
    return ([m[(dp, tp)] for m in r["multi"]], r["single"][(dp, tp)],
            r["jax"][(dp, tp)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two processes' results, the one-process mesh's, JAX's dp-2
    gradients): the inputs made from a seed, JAX's gradients, one spawn
    of the group, then the one-process scenario."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    work = str(tmp_path_factory.mktemp("dist"))
    inputs, jparams, jtc = _inputs()
    jm = jmesh.make_mesh(jax.devices()[:WORLD], dp=WORLD, tp=1)
    jm_tr = JTrainer(JCfg(nbits=1), jtc, channel="mixRayleigh", mesh=jm)
    bits_m, rx_m = jmesh.shard_batch(jm, (jnp.asarray(inputs["bits"]),
                                          jnp.asarray(inputs["rx"])))
    params_m = jax.device_put(jparams, NamedSharding(jm, P()))
    want = tckpt.params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(
        jm_tr._loss_fn, has_aux=True))(params_m, bits_m, rx_m)[0]))
    multi = _spawn(W.worker, WORLD, work, inputs)
    # the workers' thread count: a CPU convolution's sums depend on it
    threads = torch.get_num_threads()
    torch.set_num_threads(W.THREADS)
    try:
        single = W.scenario(tmesh.make_mesh(["cpu"] * WORLD, dp=WORLD),
                            _with_params(inputs),
                            os.path.join(work, "single"))
    finally:
        torch.set_num_threads(threads)
    grids = [(dp, tp) for dp, tp, _ in W.TP_LAYOUTS[WORLD]]
    tp = {"single": {g: _tp_single(inputs, *g, work) for g in grids},
          "jax": {g: _jax_tp_grads(jparams, jtc, inputs, *g) for g in grids}}
    return multi, single, want, _with_params(inputs), tp


def test_groups_from_torchrun_variables_and_from_arguments(runs):
    multi = runs[0]
    for r, out in enumerate(multi):
        assert out["info"] == (r, WORLD, "gloo", "cpu")
        # the second group, from (coordinator, num_processes, process_id)
        assert out["args_group"] == (WORLD, "gloo", 3.0)
        assert out["mesh"] == ([r], [r], "cpu", [[0], [1]])
        assert out["halo4_ranks"] == [2 * r, 2 * r + 1]


def test_refusals_in_a_group(runs):
    for r, out in enumerate(runs[0]):
        ref = out["refusals"]
        # a tp row across the two processes: no longer refused
        assert ref["tp_across"] == ([[0, 1]], [r], [0])
        assert "different device counts" in ref["device_counts"]
        assert "does not match WORLD_SIZE 2" in ref["world_env"]
        assert "exists already" in ref["world_group"]
        assert "same card" in ref["one_card"] and "gloo" in ref["one_card"]
        assert ref["scaling_logs"] == (1 if r == 0 else 0)


def test_mesh_of_ranks_across_processes_is_pure():
    """A process owns ranks: with 3 devices a process and tp 2 (a row that
    a tp does not divide per process), the rows each process holds a
    rank of, its tp indices, the rows it owns, its device in a row; and a
    process that owns no rank is refused."""
    grid = np.empty((3, 2), dtype=object)
    grid[:] = torch.device("cpu")
    process = np.repeat(np.arange(2), 3).reshape(3, 2)   # [[0 0] [0 1] [1 1]]
    m0 = tmesh.Mesh(grid, process, 0)
    m1 = tmesh.Mesh(grid, process, 1)
    assert (m0.local_ranks, m0.local_rows, m0.local_tps) == (
        [0, 1, 2], [0, 1], [0, 1])
    assert (m1.local_ranks, m1.local_rows, m1.local_tps) == (
        [3, 4, 5], [1, 2], [0, 1])
    assert [m0.owner(r) for r in range(3)] == [0, 0, 1]
    assert (m0.owned_rows, m1.owned_rows) == ([0, 1], [2])
    assert (m0.row_slots(1), m1.row_slots(1)) == ([2], [0])
    assert m1.tp_slot(0) == 1 and m0.tps_local and m1.multiprocess
    assert not tmesh.Mesh(grid[:1], np.array([[0, 1]]), 1).tps_local
    with pytest.raises(ValueError, match="process 2 owns no rank"):
        tmesh.Mesh(grid, process, 2)


def test_one_card_check_is_pure():
    tdist.check_one_rank_a_card(["h/a", "h/b", "g/a"])
    with pytest.raises(RuntimeError, match="ranks 0 and 2"):
        tdist.check_one_rank_a_card(["h/a", "h/b", "h/a"])


def test_step_gradients_match_jax_dp2_mesh(runs):
    """Both processes' gradients against JAX's dp-2 mesh gradients on the
    same inputs (the test_torch_parallel tolerance), and bit-identical to
    the one-process mesh's."""
    multi, single, want = runs[:3]
    for out in multi:
        assert _equal(out["grads"], single["grads"])
        for k in want:
            np.testing.assert_allclose(out["grads"][k].numpy(),
                                       want[k].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)


def test_three_steps_bit_identical_to_one_process_mesh(runs):
    multi, single = runs[:2]
    for out in multi:
        for k in ("params", "opt_state", "loss", "conf"):
            assert _equal(out["steps"][k], single["steps"][k]), k
        for rep in out["steps"]["replicas"]:
            assert _equal(rep, out["steps"]["params"])
    assert len(multi[0]["steps"]["replicas"]) == 1
    assert len(single["steps"]["replicas"]) == WORLD


def test_fit_decisions_agree_and_only_process_0_writes(runs):
    multi, single = runs[:2]
    fits = [out["fit"]["straight"] for out in multi]
    for f in fits:
        for k in ("history", "best_epoch", "batch_frames", "params",
                  "opt_state"):
            assert _equal(f[k], single["fit"]["straight"][k]), k
    assert len(fits[0]["history"]) == 2
    assert len(fits[0]["logs"]) == 2 and fits[1]["logs"] == []
    # one resume payload an epoch of the ckpt runs (1 + 1), process 0 only
    assert [out["resume_writes"] for out in multi] == [2, 0]
    assert single["resume_writes"] == 2


def test_resume_is_bit_identical_to_a_straight_run(runs):
    multi, single = runs[:2]
    for out in multi + [single]:
        res, straight = out["fit"]["resumed"], out["fit"]["straight"]
        assert _equal(res["params"], straight["params"])
        assert _equal(res["opt_state"], straight["opt_state"])
        assert _equal(res["history"], straight["history"][1:])
        assert not res["logs"] or res["logs"][0].startswith("resumed from")
    assert multi[0]["fit"]["resumed"]["logs"][0].startswith("resumed from")


def test_equalizer_step_matches_and_keeps_the_receiver_frozen(runs):
    multi, single = runs[:2]
    for out in multi:
        assert _equal(out["eq"]["params"], single["eq"]["params"])
        assert out["eq"]["aux"] == single["eq"]["aux"]
        for rep in [out["eq"]["params"]] + out["eq"]["replicas"]:
            for k, v in out["eq"]["rx"].items():
                assert torch.equal(rep[f"receiver.{k}"], v), k


@pytest.mark.parametrize("protocol", ["interleaved", "point_batch"])
def test_sweep_counts_equal_one_process_mesh(runs, protocol):
    multi, single = runs[:2]
    ber, loss, logs = single["sweeps"][protocol]
    assert np.all(np.isfinite(ber)) and logs == 2
    for r, out in enumerate(multi):
        got_ber, got_loss, got_logs = out["sweeps"][protocol]
        np.testing.assert_array_equal(got_ber, ber)
        np.testing.assert_array_equal(got_loss, loss)
        assert got_logs == (2 if r == 0 else 0)


@pytest.mark.parametrize("exchange", ["ppermute", "dma"])
def test_halo_fir_across_processes_bit_equal(runs, exchange):
    multi, single = runs[:2]
    whole = single["whole"]
    p = WORLD
    want = list(torch.chunk(whole, p, dim=1))
    assert torch.equal(torch.cat(single["halo"][exchange], dim=1), whole)
    for r, out in enumerate(multi):
        (got,) = out["halo"][exchange]
        assert torch.equal(got, want[r])


def test_halo_fir_two_ranks_a_process_bit_equal(runs):
    multi, single = runs[:2]
    got = torch.cat([y for out in multi for y in out["halo4"]], dim=1)
    assert torch.equal(got, single["whole"])


# -- tensor parallelism with tp rows across processes ------------------------

@pytest.mark.parametrize("tp_run", TP_CASES, indirect=True,
                         ids=[f"{w}proc-dp{d}xtp{t}" for w, d, t in TP_CASES])
def test_tp_layout_gradients_match_jax_and_one_process_mesh(tp_run):
    """Each process's view of the grid (the process of each rank, its own
    ranks, each row's owner), and one step's gradients: bit-identical to
    the one-process mesh's and within rtol 2e-4 / atol 1e-6 of JAX's tp
    mesh's."""
    multi, single, want = tp_run
    grid = multi[0]["layout"][0]
    dp, tp = len(grid), len(grid[0])
    per = dp * tp // len(multi)
    assert grid == (np.arange(dp * tp) // per).reshape(dp, tp).tolist()
    for p, out in enumerate(multi):
        procs, local, owners = out["layout"]
        assert local == list(range(p * per, (p + 1) * per))
        assert owners == [grid[r][0] for r in range(dp)]
        assert _equal(out["grads"], single["grads"])
        for k in want:
            np.testing.assert_allclose(out["grads"][k].numpy(),
                                       want[k].numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("tp_run", TP_CASES, indirect=True,
                         ids=[f"{w}proc-dp{d}xtp{t}" for w, d, t in TP_CASES])
def test_tp_steps_fit_and_resume_bit_identical(tp_run):
    """Three steps (params, Adam's moments gathered, loss, counts), a
    straight `fit` and a resumed one: bit-identical to the one-process
    mesh; each process's shards the blocks of the gathered params; the
    resumed fit equal to the straight one; process 0 alone logs and
    writes the resume payloads."""
    multi, single, _ = tp_run
    for r, out in enumerate(multi):
        assert out["steps"]["shards_match"]
        for k in ("params", "opt_state", "loss", "conf"):
            assert _equal(out["steps"][k], single["steps"][k]), k
        for name in ("straight", "resumed"):
            f, g = out["fit"][name], single["fit"][name]
            for k in ("params", "opt_state", "history"):
                assert _equal(f[k], g[k]), (name, k)
            assert bool(f["logs"]) == (r == 0)
        res, straight = out["fit"]["resumed"], out["fit"]["straight"]
        assert _equal(res["params"], straight["params"])
        assert _equal(res["opt_state"], straight["opt_state"])
        assert _equal(res["history"], straight["history"][1:])
        assert out["fit_writes"] == (single["fit_writes"] if r == 0 else 0)
    assert single["fit_writes"] == 2


@pytest.mark.parametrize("tp_run", TP_CASES, indirect=True,
                         ids=[f"{w}proc-dp{d}xtp{t}" for w, d, t in TP_CASES])
def test_tp_checkpoint_round_trip_across_processes(tp_run):
    """`save` gathers every process's shards of the moments and process 0
    alone writes the flax-layout file; `restore` gives each process its
    own shards back, bit for bit."""
    multi, single, _ = tp_run
    assert single["ckpt"] == {"writes": 1, "same": True}
    assert [out["ckpt"] for out in multi] == [
        {"writes": int(r == 0), "same": True} for r in range(len(multi))]


@pytest.mark.parametrize("tp_run", TP_CASES, indirect=True,
                         ids=[f"{w}proc-dp{d}xtp{t}" for w, d, t in TP_CASES])
def test_tp_equalizer_and_single_graph_rx_bit_identical(tp_run):
    """The equalizer stage (opt 12): its float64 gradients and a
    curriculum step bit-identical to the one-process mesh's, the receiver
    frozen, Adam's moments on the `Equalizer` keys only;
    `SingleGraphEqualizedRx` on tp (float64): gradients and step
    bit-identical."""
    multi, single, _ = tp_run
    assert single["eq"]["frozen"]
    assert all(k.startswith("Equalizer.")
               for k in single["eq"]["moment_keys"])
    for out in multi:
        assert _equal(out["eq"], single["eq"])
        assert _equal(out["sg"], single["sg"])


@pytest.mark.parametrize("tp_run", TP_CASES, indirect=True,
                         ids=[f"{w}proc-dp{d}xtp{t}" for w, d, t in TP_CASES])
def test_tp_sweeps_equal_one_process_mesh(tp_run):
    """Both protocols: counts and CE equal to the one-process mesh's;
    process 0 alone logs."""
    multi, single, _ = tp_run
    for protocol in ("interleaved", "point_batch"):
        ber, loss, logs = single["sweeps"][protocol]
        assert np.all(np.isfinite(ber)) and logs == 2
        for r, out in enumerate(multi):
            got_ber, got_loss, got_logs = out["sweeps"][protocol]
            np.testing.assert_array_equal(got_ber, ber)
            np.testing.assert_array_equal(got_loss, loss)
            assert got_logs == (2 if r == 0 else 0)
