"""The port's multi-process data parallelism on the CPU: two processes of a
gloo group (`torch.multiprocessing.spawn`, once for the module;
`tests/torch_dist_worker.py` is what each runs) against the one-process
dp-2 mesh of virtual ranks and against JAX's dp-2 mesh.

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
whole block.  Every rendezvous is on a free port or a file in the
module's temporary directory, so parallel test workers never collide."""
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two processes' results, the one-process mesh's, JAX's dp-2
    gradients): the inputs made from a seed, JAX's gradients, one spawn
    of the group, then the one-process scenario."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    work = str(tmp_path_factory.mktemp("dist"))
    rng = np.random.default_rng(0)
    jtc = JTc(snr=5.0, batch_size=112, msg_length=224)
    jt = JTrainer(JCfg(nbits=1), jtc, channel="mixRayleigh")
    jparams = jt.init_state(jax.random.PRNGKey(0)).params
    b = jt.batch_frames
    bits = rng.integers(0, 2, (b, jt.plan.frame_size, 1)).astype(np.int32)
    rx = rng.normal(size=(b, 7, 80, 2)).astype(np.float32)
    jm = jmesh.make_mesh(jax.devices()[:WORLD], dp=WORLD, tp=1)
    jm_tr = JTrainer(JCfg(nbits=1), jtc, channel="mixRayleigh", mesh=jm)
    bits_m, rx_m = jmesh.shard_batch(jm, (jnp.asarray(bits), jnp.asarray(rx)))
    params_m = jax.device_put(jparams, NamedSharding(jm, P()))
    want = tckpt.params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(
        jm_tr._loss_fn, has_aux=True))(params_m, bits_m, rx_m)[0]))
    params = tckpt.params_from_flax(jax.tree.map(np.asarray, jparams))
    inputs = {"bits": bits, "rx": rx,
              "x": rng.normal(size=(3, 80, 2)).astype(np.float32),
              "h": rng.normal(size=(3, 13, 2)).astype(np.float32),
              **{f"p.{k}": v.numpy() for k, v in params.items()}}
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    torch.multiprocessing.spawn(W.worker, args=(WORLD, _free_port(), work),
                                nprocs=WORLD, join=True)
    multi = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    inputs["params"] = {k[2:]: inputs.pop(k) for k in list(inputs)
                        if k.startswith("p.")}
    # the workers' thread count: a CPU convolution's sums depend on it
    threads = torch.get_num_threads()
    torch.set_num_threads(W.THREADS)
    try:
        single = W.scenario(tmesh.make_mesh(["cpu"] * WORLD, dp=WORLD),
                            inputs, os.path.join(work, "single"))
    finally:
        torch.set_num_threads(threads)
    return multi, single, want, inputs


def test_groups_from_torchrun_variables_and_from_arguments(runs):
    multi, _, _, _ = runs
    for r, out in enumerate(multi):
        assert out["info"] == (r, WORLD, "gloo", "cpu")
        # the second group, from (coordinator, num_processes, process_id)
        assert out["args_group"] == (WORLD, "gloo", 3.0)
        assert out["mesh"] == ([r], [r], "cpu", [[0], [1]])
        assert out["halo4_ranks"] == [2 * r, 2 * r + 1]


def test_refusals_in_a_group(runs):
    for r, out in enumerate(runs[0]):
        ref = out["refusals"]
        assert "Queue A item 17" in ref["tp_across"]
        assert "different device counts" in ref["device_counts"]
        assert "does not match WORLD_SIZE 2" in ref["world_env"]
        assert "exists already" in ref["world_group"]
        assert "same card" in ref["one_card"] and "gloo" in ref["one_card"]
        assert ref["scaling_logs"] == (1 if r == 0 else 0)


def test_one_card_check_is_pure():
    tdist.check_one_rank_a_card(["h/a", "h/b", "g/a"])
    with pytest.raises(RuntimeError, match="ranks 0 and 2"):
        tdist.check_one_rank_a_card(["h/a", "h/b", "h/a"])


def test_step_gradients_match_jax_dp2_mesh(runs):
    """Both processes' gradients against JAX's dp-2 mesh gradients on the
    same inputs (the test_torch_parallel tolerance), and bit-identical to
    the one-process mesh's."""
    multi, single, want, _ = runs
    for out in multi:
        assert _equal(out["grads"], single["grads"])
        for k in want:
            np.testing.assert_allclose(out["grads"][k].numpy(),
                                       want[k].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)


def test_three_steps_bit_identical_to_one_process_mesh(runs):
    multi, single, _, _ = runs
    for out in multi:
        for k in ("params", "opt_state", "loss", "conf"):
            assert _equal(out["steps"][k], single["steps"][k]), k
        for rep in out["steps"]["replicas"]:
            assert _equal(rep, out["steps"]["params"])
    assert len(multi[0]["steps"]["replicas"]) == 1
    assert len(single["steps"]["replicas"]) == WORLD


def test_fit_decisions_agree_and_only_process_0_writes(runs):
    multi, single, _, _ = runs
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
    multi, single, _, _ = runs
    for out in multi + [single]:
        res, straight = out["fit"]["resumed"], out["fit"]["straight"]
        assert _equal(res["params"], straight["params"])
        assert _equal(res["opt_state"], straight["opt_state"])
        assert _equal(res["history"], straight["history"][1:])
        assert not res["logs"] or res["logs"][0].startswith("resumed from")
    assert multi[0]["fit"]["resumed"]["logs"][0].startswith("resumed from")


def test_equalizer_step_matches_and_keeps_the_receiver_frozen(runs):
    multi, single, _, _ = runs
    for out in multi:
        assert _equal(out["eq"]["params"], single["eq"]["params"])
        assert out["eq"]["aux"] == single["eq"]["aux"]
        for rep in [out["eq"]["params"]] + out["eq"]["replicas"]:
            for k, v in out["eq"]["rx"].items():
                assert torch.equal(rep[f"receiver.{k}"], v), k


@pytest.mark.parametrize("protocol", ["interleaved", "point_batch"])
def test_sweep_counts_equal_one_process_mesh(runs, protocol):
    multi, single, _, _ = runs
    ber, loss, logs = single["sweeps"][protocol]
    assert np.all(np.isfinite(ber)) and logs == 2
    for r, out in enumerate(multi):
        got_ber, got_loss, got_logs = out["sweeps"][protocol]
        np.testing.assert_array_equal(got_ber, ber)
        np.testing.assert_array_equal(got_loss, loss)
        assert got_logs == (2 if r == 0 else 0)


@pytest.mark.parametrize("exchange", ["ppermute", "dma"])
def test_halo_fir_across_processes_bit_equal(runs, exchange):
    multi, single, _, _ = runs
    whole = single["whole"]
    p = WORLD
    want = list(torch.chunk(whole, p, dim=1))
    assert torch.equal(torch.cat(single["halo"][exchange], dim=1), whole)
    for r, out in enumerate(multi):
        (got,) = out["halo"][exchange]
        assert torch.equal(got, want[r])


def test_halo_fir_two_ranks_a_process_bit_equal(runs):
    multi, single, _, _ = runs
    got = torch.cat([y for out in multi for y in out["halo4"]], dim=1)
    assert torch.equal(got, single["whole"])
