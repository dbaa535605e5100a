"""The multi-process scenario of `tests/test_torch_distributed.py`: what
each process of a 2-process gloo group runs (`worker`, started by
`torch.multiprocessing.spawn`), and what the test's own process runs on the
one-process dp-2 mesh for comparison (`scenario`).  It imports no JAX, so
the spawned processes start quickly."""
from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch

from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval import sweep as tsweep
from dl_ofdm_tpu_torch.parallel import distributed as tdist
from dl_ofdm_tpu_torch.parallel import halo as thalo
from dl_ofdm_tpu_torch.parallel import mesh as tmesh
from dl_ofdm_tpu_torch.train import checkpoint as tckpt
from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
from dl_ofdm_tpu_torch.train.loop import Trainer, TrainState

TIMEOUT = datetime.timedelta(seconds=60)
THREADS = 2      # each process's CPU threads (the test's process takes as many)


def trainer(mesh, **tc):
    return Trainer(OFDMConfig(nbits=1), TrainConfig(
        snr=5.0, batch_size=112, msg_length=224, **tc),
        channel="mixRayleigh", device="cpu", mesh=mesh)


def clone(tree):
    """A detached copy of nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def scenario(mesh, inputs: dict, work: str) -> dict:
    """Everything the tests compare, on `mesh` (a one-process dp-2 mesh or
    this process's view of the 2-process one); files under `work`."""
    out = {}
    # 1. one step's gradients on given inputs (JAX's dp-2 mesh is the
    # reference, computed by the test)
    tt = trainer(mesh)
    params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    state = TrainState(params, tt.optimizer.init(params), 0,
                       tmesh.shard_params(mesh, params))
    tb, tr = tmesh.shard_batch(mesh, (torch.from_numpy(inputs["bits"]),
                                      torch.from_numpy(inputs["rx"])))
    _, aux = tt._mesh_step(state, tb, tr, [{}] * len(tb), torch.tensor(0.0),
                           return_grads=True)
    out["grads"] = clone(aux["grads"])
    # 2. three steps from one seed
    gen = torch.Generator().manual_seed(0)
    state = tt.init_state(gen)
    snr = torch.full((tt.batch_frames,), 5.0)
    for _ in range(3):
        state, aux = tt.train_step(state, gen, snr)
    out["steps"] = {"params": clone(state.params),
                    "replicas": clone(state.replicas),
                    "opt_state": clone(state.opt_state),
                    "loss": float(aux["loss"]), "conf": clone(aux["conf"])}
    # 3. fit: straight for 2 epochs, and 1 epoch then a resumed one
    writes = []
    save = tckpt.save_resume

    def counted(*a, **k):
        writes.append(a[0])
        return save(*a, **k)

    tckpt.save_resume = counted
    try:
        fits = {}
        for name, runs in (("straight", [(2, None)]),
                           ("resumed", [(1, "ck"), (2, "ck")])):
            for epochs, ck in runs:
                logs = []
                tf = trainer(mesh)
                st, info = tf.fit(max_epochs=epochs, log_fn=logs.append,
                                  ckpt_dir=ck and os.path.join(work, ck),
                                  ckpt_every=1)
            fits[name] = {"params": clone(st.params),
                          "opt_state": clone(st.opt_state),
                          "history": info["history"],
                          "best_epoch": info["best_epoch"],
                          "batch_frames": tf.batch_frames, "logs": logs}
    finally:
        tckpt.save_resume = save
    out["fit"], out["resume_writes"] = fits, len(writes)
    # 4. the equalizer stage's step
    base = Trainer(OFDMConfig(nbits=1), TrainConfig(), device="cpu")
    rx_params = base.init_state(torch.Generator().manual_seed(0)).params
    te = EqualizerTrainer(OFDMConfig(nbits=1), TrainConfig(
        snr=5.0, batch_size=112, msg_length=224, opt=0),
        channel="mixRayleigh", pretrained_rx=rx_params, device="cpu",
        mesh=mesh)
    g = torch.Generator().manual_seed(1)
    st = te.init_state(g)
    st, aux = te.train_step_curriculum(st, g)
    out["eq"] = {"params": clone(st.params), "replicas": clone(st.replicas),
                 "aux": {k: float(aux[k]) for k in
                         ("ce", "loss", "snr_mse", "chan_mse")},
                 "rx": clone(rx_params)}
    # 5. both sweep protocols
    ts = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=14,
                                                  msg_length=98),
                 channel="AWGN", device="cpu")
    ts.init_state(torch.Generator().manual_seed(0))
    out["sweeps"] = {}
    for protocol in ("interleaved", "point_batch"):
        logs = []
        res = tsweep.ber_sweep(ts, torch.Generator().manual_seed(5),
                               snrs=(0, 10), frames_per_point=64,
                               batch_frames=32, log_fn=logs.append,
                               mesh=mesh,
                               point_batch=protocol == "point_batch")
        out["sweeps"][protocol] = (res.ber, res.loss, len(logs))
    # 6. the halo FIR, both exchanges, on this mesh's ranks
    x, h = (torch.from_numpy(inputs[k]) for k in ("x", "h"))
    p = mesh.devices.size
    shards = list(torch.chunk(x, p, dim=1))
    local = [shards[r] for r in mesh.local_ranks]
    out["halo"] = {e: [y.clone() for y in thalo.halo_fir_same_iq(
        local, h, 6, mesh, exchange=e)] for e in ("ppermute", "dma")}
    out["whole"] = fir_same_iq(x, h, np.full(x.shape[0], 6))
    return out


def refusals(rank: int, world: int, work: str) -> dict:
    """The refusals that need a group: a tp row across processes,
    mismatched device counts and world sizes, two NCCL ranks on one card
    (the card check on fake keys through a store)."""
    out = {}

    def caught(fn, exc):
        try:
            fn()
        except exc as e:
            return str(e)
        return None

    out["tp_across"] = caught(
        lambda: tmesh.make_mesh(["cpu"], dp=1, tp=2), NotImplementedError)
    out["device_counts"] = caught(
        lambda: tmesh.make_mesh(["cpu"] * (rank + 1)), ValueError)
    out["world_env"] = caught(
        lambda: tdist.initialize_multihost(num_processes=3, device="cpu"),
        ValueError)
    env = os.environ.pop("WORLD_SIZE")
    try:
        out["world_group"] = caught(
            lambda: tdist.initialize_multihost("localhost:1", 3, rank,
                                               device="cpu"), ValueError)
    finally:
        os.environ["WORLD_SIZE"] = env
    store = torch.distributed.FileStore(os.path.join(work, "cards"), world)
    keys = tdist.store_gather(store, rank, world, "card", "host/GPU-0")
    out["one_card"] = caught(lambda: tdist.check_one_rank_a_card(keys),
                             RuntimeError)
    logs = []
    tdist.scaling_efficiency(lambda n: (lambda: None), lambda n: (),
                             device_counts=(1,), iters=1,
                             log_fn=logs.append, device="cpu")
    out["scaling_logs"] = len(logs)
    return out


def worker(rank: int, world: int, port: int, work: str) -> None:
    """One process of the group: joins it from torchrun's variables, runs
    the scenario and the refusals on its view of the dp-2 mesh (and a
    4-rank halo with two ranks a process), leaves, joins a second group
    from arguments, and saves what it saw to `work/rank<r>.pt`.  An error
    is written to `work/error<r>.txt` before it propagates."""
    try:
        torch.set_num_threads(THREADS)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        info = tdist.initialize_multihost(device="cpu", timeout=TIMEOUT)
        inputs = dict(np.load(os.path.join(work, "inputs.npz")))
        inputs["params"] = {k[2:]: inputs.pop(k) for k in list(inputs)
                            if k.startswith("p.")}
        mesh = tmesh.make_mesh(["cpu"], dp=world)
        out = scenario(mesh, inputs, os.path.join(work, "multi"))
        out["info"] = (info.rank, info.world, info.backend, str(info.device))
        out["mesh"] = (mesh.local_rows, mesh.local_ranks, mesh.home.type,
                       mesh.process.tolist())
        mesh4 = tmesh.make_mesh(["cpu", "cpu"], dp=2 * world)
        x, h = (torch.from_numpy(inputs[k]) for k in ("x", "h"))
        shards = list(torch.chunk(x, 2 * world, dim=1))
        out["halo4"] = [y.clone() for y in thalo.halo_fir_same_iq(
            [shards[r] for r in mesh4.local_ranks], h, 6, mesh4)]
        out["halo4_ranks"] = mesh4.local_ranks
        out["refusals"] = refusals(rank, world, work)
        tdist.shutdown()
        # a second group, from arguments
        info2 = tdist.initialize_multihost(
            f"file://{os.path.join(work, 'rendezvous')}", world, rank,
            device="cpu", timeout=TIMEOUT)
        t = tdist.all_sum_(torch.tensor([rank + 1.0]))
        out["args_group"] = (info2.world, info2.backend, float(t))
        tdist.shutdown()
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(work, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def ipc_ring_worker(rank: int, world: int, port: int, work: str) -> None:
    """One process of the ring's IPC route on one card (gloo named, as
    NCCL refuses two ranks on one card): `ring_exchange_across` at two
    shapes, twice each (the epochs advance), and the halo FIR with
    exchange 'dma', each against the plain version over the whole ring;
    the counts saved to `work/rank<r>.pt`."""
    try:
        tdist.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                   backend="gloo", device="cuda:0",
                                   timeout=TIMEOUT)
        dev = torch.device("cuda", 0)
        mesh = tmesh.make_mesh([dev, dev], dp=2 * world)
        out = {"equal": []}
        gen = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn(5, 8 * 40, 2, device=dev, generator=gen)
        h = torch.randn(5, 13, 2, device=dev, generator=gen)
        shards = list(torch.chunk(x, 2 * world, dim=1))
        before = thalo.ring_exchange_across.launches
        for hl, hr in ((6, 6), (3, 1), (6, 6), (3, 1)):
            lt = [s[:, -hl:, :] for s in shards]
            rh = [s[:, :hr, :] for s in shards]
            want = thalo.ring_exchange_ref(lt, rh)
            got = thalo.ring_exchange_across(
                [lt[r] for r in mesh.local_ranks],
                [rh[r] for r in mesh.local_ranks], mesh)
            out["equal"].append(all(
                torch.equal(a, want[side][r]) for side in (0, 1)
                for a, r in zip(got[side], mesh.local_ranks)))
        y = thalo.halo_fir_same_iq([shards[r] for r in mesh.local_ranks],
                                   h, 6, mesh, exchange="dma")
        whole = torch.chunk(fir_same_iq(x, h, np.full(5, 6)), 2 * world,
                            dim=1)
        out["equal"].append(all(torch.equal(a, whole[r])
                                for a, r in zip(y, mesh.local_ranks)))
        torch.cuda.synchronize()
        out["launches"] = thalo.ring_exchange_across.launches - before
        thalo.release_rings()
        tdist.shutdown()
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(work, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
