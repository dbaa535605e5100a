"""The multi-process scenarios of `tests/test_torch_distributed.py`: what
each process of a 2-process gloo group runs (`worker`) and of a 4-process
one (`worker4`), both started by `torch.multiprocessing.spawn`, and what
the test's own process runs on the one-process meshes of the same grids
for comparison (`scenario` on dp 2, `tp_scenario` on the tp grids: dp 1 x
tp 2 and dp 1 x tp 4 over two processes, dp 2 x tp 2 and dp 1 x tp 4 over
four).  It imports no JAX, so the spawned processes start quickly."""
from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch

from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval import sweep as tsweep
from dl_ofdm_tpu_torch.models.receiver import SingleGraphEqualizedRx
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
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


class Writes:
    """Counts the checkpoint files this process writes (`_write_npz`)."""

    def __enter__(self):
        self.n, self._orig = 0, tckpt._write_npz

        def counted(*a, **k):
            self.n += 1
            return self._orig(*a, **k)

        tckpt._write_npz = counted
        return self

    def __exit__(self, *exc):
        tckpt._write_npz = self._orig


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
    # 3. fit: straight for 2 epochs, and 1 epoch then a resumed one (the
    # resume payloads this process writes counted)
    fits = {}
    with Writes() as writes:
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
    out["fit"], out["resume_writes"] = fits, writes.n
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


# the tp grids of the tp scenarios: (dp, tp, devices a process) by world
TP_LAYOUTS = {2: ((1, 2, 1), (1, 4, 2)), 4: ((2, 2, 1), (1, 4, 1))}


def tp_scenario(mesh, inputs: dict, work: str) -> dict:
    """What the tests compare on a tp `mesh` (a one-process mesh of
    virtual ranks or this process's view of one over processes): one
    step's gradients on given inputs, three steps, `fit` and a resumed
    `fit`, a checkpoint round trip, the equalizer stage's step (its
    gradients in float64), `SingleGraphEqualizedRx` on tp (float64), both
    sweep protocols; the files each process writes.  Split leaves and
    their moments are gathered (collective over processes).  The steps
    clip the gradient's global norm (over every shard of every
    process)."""
    out = {}
    tt = trainer(mesh, grad_clip=0.1)

    def moments(tr, st):
        return {m: clone(tr._gathered(st.opt_state[m]))
                for m in ("mu", "nu")}

    # 1. one step's gradients on given inputs (JAX's tp mesh is the
    # reference, computed by the test)
    params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    state = tt._new_state(params, list(params))
    tb, tr = tmesh.shard_batch(mesh, (torch.from_numpy(inputs["bits"]),
                                      torch.from_numpy(inputs["rx"])))
    _, aux = tt._mesh_step(state, tb, tr, [{}] * len(tb), torch.tensor(0.0),
                           return_grads=True)
    out["grads"] = clone(tt._gathered(aux["grads"]))
    # 2. three steps from one seed
    gen = torch.Generator().manual_seed(0)
    state = tt.init_state(gen)
    snr = torch.full((tt.batch_frames,), 5.0)
    for _ in range(3):
        state, aux = tt.train_step(state, gen, snr)
    again = tmesh.shard_params(mesh, state.params)
    out["steps"] = {"params": clone(state.params),
                    "opt_state": moments(tt, state),
                    "loss": float(aux["loss"]), "conf": clone(aux["conf"]),
                    "shards_match": all(
                        torch.equal(a[k], b[k]) for a, b in
                        zip(state.replicas, again) for k in b)}
    # 3. a checkpoint round trip: process 0 writes the gathered file, every
    # process reads its own shards back
    with Writes() as w:
        path = tckpt.save(os.path.join(work, "ck_state"), state, mesh=mesh)
    got = tckpt.restore(path, tt.init_state(torch.Generator().manual_seed(9)),
                        mesh=mesh)
    out["ckpt"] = {"writes": w.n, "same": got.step == state.step and all(
        torch.equal(a, b) for m in ("mu", "nu")
        for v, u in zip(state.opt_state[m].values(),
                        got.opt_state[m].values())
        for a, b in zip(v if isinstance(v, list) else [v],
                        u if isinstance(u, list) else [u])) and all(
        torch.equal(got.params[k], v) for k, v in state.params.items())}
    # 4. fit: straight for 2 epochs, and 1 epoch then a resumed one
    fits = {}
    with Writes() as w:
        for name, runs in (("straight", [(2, None)]),
                           ("resumed", [(1, "ck"), (2, "ck")])):
            for epochs, ck in runs:
                logs = []
                tf = trainer(mesh)
                st, info = tf.fit(max_epochs=epochs, log_fn=logs.append,
                                  ckpt_dir=ck and os.path.join(work, ck),
                                  ckpt_every=1)
            fits[name] = {"params": clone(st.params),
                          "opt_state": moments(tf, st),
                          "history": info["history"], "logs": logs}
    out["fit"], out["fit_writes"] = fits, w.n
    # 5. the equalizer stage (opt 12): the float64 gradients on given
    # inputs, then a float32 curriculum step on the plain data plane
    base = Trainer(OFDMConfig(nbits=1), TrainConfig(), device="cpu")
    rx_params = base.init_state(torch.Generator().manual_seed(0)).params
    te = EqualizerTrainer(OFDMConfig(nbits=1), TrainConfig(
        snr=5.0, batch_size=56, msg_length=112, opt=12),
        channel="mixRayleigh", pretrained_rx=rx_params, device="cpu",
        mesh=mesh)
    g = torch.Generator().manual_seed(1)
    st = te.init_state(g)
    p64 = {k: v.double() for k, v in st.params.items()}
    b = te.batch_frames
    eb, ex = tmesh.shard_batch(mesh, (
        torch.from_numpy(inputs["bits"][:b]),
        torch.from_numpy(inputs["rx"][:b]).double()))
    _, aux = te._mesh_step(te._new_state(p64, te._trainable), eb, ex,
                           [{}] * len(eb), torch.tensor(0.0),
                           return_grads=True)
    eq = {"grads64": clone(te._gathered(aux["grads"]))}
    st, aux = te.train_step_curriculum(st, g)
    eq.update(params=clone(st.params), aux={k: float(aux[k]) for k in (
        "ce", "loss", "snr_mse", "chan_mse")},
        moment_keys=sorted(st.opt_state["mu"]),
        frozen=all(torch.equal(st.params[f"receiver.{k}"], v)
                   for k, v in rx_params.items()))
    out["eq"] = eq
    # 6. SingleGraphEqualizedRx on tp (float64): gradients and a step
    cfg = OFDMConfig(nbits=1, nfilter=32)
    plan = build_plan(cfg)
    model = SingleGraphEqualizedRx(1, 64, plan.cp_len, 32, plan.frame_size,
                                   7, plan.pilot_size).double()
    sg = Trainer(cfg, TrainConfig(snr=5.0, batch_size=28, msg_length=56),
                 channel="AWGN", model=model, device="cpu", mesh=mesh)
    p64 = {k: v.double() for k, v in sg.init_state(
        torch.Generator().manual_seed(3)).params.items()}
    b = sg.batch_frames
    sb, sx = tmesh.shard_batch(mesh, (
        torch.from_numpy(inputs["bits"][:b]),
        torch.from_numpy(inputs["rx"][:b]).double()))
    new, aux = sg._mesh_step(sg._new_state(p64, list(p64)), sb, sx,
                             [{}] * len(sb), torch.tensor(0.0),
                             return_grads=True)
    out["sg"] = {"grads": clone(sg._gathered(aux["grads"])),
                 "params": clone(new.params), "loss": float(aux["loss"])}
    # 7. both sweep protocols
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
    return out


def layout(mesh) -> tuple:
    """The process of each rank, this process's ranks, each row's owner."""
    return (mesh.process.tolist(), mesh.local_ranks,
            [mesh.owner(r) for r in range(mesh.shape["dp"])])


def refusals(rank: int, world: int, work: str) -> dict:
    """The refusals that need a group: mismatched device counts and world
    sizes, two NCCL ranks on one card (the card check on fake keys through
    a store); and the layout of a tp row across the processes, which is
    no longer refused."""
    out = {}

    def caught(fn, exc):
        try:
            fn()
        except exc as e:
            return str(e)
        return None

    out["tp_across"] = layout(tmesh.make_mesh(["cpu"], dp=1, tp=2))
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
        out["tp"] = tp_runs(world, inputs, work)
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


def tp_runs(world: int, inputs: dict, work: str) -> dict:
    """`tp_scenario` on this process's view of each tp grid of
    TP_LAYOUTS[world], keyed (dp, tp), with the mesh's layout."""
    out = {}
    for dp, tp, per in TP_LAYOUTS[world]:
        mesh = tmesh.make_mesh(["cpu"] * per, dp=dp, tp=tp)
        out[(dp, tp)] = tp_scenario(mesh, inputs, os.path.join(
            work, f"tp{dp}x{tp}"))
        out[(dp, tp)]["layout"] = layout(mesh)
    return out


def worker4(rank: int, world: int, port: int, work: str) -> None:
    """One process of the 4-process group: `tp_runs` on its grids, saved
    to `work/rank<r>.pt` (an error to `work/error<r>.txt`)."""
    try:
        torch.set_num_threads(THREADS)
        tdist.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                   device="cpu", timeout=TIMEOUT)
        inputs = dict(np.load(os.path.join(work, "inputs.npz")))
        inputs["params"] = {k[2:]: inputs.pop(k) for k in list(inputs)
                            if k.startswith("p.")}
        out = {"tp": tp_runs(world, inputs, work)}
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
