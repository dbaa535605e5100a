"""Data-parallel training cells: `Trainer(mesh=)` on dp = W rows over W
processes, one a card (torchrun's layout), NCCL on cards and gloo on the
CPU; the mesh step's plain data plane and autograd route on every row, the
rows' gradients combined over the processes.

The run's process is rank 0; it starts ranks 1..W-1 (`spawn`), which meet
it over TCP on a free localhost port.  Every rank builds the same
`Trainer` and state (weights drawn from the seed, process 0's broadcast),
takes the first three steps with the window's own call, and one epoch
end, then the window: epochs of `msg_length / nsymbol` frames (at least
one step), each ended by `eval_step` and the agreed host read, which also
carries rank 0's decision to stop, so every rank stops after the same
step.  `train_iq_per_s` counts every rank's frames over rank 0's window.

Every rank reports the forbidden modules it holds once the window has
closed (`harness.forbidden_loaded`), and rank 0 exits without a result if
any does.  After the window rank 0 alone checks the first three steps against the
reference: each row's frames drawn again from the step's base seed plus
the row (as the port's rank generators seed them), normalized over the
row, the step's loss and gradients over all rows in float32.
"""
from __future__ import annotations

import math
import os
import socket
import time

from benchmark import harness
from benchmark.drivers import train as single


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _base_seed(torch, gen, device) -> int:
    """The draw the mesh step's rank generators are seeded from (peeked)."""
    g = torch.Generator(device=device)
    g.set_state(gen.get_state())
    return int(torch.randint(0, 2 ** 62, (1,), generator=g, device=device))


def reference_run(cell, w0, bases, device, precision):
    import torch
    from benchmark.reference import dccn, link
    cfg, tr = cell.config, cell.traffic
    o, world = cfg["ofdm"], tr["processes"]
    n = tr["frames_per_step"] // world

    def batch(base):
        rows = [link.plain_awgn_shard(base + r, n, o["nfft"], tr["snr_db"],
                                      device) for r in range(world)]
        return (torch.cat([x for _, x in rows]).float(),
                torch.cat([b for b, _ in rows]))

    out = dccn.train_steps(w0, (batch(b) for b in bases), o["nbits"],
                           cfg["train"], precision)
    out["change"] = {k: out["params"][k] - w0[k].float() for k in w0}
    return out


def run(cell, seed: int, seconds: float, trace, device, t_start: float,
        mode: str = "program", fault: str | None = None) -> dict:
    """Rank 0's run; starts the other ranks.  `device` names the kind of
    device (a card each rank, or the CPU)."""
    import torch
    import torch.multiprocessing as mp
    world = cell.traffic["processes"]
    if mode == "control":
        return _control(cell, seed, device)
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(
        r, world, port, cell, seed, seconds, trace.enabled, device.type,
        t_start, fault)) for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = _rank(0, world, port, cell, seed, seconds, trace.enabled,
                    device.type, t_start, fault, trace)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return out


def _control(cell, seed, device):
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver  # shapes only
    o = OFDMConfig(**cell.config["ofdm"])
    cp = round(0.25 * o.nfft)
    shapes = {k: tuple(v.shape) for k, v in DCCNReceiver(
        o.nbits, o.nfft, cp, o.nfilter, cell.config["frame_size"],
        o.nsymbol, compute_dtype=o.compute_dtype).state_dict().items()}
    dev = device if device.type == "cpu" else torch.device("cuda", 0)
    w0 = harness.draw_weights(shapes, harness.sub_seed(seed, "weights"), dev)
    gen = torch.Generator(device=dev).manual_seed(
        harness.sub_seed(seed, "data"))
    bases = [int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=dev))
             for _ in range(single.CHECK_STEPS)]
    prog = reference_run(cell, w0, bases, dev, "fp8")
    ref = reference_run(cell, w0, bases, dev, "float32")
    return {"attempted": 0, "failed": 0, "e2e": {}, "peak_bytes": 0,
            "readings": single.readings(prog, ref)}


def _rank(rank, world, port, cell, seed, seconds, trace_on, dev_type,
          t_start, fault, trace=None):
    import torch
    import torch.distributed as dist
    from benchmark import faults
    from benchmark.trace import Trace
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.parallel import distributed as pd
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
    from dl_ofdm_tpu_torch.train.loop import Trainer

    if dev_type == "cuda":
        # NVLink peers need no shared-memory transport, which would write
        # under /dev/shm
        os.environ["NCCL_SHM_DISABLE"] = "1"
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    trace = trace or Trace(trace_on, rank)
    cfg, tr = cell.config, cell.traffic
    frames, ef = tr["frames_per_step"], tr["eval_frames"]
    pd.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                            backend="nccl" if dev_type == "cuda" else "gloo",
                            device=device)
    with faults.planted(fault):
        mesh = make_mesh([device], dp=world)
        ofdm = OFDMConfig(**cfg["ofdm"])
        tc = TrainConfig(snr=tr["snr_db"], batch_size=frames * ofdm.nsymbol,
                         **cfg["train"])
        trainer = Trainer(ofdm, tc, channel=tr["channel"], mesh=mesh)
        if trainer.batch_frames != frames:
            raise ValueError(f"{trainer.batch_frames} frames a step")
        shapes = {k: tuple(v.shape)
                  for k, v in trainer.model.state_dict().items()}
        w0 = harness.draw_weights(shapes, harness.sub_seed(seed, "weights"),
                                  device)
        state = trainer._new_state(dict(w0), list(w0))
        gen = torch.Generator(device=device).manual_seed(
            harness.sub_seed(seed, "data"))
        spe = max(1, tc.frames_per_epoch(ofdm.nsymbol) // frames)
        snr = torch.full((frames,), float(tr["snr_db"]), device=device)
        eval_snr = torch.full((ef,), float(tr["snr_db"]), device=device)

        def sync():
            if dev_type == "cuda":
                torch.cuda.synchronize(device)

        bases, losses, mu1 = [], [], None
        for i in range(single.CHECK_STEPS):
            bases.append(_base_seed(torch, gen, device))
            state, aux = trainer.train_step(state, gen, snr)
            losses.append(aux["loss"])
            if i == 0:
                mu1 = state.opt_state["mu"]
        params3 = state.params
        limit = min(seconds, tr["trace_seconds"]) if trace_on else seconds

        def epoch_end(state, aux, ep, t0):
            with trace.span("eval_step"):
                val = trainer.eval_step(state.params, gen, ef, eval_snr)
            with trace.span("host_read"):
                stop = float(time.perf_counter() - t0 >= limit)
                return pd.agree([aux["ber"], torch.stack(ep).mean(),
                                 val["ber"], val["ce"], stop], device)

        epoch_end(state, aux, [aux["ce"]], time.perf_counter())
        sync()
        setup_s = time.perf_counter() - t_start
        steps = failed = 0
        with trace.window(sync):
            t0 = time.perf_counter()
            while True:
                ep = []
                for _ in range(spe):
                    with trace.span("train_step"):
                        state, aux = trainer.train_step(state, gen, snr)
                    ep.append(aux["ce"])
                vals = epoch_end(state, aux, ep, t0)
                steps += spe
                failed += spe * (not all(math.isfinite(v) for v in vals))
                if vals[-1]:
                    break
            t1 = time.perf_counter()
        sync()
        peak = torch.cuda.max_memory_allocated(device) \
            if dev_type == "cuda" else 0
        # the run's own process checks its modules in `run.py`; the
        # other ranks' are read here, once their window has closed
        info = pd.all_gather_object({
            "peak": peak, "busy_s": trace.busy_s() if trace_on else None,
            "forbidden": harness.forbidden_loaded()})
    prog = {"loss": [float(v) for v in losses],
            "grad1": {k: v / (1 - single.B1) for k, v in mu1.items()},
            "change": {k: params3[k] - w0[k] for k in w0}}
    plan = trainer.plan
    n_params = sum(math.prod(s) for s in shapes.values())
    del trainer, state, aux
    dist.destroy_process_group()
    if rank:
        return None
    bad = {r: i["forbidden"] for r, i in enumerate(info) if i["forbidden"]}
    if bad:
        raise SystemExit(f"ranks loaded {bad}: the benchmark measures the "
                         "port alone")
    if dev_type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference_run(cell, w0, bases, device, "float32")
    iq = steps * frames * ofdm.nsymbol * plan.samples_per_symbol
    busy = [i["busy_s"] for i in info]
    return {"steps": steps, "attempted": steps, "failed": failed,
            "peak_bytes": max(i["peak"] for i in info),
            "busy_s": sum(busy) / len(busy) if trace_on else None,
            "window_s": t1 - t0,
            "e2e": {"train_iq_per_s": iq / (t1 - t0), "setup_s": setup_s},
            "layer": {"steps": steps, "frames": steps * frames,
                      "frames_per_step": frames, "chips": world,
                      "n_params": n_params, "ofdm": cfg["ofdm"],
                      "synth": single.SynthShape(
                          plan.nsymbol, plan.samples_per_symbol, plan.nfft,
                          plan.frame_size, 0, 0)},
            "readings": single.readings(prog, ref),
            "reference_s": time.perf_counter() - t,
            "loss": {"program": prog["loss"], "reference": ref["loss"]}}
