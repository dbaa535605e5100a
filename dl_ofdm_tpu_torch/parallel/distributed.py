"""Multi-process initialization, the collectives the mesh uses, and the
scaling-efficiency harness.

Port of `dl_ofdm_tpu/parallel/distributed.py`.  JAX's multi-host path is
`jax.distributed.initialize` plus one global mesh over `jax.devices()`,
GSPMD turning the jitted step into one program a process.  The port's is
`initialize_multihost` (a `torch.distributed` process group: NCCL where
the process's device is a card, gloo on the CPU) plus `make_mesh`, which
over a group of W > 1 processes builds the global [dp, tp] grid with the
ranks ordered by process (`parallel/mesh.py`).  Each process then walks
only its own dp rows, and the trainer and the sweeps combine the rows
with the collectives below.  As JAX lays out a pod (dp over DCN+ICI, tp
within a slice), a tp row lies within one process.

The collectives use only `all_reduce` and `broadcast` on tensors (the two
that gloo also takes on card tensors, so one code path runs on NCCL and
on gloo) and `*_object` calls for host metadata.  `scaling_efficiency`
times a step at several mesh widths, with CUDA events on a card and
`time.perf_counter` on the CPU, on every process, and reports on process
0 the slowest process's time.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

from dl_ofdm_tpu_torch import resolve_device

# a process that dies turns its partners' next collective into an error
# after this long, not a hang
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)
TP_ACROSS_PROCESSES = ("a tp row across processes is not ported yet: "
                       "ROADMAP.md Queue A item 17 (tp within a process, "
                       "dp across processes)")


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """This process in its group: its rank, the group's size, its device
    and the group's backend (None for one process, where no group is
    made)."""
    rank: int
    world: int
    device: torch.device | None
    backend: str | None


def process_count() -> int:
    """The processes of the default group (1 where there is none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 where there is none)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Process 0: the one that writes checkpoints, CSVs and logs."""
    return process_index() == 0


def _store(coordinator: str, world: int, rank: int,
           timeout: datetime.timedelta):
    """The rendezvous store: `file:///path` (a file every process sees) or
    `[tcp://]host:port` (process 0 listens there, unless torchrun's agent
    already does)."""
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], world)
    host, _, port = coordinator.removeprefix("tcp://").rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r}: host:port, "
                         "tcp://host:port or file:///path")
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    return dist.TCPStore(host, int(port), world,
                         is_master=rank == 0 and not agent, timeout=timeout)


def store_gather(store, rank: int, world: int, name: str,
                 value: str) -> list[str]:
    """Every process's `value` under `name`, in rank order, through the
    rendezvous store (no collective backend needed).  Process 0, which may
    host the store, returns only once every process has read."""
    key = f"dl_ofdm_tpu_torch/{name}"
    store.set(f"{key}/{rank}", value)
    out = [store.get(f"{key}/{r}").decode() for r in range(world)]
    store.add(f"{key}/read", 1)
    while rank == 0 and store.add(f"{key}/read", 0) < world:
        time.sleep(0.01)
    return out


def card_key(device: torch.device) -> str:
    """The host and the card a process runs on, as NCCL tells cards apart:
    by UUID where torch gives it, else by index."""
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else device}"


def check_one_rank_a_card(keys: list[str]) -> None:
    """Raise where two ranks share a card (`keys`: `card_key` of every
    rank): NCCL refuses them."""
    seen: dict[str, int] = {}
    for r, k in enumerate(keys):
        if k in seen:
            raise RuntimeError(
                f"ranks {seen[k]} and {r} are on the same card ({k}): NCCL "
                "takes one rank a card; give each process its own card, or "
                "name backend='gloo' to share one")
        seen[k] = r


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                         device: str | torch.device | None = None
                         ) -> ProcessInfo:
    """Join this process to a `torch.distributed` group of `num_processes`.

    With no arguments it reads torchrun's `WORLD_SIZE`, `RANK`,
    `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT` (the counterpart of
    JAX's auto-detection on pods); for one process it does nothing.
    `coordinator` is `host:port` (process 0 listens there) or
    `file:///path`.  `device` is the process's device: by default the
    card `LOCAL_RANK` (or `process_id`), made current with
    `torch.cuda.set_device`; raises where there is no card, unless `cpu`
    is named.  `backend` defaults to `nccl` on a card and `gloo` on the
    CPU; `gloo` may be named for card tensors (two processes sharing one
    card, which NCCL refuses: two NCCL ranks on one card raise here).
    `timeout` bounds every collective, so a process that dies turns into
    an error in the others.  Raises where the arguments disagree with
    torchrun's variables or with a group already made."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    elif "WORLD_SIZE" in env and int(env["WORLD_SIZE"]) != num_processes:
        raise ValueError(f"num_processes {num_processes} does not match "
                         f"WORLD_SIZE {env['WORLD_SIZE']}")
    if num_processes <= 1:
        return ProcessInfo(0, 1, None, None)
    if process_id is None:
        if "RANK" not in env:
            raise ValueError(f"{num_processes} processes: pass process_id "
                             "or set RANK")
        process_id = int(env["RANK"])
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside 0..."
                         f"{num_processes - 1}")
    if coordinator is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(f"{num_processes} processes: pass coordinator "
                             "or set MASTER_ADDR and MASTER_PORT")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_rank = int(env.get("LOCAL_RANK", process_id))
    dev = resolve_device(torch.device("cuda", local_rank) if device is None
                         and torch.cuda.is_available() else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= torch.cuda.device_count():
            raise ValueError(
                f"process {process_id} would take card {dev.index} of "
                f"{torch.cuda.device_count()}: pass device= (and "
                "backend='gloo' to share a card)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a card, got {dev}; the CPU "
                         "takes 'gloo'")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise ValueError(
                f"a group of {dist.get_world_size()} processes (this one "
                f"rank {dist.get_rank()}) exists already; asked for "
                f"{num_processes} (rank {process_id})")
        return ProcessInfo(process_id, num_processes, dev,
                           dist.get_backend())
    store = _store(coordinator, num_processes, process_id, timeout)
    if backend == "nccl":
        check_one_rank_a_card(store_gather(store, process_id, num_processes,
                                           "card", card_key(dev)))
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return ProcessInfo(process_id, num_processes, dev, backend)


def shutdown() -> None:
    """Leave the group (nothing where there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# -- collectives (no-ops for one process) ---------------------------------------

def all_sum_(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the processes, in place."""
    if process_count() > 1:
        dist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """`t` of process `src` in every process, in place."""
    if process_count() > 1:
        dist.broadcast(t, src)
    return t


def agree(values, device) -> list[float]:
    """Process 0's float64 `values` in every process: the numbers a
    decision is taken on, so that no process branches alone."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    return broadcast_(t).tolist()


def all_true(flag: bool, device) -> bool:
    """Whether `flag` holds in every process."""
    t = torch.tensor([0 if flag else 1], dtype=torch.int64, device=device)
    return int(all_sum_(t)) == 0


def barrier(device) -> None:
    """Wait for every process (an `all_reduce` of one number on `device`,
    so it runs on NCCL and on gloo alike)."""
    all_sum_(torch.zeros(1, device=device))


def all_gather_object(obj) -> list:
    """Every process's `obj`, in rank order."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


# -- scaling ---------------------------------------------------------------------

def weak_scaling_efficiency(steps_per_sec: dict[int, float]
                            ) -> dict[int, float]:
    """Weak-scaling efficiency from a {n_devices: steps/s} rate profile.

    Under weak scaling the global batch grows with n (per-device work is
    constant), so the ideal step rate is flat across widths: efficiency at
    width n is rate(n) / rate(smallest measured width)."""
    if not steps_per_sec:
        return {}
    base = steps_per_sec[min(steps_per_sec)]
    return {n: r / base for n, r in steps_per_sec.items()}


def _seconds_per_call(fn, iters: int, device: torch.device) -> float:
    """Mean seconds of one call of `fn` over `iters` calls after one
    warm-up call: CUDA events on a card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) / iters


def scaling_efficiency(make_step, make_args, device_counts=(1, 2, 4, 8),
                       iters: int = 10, log_fn=print,
                       device: str | torch.device | None = None
                       ) -> tuple[dict[int, float], dict[int, float]]:
    """Measure the step rate at several mesh widths.

    `make_step(n)` returns a step callable for an n-rank mesh and
    `make_args(n)` its inputs, with the global batch scaled by n (weak
    scaling).  `device` is where the steps run (`cuda` by default), which
    picks the clock.  In a group every process times its own calls and
    the slowest process's time counts; process 0 logs.  Returns
    ({n: steps_per_sec}, {n: weak_scaling_efficiency})."""
    device = resolve_device(device)
    results = {}
    for n in device_counts:
        step, args = make_step(n), make_args(n)
        dt = _seconds_per_call(lambda: step(*args), iters, device)
        if process_count() > 1:
            t = torch.tensor([dt], dtype=torch.float64, device=device)
            dist.all_reduce(t, dist.ReduceOp.MAX)
            dt = float(t)
        dt = max(dt, 1e-9)
        results[n] = 1.0 / dt
        eff = weak_scaling_efficiency(results)[n]
        if is_main_process():
            log_fn(f"{n} devices: {dt * 1e3:.2f} ms/step, "
                   f"scaling efficiency {eff * 100:.1f}%")
    return results, weak_scaling_efficiency(results)
