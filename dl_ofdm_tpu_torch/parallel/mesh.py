"""The device mesh: data and tensor parallelism, in one process or many.

Port of `dl_ofdm_tpu/parallel/mesh.py:27-85`.  JAX's mesh is one
`jax.sharding.Mesh` over `jax.devices()`, every device of every process,
and the tests run it on 8 virtual CPU devices.  The port's `Mesh` is the
same idea without GSPMD: a [dp, tp] grid of `torch.device`s that the
trainer and the sweeps walk rank by rank.  In a `torch.distributed` group
of W > 1 processes (`parallel/distributed.py::initialize_multihost`)
`make_mesh` builds the global grid, the ranks ordered by process as
`jax.devices()` orders them: each process owns whole dp rows (its
`local_rows`) and walks only those, and a tp row lies within one process
(a layout that would split one raises, ROADMAP.md Queue A item 17).
`gather_rows` combines what the rows computed, over the processes, in row
order, so a step or a sweep gives the numbers the one-process mesh gives.

  * 'dp': each dp row draws, normalizes and evaluates its own shard of the
    frames with its own copy of the parameters; the gradients and the
    error counts are summed over the rows in row order (the trainer,
    `train/loop.py`, and the sweeps, `eval/sweep.py`);
  * 'tp': the learned-DFT filter axis and the wide dense layers are split
    over the tp ranks of each row by JAX's partition rules (`_RULES`):
    `shard_params` gives every (dp, tp) rank the block of each leaf that
    JAX's `NamedSharding` puts on that device, `gather_params` is its
    inverse, and `parallel/tp.py` runs the forward pass on the shards.

A device may appear more than once: each appearance is a virtual rank with
buffers of its own, as JAX's virtual CPU devices are.  So one card, listed
four times, runs a 4-rank mesh, and the ring exchange of
`parallel/halo.py` pushes between the ranks' buffers exactly as it does
between cards.
"""
from __future__ import annotations

import copy
import re
from typing import Sequence

import numpy as np
import torch

from dl_ofdm_tpu_torch import resolve_device
from dl_ofdm_tpu_torch.parallel import distributed as pd

def _device(d) -> torch.device:
    """A mesh entry as a `torch.device` with its index: 'cuda' is the
    current card; raises where CUDA is named and there is none."""
    dev = resolve_device(torch.device("cuda", d) if isinstance(d, int)
                         else d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A [dp, tp] grid of `torch.device`s with the axis names ("dp", "tp").

    `shape["dp"]`, `shape["tp"]` as on a `jax.sharding.Mesh`; `devices` is
    the grid (an object array); `dp_devices` the devices of the dp rows
    (their tp rank 0, which holds a row's frames); `tp_devices(row)` the
    devices of one row's tp ranks; `rank_devices` every rank's, row-major
    (the order of `shard_params`).  A device may repeat: a virtual rank.

    `process` holds the process of each rank (all 0 in one process);
    `process_index` is this process.  A device of another process is
    that process's name for it.  `local_rows` are the dp rows this
    process owns, `local_ranks` their ranks (row-major indices),
    `local_dp_devices` their devices and `home` the first one's: where
    this process keeps the parameters and its generator."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray, process: np.ndarray | None = None,
                 process_index: int = 0):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a [dp, tp] grid, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.process = (np.zeros(devices.shape, dtype=int) if process is None
                        else process)
        self.process_index = process_index
        if (self.process != self.process[:, :1]).any():
            raise NotImplementedError(pd.TP_ACROSS_PROCESSES)
        self.local_rows = [r for r in range(devices.shape[0])
                           if self.process[r, 0] == process_index]
        if not self.local_rows:
            raise ValueError(f"process {process_index} owns no dp row")
        tp = devices.shape[1]
        self.local_ranks = [r * tp + t for r in self.local_rows
                            for t in range(tp)]

    @property
    def multiprocess(self) -> bool:
        return bool(self.process.any())

    @property
    def dp_devices(self) -> list[torch.device]:
        return list(self.devices[:, 0])

    @property
    def local_dp_devices(self) -> list[torch.device]:
        return [self.devices[r, 0] for r in self.local_rows]

    @property
    def home(self) -> torch.device:
        return self.devices[self.local_rows[0], 0]

    def tp_devices(self, row: int = 0) -> list[torch.device]:
        return list(self.devices[row])

    @property
    def rank_devices(self) -> list[torch.device]:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        procs = (f", processes {self.process[:, 0].tolist()}"
                 if self.multiprocess else "")
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]}{procs})")


def make_mesh(devices: Sequence | None = None, dp: int | None = None,
              tp: int = 1) -> Mesh:
    """A ('dp', 'tp') mesh over `devices` (every CUDA device when None;
    raises where there is none, as `resolve_device` does).  Entries are
    `torch.device`s, names or CUDA indices, and may repeat (virtual
    ranks).  Raises when dp * tp is not the number of devices.

    In a group of W > 1 processes, `devices` are this process's own (its
    current card when None), every process names as many, and the mesh
    is the global grid over all of them in process order: dp * tp must be
    W times that count.  A tp that does not divide a process's count
    would split a tp row over processes and raises
    `NotImplementedError`."""
    world = pd.process_count()
    if devices is None:
        resolve_device()
        devices = (range(torch.cuda.device_count()) if world == 1
                   else [torch.cuda.current_device()])
    devices = [_device(d) for d in devices]
    process = np.zeros(len(devices), dtype=int)
    if world > 1:
        names = pd.all_gather_object([str(d) for d in devices])
        if len({len(n) for n in names}) != 1:
            raise ValueError(f"the processes name different device counts: "
                             f"{[len(n) for n in names]}")
        if len(devices) % tp:
            raise NotImplementedError(
                f"tp={tp} over {len(devices)} device(s) a process: "
                + pd.TP_ACROSS_PROCESSES)
        me = pd.process_index()
        devices = [d if p == me else torch.device(name)
                   for p, ns in enumerate(names)
                   for d, name in zip(devices, ns)]
        process = np.repeat(np.arange(world), len(names[0]))
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n or n == 0:
        raise ValueError(f"dp*tp={dp * tp} != device count {n}")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices):
        grid[i // tp, i % tp] = d
    return Mesh(grid, process.reshape(dp, tp), pd.process_index())


def gather_rows(mesh: Mesh, rows: list[list], device=None) -> list:
    """What the local dp rows computed, over every row of the mesh: `rows`
    holds, for each local row in order, a list of tensors (alike from row
    to row); returns, for each position, a tensor [dp, ...] of every
    row's tensor in global row order, on `device` (each tensor's own
    device where None).  Across processes one `all_reduce` a (device,
    dtype) of a buffer that holds each row's values in its slot and zeros
    elsewhere, so the rows arrive exact and a caller that sums them in
    row order repeats the one-process mesh's sums bit for bit."""
    dest = [t.device if device is None else torch.device(device)
            for t in rows[0]]
    if not mesh.multiprocess:
        return [torch.stack([r[i].to(dest[i]) for r in rows])
                for i in range(len(dest))]
    dp = mesh.shape["dp"]
    groups: dict[tuple, list[int]] = {}
    for i, t in enumerate(rows[0]):
        groups.setdefault((dest[i], t.dtype), []).append(i)
    out = [None] * len(dest)
    for (dev, dtype), idx in groups.items():
        sizes = [rows[0][i].numel() for i in idx]
        buf = torch.zeros(dp, sum(sizes), dtype=dtype, device=dev)
        for row, r in zip(mesh.local_rows, rows):
            buf[row] = torch.cat([r[i].reshape(-1).to(dev) for i in idx])
        pd.all_sum_(buf)
        for i, part in zip(idx, buf.split(sizes, dim=1)):
            out[i] = part.reshape(dp, *rows[0][i].shape)
    return out


def shard_batch(mesh: Mesh, batch):
    """Split the leading axis of every tensor of `batch` (a tensor, or a
    tuple, list or dict of them) into dp equal shards, shard r on rank r's
    device; this process keeps its local rows' shards.  Each tensor
    becomes the list of its shards; the structure stays, so
    `bits_m, rx_m = shard_batch(mesh, (bits, rx))` unpacks as in JAX."""
    devs = mesh.local_dp_devices
    dp = mesh.shape["dp"]

    def split(x):
        if x.shape[0] % dp:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"into {dp} equal shards")
        shards = torch.chunk(x, dp)
        return [shards[r].to(d) for r, d in zip(mesh.local_rows, devs)]

    if isinstance(batch, torch.Tensor):
        return split(batch)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    return type(batch)(shard_batch(mesh, v) for v in batch)


# Partitioning rules: regex on a flax parameter path -> the spec of its
# axes (the flax layout: a Dense kernel is [in, out], the transpose of a
# torch Linear's weight).  The learned-DFT weight [K, F] shards its filter
# axis over 'tp'; the wide demodulation/equalizer dense kernels shard their
# output (or input) axis.  A copy of `dl_ofdm_tpu/parallel/mesh.py:51-57`.
_RULES = (
    (r"fft_like/(wr|wi)$", (None, "tp")),
    (r"fft_like/(br|bi|b)$", ("tp",)),
    (r"Dense_extract/kernel$", ("tp", None)),
    (r"Dense_(interp|block)\d*/kernel$", (None, "tp")),
    (r"Dense_(interp|block)\d*/bias$", ("tp",)),
)


def param_sharding_rules(path: str) -> tuple:
    """The partition spec of a parameter as a tuple of axis names (None:
    not sharded; () replicated), as JAX's `param_sharding_rules` gives it.
    `path` is a flax path ('Dense_extract/kernel') or a `state_dict` key
    ('Dense_extract.weight')."""
    path = path.replace(".", "/")
    if path.endswith("/weight"):
        path = path[:-len("weight")] + "kernel"
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            return spec
    return ()


def tp_axis(key: str, ndim: int) -> int | None:
    """The torch axis of a `state_dict` leaf that the rules split over
    'tp' (None where no rule does), in the torch layout: a `Linear`
    weight's rule, written for the flax kernel, names the other axis."""
    spec = param_sharding_rules(key)
    axis = spec.index("tp") if "tp" in spec else ndim
    if axis >= ndim:
        return None
    return ndim - 1 - axis if key.endswith(".weight") and ndim == 2 else axis


def shard_dims(mesh: Mesh, params: dict) -> dict[str, int | None]:
    """The axis each leaf of `params` (full tensors, keyed as a
    `state_dict`) is split along on `mesh`, None where it is replicated:
    tp = 1, no rule, or an axis that tp does not divide (tiny layers stay
    replicated, `dl_ofdm_tpu/parallel/mesh.py:75-83`)."""
    tp = mesh.shape["tp"]
    dims = {}
    for k, v in params.items():
        axis = None if tp == 1 else tp_axis(k, v.dim())
        dims[k] = axis if axis is not None and v.shape[axis] % tp == 0 \
            else None
    return dims


def shard_params(mesh: Mesh, params: dict) -> list[dict]:
    """One dict per (dp, tp) rank of this process, row-major, on that
    rank's device, each with buffers of its own: a leaf split by
    `shard_dims` holds its tp rank's contiguous block along that axis
    (the slice of JAX's `NamedSharding` on that device), any other leaf a
    copy.  With tp = 1 that is one replica of `params` per local dp
    rank."""
    dims = shard_dims(mesh, params)
    tp = mesh.shape["tp"]
    ranks = mesh.rank_devices
    out = []
    for r in mesh.local_ranks:
        t, dev = r % tp, ranks[r]
        out.append({k: (v if dims[k] is None
                        else torch.chunk(v, tp, dims[k])[t]).detach().to(
            dev, copy=True, memory_format=torch.contiguous_format)
            for k, v in params.items()})
    return out


def gather_leaf(key: str, shards: list, device) -> torch.Tensor:
    """A split leaf's shards (in tp order) concatenated on `device` along
    its tp axis."""
    return torch.cat([s.to(device) for s in shards],
                     tp_axis(key, shards[0].dim()))


def gather_params(mesh: Mesh, shards: list[dict],
                  dims: dict[str, int | None]) -> dict:
    """The inverse of `shard_params`: full tensors on `mesh.home`, a split
    leaf the concatenation of the first local row's blocks in tp order,
    any other leaf that row's copy.  `dims` is `shard_dims` of the full
    parameters."""
    row = shards[:mesh.shape["tp"]]
    return {k: v if dims[k] is None
            else gather_leaf(k, [s[k] for s in row], mesh.home)
            for k, v in row[0].items()}


def rank_generators(generator: torch.Generator | None,
                    devices: Sequence[torch.device],
                    ranks: Sequence[int] | None = None
                    ) -> list[torch.Generator]:
    """One generator per rank, on its device: seeded from one draw of
    `generator` plus the rank's global index (`ranks`, 0, 1, ... by
    default; the counterpart of JAX's `fold_in(key, axis_index)`), so the
    ranks draw different streams.  Every process draws the base from an
    identically seeded `generator`, so its ranks' streams are the ones
    the one-process mesh gives them.  The draw reads one number back to
    the host."""
    dev = generator.device if generator is not None else devices[0]
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=dev))
    ranks = range(len(devices)) if ranks is None else ranks
    return [torch.Generator(device=d).manual_seed(seed + r)
            for r, d in zip(ranks, devices)]


def module_replicas(module: torch.nn.Module,
                    devices: Sequence[torch.device]) -> dict:
    """device -> `module` on it: the module itself on its own device, a
    deep copy on each other device of `devices`."""
    home = next(module.parameters()).device
    return {d: module if d == home else copy.deepcopy(module).to(d)
            for d in dict.fromkeys(devices)}
