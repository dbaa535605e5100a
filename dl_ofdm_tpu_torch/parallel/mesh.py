"""The device mesh: data and tensor parallelism in one process.

Port of `dl_ofdm_tpu/parallel/mesh.py:27-85`.  JAX's mesh is
single-controller: one process holds a `jax.sharding.Mesh` over
`jax.devices()`, and the tests run it on 8 virtual CPU devices.  The port's
`Mesh` is the same idea without GSPMD: a [dp, tp] grid of `torch.device`s
that the trainer and the sweeps walk rank by rank from one process.

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
    (the order of `shard_params`).  A device may repeat: a virtual rank."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a [dp, tp] grid, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def dp_devices(self) -> list[torch.device]:
        return list(self.devices[:, 0])

    def tp_devices(self, row: int = 0) -> list[torch.device]:
        return list(self.devices[row])

    @property
    def rank_devices(self) -> list[torch.device]:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(devices: Sequence | None = None, dp: int | None = None,
              tp: int = 1) -> Mesh:
    """A ('dp', 'tp') mesh over `devices` (every CUDA device when None;
    raises where there is none, as `resolve_device` does).  Entries are
    `torch.device`s, names or CUDA indices, and may repeat (virtual
    ranks).  Raises when dp * tp is not the number of devices."""
    if devices is None:
        resolve_device()
        devices = range(torch.cuda.device_count())
    devices = [_device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n or n == 0:
        raise ValueError(f"dp*tp={dp * tp} != device count {n}")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices):
        grid[i // tp, i % tp] = d
    return Mesh(grid)


def shard_batch(mesh: Mesh, batch):
    """Split the leading axis of every tensor of `batch` (a tensor, or a
    tuple, list or dict of them) into dp equal shards, shard r on rank r's
    device.  Each tensor becomes the list of its shards; the structure
    stays, so `bits_m, rx_m = shard_batch(mesh, (bits, rx))` unpacks as in
    JAX."""
    devs = mesh.dp_devices
    dp = len(devs)

    def split(x):
        if x.shape[0] % dp:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"into {dp} equal shards")
        return [s.to(d) for s, d in zip(torch.chunk(x, dp), devs)]

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
    """One dict per (dp, tp) rank, row-major, on that rank's device, each
    with buffers of its own: a leaf split by `shard_dims` holds its tp
    rank's contiguous block along that axis (the slice of JAX's
    `NamedSharding` on that device), any other leaf a copy.  With tp = 1
    that is one replica of `params` per dp rank."""
    dims = shard_dims(mesh, params)
    tp = mesh.shape["tp"]
    out = []
    for r, dev in enumerate(mesh.rank_devices):
        t = r % tp
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
    """The inverse of `shard_params`: full tensors on rank 0's device, a
    split leaf the concatenation of dp row 0's blocks in tp order, any
    other leaf rank 0's copy.  `dims` is `shard_dims` of the full
    parameters."""
    row = shards[:mesh.shape["tp"]]
    return {k: v if dims[k] is None
            else gather_leaf(k, [s[k] for s in row], mesh.devices[0, 0])
            for k, v in row[0].items()}


def rank_generators(generator: torch.Generator | None,
                    devices: Sequence[torch.device]) -> list[torch.Generator]:
    """One generator per rank, on its device: seeded from one draw of
    `generator` plus the rank index (the counterpart of JAX's
    `fold_in(key, axis_index)`), so the ranks draw different streams.  The
    draw reads one number back to the host."""
    dev = generator.device if generator is not None else devices[0]
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=dev))
    return [torch.Generator(device=d).manual_seed(seed + r)
            for r, d in enumerate(devices)]


def module_replicas(module: torch.nn.Module,
                    devices: Sequence[torch.device]) -> dict:
    """device -> `module` on it: the module itself on its own device, a
    deep copy on each other device of `devices`."""
    home = next(module.parameters()).device
    return {d: module if d == home else copy.deepcopy(module).to(d)
            for d in dict.fromkeys(devices)}
