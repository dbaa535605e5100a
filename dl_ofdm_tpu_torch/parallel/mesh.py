"""The device mesh: data parallelism over 'dp' in one process.

Port of `dl_ofdm_tpu/parallel/mesh.py:27-85`.  JAX's mesh is
single-controller: one process holds a `jax.sharding.Mesh` over
`jax.devices()`, and the tests run it on 8 virtual CPU devices.  The port's
`Mesh` is the same idea without GSPMD: a [dp, tp] grid of `torch.device`s
that the trainer and the sweeps walk rank by rank from one process.

  * 'dp': each rank draws, normalizes and evaluates its own shard of the
    frames on its device with its own replica of the parameters; the
    gradients and the error counts are summed over the ranks in rank order
    (the trainer, `train/loop.py`, and the sweeps, `eval/sweep.py`);
  * 'tp' (tensor parallelism over the learned-DFT filter axis and the wide
    dense layers) is not ported: `shard_params` and every mesh entry point
    raise on tp > 1 (ROADMAP.md Queue A item 12).

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

TP_NOT_PORTED = ("tensor parallelism (a mesh with tp > 1) is not ported "
                 "yet: ROADMAP.md Queue A item 12")


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
    the grid (an object array); `dp_devices` the devices of the dp ranks
    (column 0, as tp is 1).  A device may repeat: a virtual rank."""

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


def check_dp_only(mesh: Mesh) -> None:
    """Raise `NotImplementedError` on a mesh with tp > 1."""
    if mesh.shape["tp"] != 1:
        raise NotImplementedError(TP_NOT_PORTED)


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


def shard_params(mesh: Mesh, params: dict) -> list[dict]:
    """One replica of `params` (a `state_dict`-keyed dict) per dp rank, on
    that rank's device, each with buffers of its own.  Raises
    `NotImplementedError` on tp > 1."""
    check_dp_only(mesh)
    return [{k: v.detach().to(d, copy=True) for k, v in params.items()}
            for d in mesh.dp_devices]


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
