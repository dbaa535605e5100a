"""Tensor parallelism: the forward pass of one dp row on its tp ranks.

The port of what GSPMD makes of JAX's tp shardings
(`dl_ofdm_tpu/parallel/mesh.py:51-57`, `train/loop.py:96-106`), written
out.  Each rank holds the blocks that `parallel.mesh.shard_params` gave it;
a model whose forward takes `tp=` routes its split layers through a
`TensorParallel` and runs every other layer with its first rank's
(replicated) copy:

  * column-parallel `ComplexDense` (the DCCN's `fft_like`, wr and wi split
    on the filter axis): each rank runs the layer on its F/tp filter
    columns (on a card, `complex_dense`'s hand-written kernel, float32 or
    bf16 mode) and the outputs are gathered along the filter axis;
  * row-parallel `Linear` (`Dense_extract`, split on its in axis): JAX
    splits the flax kernel's rows, contiguous blocks of the flattened
    (s, f, iq) axis, which do not line up with a rank's filter columns
    (S = 7); so the gathered input is cut into those blocks, each rank
    multiplies its block, and the partial products are summed in rank
    order in float32, the (replicated) bias added last;
  * column-parallel `Linear` (the equalizer's `Dense_interp*` and
    `Dense_block*`, split on the out axis with their biases): each rank
    computes its output columns, gathered before what follows.

Where the row lies in one process, gathers and sums run on the input's
device; `.to()` and `cat` are differentiable, so autograd carries each
rank's gradient back to its own shards.  Where the row spans processes
(`TensorParallel.group`, the row's process group), each process runs its
own ranks of the row and every other layer itself, on identical inputs,
and three `torch.autograd.Function`s meet over the group (Megatron's f/g
pair and its block cut), each through one slot-buffer `all_reduce`
(`parallel.mesh.exchange`), never a reducing one, so every sum keeps the
one-process order:

  * `_Copies` (f): the input of a column-parallel layer on each local
    rank's device; its backward gathers every rank's input gradient and
    adds them from the last rank to the first, the order in which
    autograd adds them in one process;
  * `_Gather` (g of a column-parallel layer): the ranks' output columns in
    rank order; its backward hands each local rank its slice of the
    incoming gradient.  That is right only because every process of the
    row runs what follows on identical inputs and so holds the whole
    gradient;
  * `_BlockCut` and `_RowSum` (the row-parallel layer): the local ranks'
    blocks of the input, whose backward gathers every rank's block
    gradient into the whole input gradient; and the partial products
    gathered and added in rank order in float32, whose backward is the
    identity.

The backward's gathers come in the same order in every process of the
row: each process builds the same graph of the row's layers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dl_ofdm_tpu_torch.models.dccn import dense_bf16
from dl_ofdm_tpu_torch.parallel.mesh import exchange


class TensorParallel:
    """One dp row's tp ranks held by this process: `shards[i]` is rank
    `ranks[i]`'s parameters (keyed as the model's `state_dict`), on
    `devices[i]`; `dims` is `parallel.mesh.shard_dims` (the split axis of
    each key, None where replicated).  `ranks` defaults to every rank of
    the row (0 .. len(shards) - 1); where the row spans processes, `tp` is
    its rank count, `group` its process group and `comm` the device the
    collectives run on (the process's `Mesh.home`).  `scope(name)` is the
    view of a submodule's keys."""

    def __init__(self, shards: list[dict], devices: list[torch.device],
                 dims: dict, prefix: str = "", ranks: list[int] | None = None,
                 tp: int | None = None, group=None, comm=None):
        self.shards, self.devices, self.dims = shards, devices, dims
        self.prefix = prefix
        self.ranks = list(range(len(shards))) if ranks is None else ranks
        self.tp = len(shards) if tp is None else tp
        self.group, self.comm = group, comm

    @classmethod
    def for_row(cls, mesh, row: int, shards: list[dict],
                dims: dict) -> "TensorParallel":
        """This process's ranks of `row` of `mesh`; `shards` are their
        parameters, in tp order (`mesh.row_slots(row)` of the local
        ranks')."""
        tp = mesh.shape["tp"]
        ranks = [mesh.local_ranks[i] for i in mesh.row_slots(row)]
        return cls(shards, [mesh.rank_devices[r] for r in ranks], dims,
                   ranks=[r % tp for r in ranks], tp=tp,
                   group=mesh.row_groups[row], comm=mesh.home)

    def scope(self, name: str) -> "TensorParallel":
        return TensorParallel(self.shards, self.devices, self.dims,
                              f"{self.prefix}{name}.", self.ranks, self.tp,
                              self.group, self.comm)

    def _split(self, key: str) -> bool:
        return self.dims.get(self.prefix + key) is not None

    def _local(self, t: int, name: str, module: torch.nn.Module) -> dict:
        return {n: self.shards[t][f"{self.prefix}{name}.{n}"]
                for n, _ in module.named_parameters()}

    def gather(self, tensors) -> list[torch.Tensor]:
        """Every rank's tensor of the row, in rank order, from the local
        ranks' `tensors` (alike in shape and dtype): the local ones as
        they are, the others on `comm`."""
        stacks = exchange(dict(zip(self.ranks, [[t] for t in tensors])),
                          self.tp, [tensors[0]], self.group, self.comm)[0]
        local = dict(zip(self.ranks, tensors))
        return [local[t] if t in local else stacks[t]
                for t in range(self.tp)]

    def complex_dense(self, layer: torch.nn.Module, name: str,
                      x: torch.Tensor) -> torch.Tensor:
        """`layer(x)` ([..., K, 2] -> [..., F, 2]) with its filter axis
        split over the ranks, the outputs gathered on x's device."""
        if not self._split(f"{name}.wr"):
            return layer(x)
        if self.group is None:
            outs = [functional_call(layer, self._local(t, name, layer),
                                    (x.to(d),))
                    for t, d in enumerate(self.devices)]
            return torch.cat([o.to(x.device) for o in outs], dim=-2)
        outs = [functional_call(layer, self._local(i, name, layer), (xi,))
                for i, xi in enumerate(_Copies.apply(x, self))]
        return _Gather.apply(self, -2, x.device, *outs)

    def row_linear(self, layer: torch.nn.Linear, name: str, x: torch.Tensor,
                   bf16: bool = False) -> torch.Tensor:
        """`layer(x)` with the in axis split over the ranks: rank t takes
        x's t-th column block; the partial products are summed in rank
        order on x's device, then the bias is added.  `bf16`: flax's
        `Dense(dtype=bfloat16)` as `models.dccn.dense_bf16` computes it,
        the product rounded once to bf16: the partial products of bf16
        operands are taken and summed in float32 and rounded once, then
        the bf16 bias is added."""
        if not self._split(f"{name}.weight"):
            return dense_bf16(layer, x) if bf16 else layer(x)
        cast = ((lambda v: v.to(torch.bfloat16).float()) if bf16
                else (lambda v: v))
        ws = [s[f"{self.prefix}{name}.weight"] for s in self.shards]
        if self.group is None:
            blocks = torch.split(x, [w.shape[1] for w in ws], dim=-1)
            out = None
            for blk, w, d in zip(blocks, ws, self.devices):
                part = F.linear(cast(blk.to(d)), cast(w)).to(x.device)
                out = part if out is None else out + part
        else:
            blocks = _BlockCut.apply(x, self, ws[0].shape[1])
            out = _RowSum.apply(self, x.device, *[
                F.linear(cast(blk), cast(w)) for blk, w in zip(blocks, ws)])
        if bf16:
            return out.to(torch.bfloat16) + layer.bias.to(torch.bfloat16)
        return out + layer.bias

    def column_linear(self, layer: torch.nn.Linear, name: str,
                      x: torch.Tensor) -> torch.Tensor:
        """`layer(x)` with the out axis (weight and bias) split over the
        ranks, the outputs gathered on x's device."""
        if not self._split(f"{name}.weight"):
            return layer(x)
        w, b = f"{self.prefix}{name}.weight", f"{self.prefix}{name}.bias"
        if self.group is None:
            outs = [F.linear(x.to(d), p[w], p[b])
                    for p, d in zip(self.shards, self.devices)]
            return torch.cat([o.to(x.device) for o in outs], dim=-1)
        outs = [F.linear(xi, p[w], p[b])
                for xi, p in zip(_Copies.apply(x, self), self.shards)]
        return _Gather.apply(self, -1, x.device, *outs)


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`: a view of it where it is there already (a custom
    Function's outputs must not be its inputs themselves)."""
    return t.view_as(t) if t.device == torch.device(device) else t.to(device)


class _Copies(torch.autograd.Function):
    """Megatron's f: x on each local rank's device; backward: every
    rank's input gradient gathered over the row and added from the last
    rank to the first."""

    @staticmethod
    def forward(ctx, x, tpc):
        ctx.tpc, ctx.device = tpc, x.device
        return tuple(_to(x, d) for d in tpc.devices)

    @staticmethod
    def backward(ctx, *grads):
        full = ctx.tpc.gather(grads)
        acc = full[-1].to(ctx.device)
        for g in reversed(full[:-1]):
            acc = acc + g.to(ctx.device)
        return acc, None


class _Gather(torch.autograd.Function):
    """The local ranks' outputs gathered over the row along `dim` in rank
    order on `dest`; backward: each local rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, tpc, dim, dest, *outs):
        full = tpc.gather(outs)
        ctx.tpc, ctx.dim = tpc, dim
        ctx.sizes = [o.shape[dim] for o in full]
        ctx.devices = [o.device for o in outs]
        return torch.cat([o.to(dest) for o in full], dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.split(g, ctx.sizes, ctx.dim)
        return (None, None, None, *[parts[t].to(d) for t, d in zip(
            ctx.tpc.ranks, ctx.devices)])


class _BlockCut(torch.autograd.Function):
    """The local ranks' blocks of `size` columns of x's last axis, on
    their devices; backward: every rank's block gradient gathered over
    the row into the whole gradient."""

    @staticmethod
    def forward(ctx, x, tpc, size):
        ctx.tpc, ctx.device = tpc, x.device
        blocks = torch.split(x, size, dim=-1)
        return tuple(_to(blocks[t], d) for t, d in zip(tpc.ranks,
                                                       tpc.devices))

    @staticmethod
    def backward(ctx, *grads):
        full = ctx.tpc.gather(grads)
        return torch.cat([g.to(ctx.device) for g in full], dim=-1), None, None


class _RowSum(torch.autograd.Function):
    """Every rank's partial product gathered over the row and added in
    rank order on `dest`; backward: the gradient to each local part."""

    @staticmethod
    def forward(ctx, tpc, dest, *parts):
        ctx.devices = [p.device for p in parts]
        out = None
        for p in tpc.gather(parts):
            p = p.to(dest)
            out = p if out is None else out + p
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, None, *[g.to(d) for d in ctx.devices])
