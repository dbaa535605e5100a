"""Tensor parallelism: the forward pass of one dp row on its tp ranks.

The port of what GSPMD makes of JAX's tp shardings
(`dl_ofdm_tpu/parallel/mesh.py:51-57`, `train/loop.py:96-106`), written
out.  Each rank holds the blocks that `parallel.mesh.shard_params` gave it;
a model whose forward takes `tp=` routes its split layers through a
`TensorParallel` and runs every other layer on the row's tp rank 0 with
that rank's (replicated) copy:

  * column-parallel `ComplexDense` (the DCCN's `fft_like`, wr and wi split
    on the filter axis): each rank runs the layer on its F/tp filter
    columns (on a card, `complex_dense`'s hand-written kernel, float32 or
    bf16 mode) and the outputs are gathered along the filter axis;
  * row-parallel `Linear` (`Dense_extract`, split on its in axis): JAX
    splits the flax kernel's rows, contiguous blocks of the flattened
    (s, f, iq) axis, which do not line up with a rank's filter columns
    (S = 7); so the gathered input is cut into those blocks, each rank
    multiplies its block, and the partial products are summed in rank
    order, the (replicated) bias added last;
  * column-parallel `Linear` (the equalizer's `Dense_interp*` and
    `Dense_block*`, split on the out axis with their biases): each rank
    computes its output columns, gathered before what follows.

Gathers and sums run on the input's device (the row's tp rank 0); in one
process `.to()` and `cat` are differentiable, so autograd carries each
rank's gradient back to its own shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dl_ofdm_tpu_torch.models.dccn import dense_bf16


class TensorParallel:
    """One dp row's tp ranks: `shards[t]` is rank t's parameters (keyed as
    the model's `state_dict`), on `devices[t]`; `dims` is
    `parallel.mesh.shard_dims` (the split axis of each key, None where
    replicated).  `scope(name)` is the view of a submodule's keys."""

    def __init__(self, shards: list[dict], devices: list[torch.device],
                 dims: dict, prefix: str = ""):
        self.shards, self.devices, self.dims = shards, devices, dims
        self.prefix = prefix

    def scope(self, name: str) -> "TensorParallel":
        return TensorParallel(self.shards, self.devices, self.dims,
                              f"{self.prefix}{name}.")

    def _split(self, key: str) -> bool:
        return self.dims.get(self.prefix + key) is not None

    def _local(self, t: int, name: str, module: torch.nn.Module) -> dict:
        return {n: self.shards[t][f"{self.prefix}{name}.{n}"]
                for n, _ in module.named_parameters()}

    def complex_dense(self, layer: torch.nn.Module, name: str,
                      x: torch.Tensor) -> torch.Tensor:
        """`layer(x)` ([..., K, 2] -> [..., F, 2]) with its filter axis
        split over the ranks, the outputs gathered on x's device."""
        if not self._split(f"{name}.wr"):
            return layer(x)
        outs = [functional_call(layer, self._local(t, name, layer),
                                (x.to(d),))
                for t, d in enumerate(self.devices)]
        return torch.cat([o.to(x.device) for o in outs], dim=-2)

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
        blocks = torch.split(x, [w.shape[1] for w in ws], dim=-1)
        out = None
        for blk, w, d in zip(blocks, ws, self.devices):
            part = F.linear(cast(blk.to(d)), cast(w)).to(x.device)
            out = part if out is None else out + part
        if bf16:
            return out.to(torch.bfloat16) + layer.bias.to(torch.bfloat16)
        return out + layer.bias

    def column_linear(self, layer: torch.nn.Linear, name: str,
                      x: torch.Tensor) -> torch.Tensor:
        """`layer(x)` with the out axis (weight and bias) split over the
        ranks, the outputs gathered on x's device."""
        if not self._split(f"{name}.weight"):
            return layer(x)
        outs = [F.linear(x.to(d), p[f"{self.prefix}{name}.weight"],
                         p[f"{self.prefix}{name}.bias"])
                for p, d in zip(self.shards, self.devices)]
        return torch.cat([o.to(x.device) for o in outs], dim=-1)
