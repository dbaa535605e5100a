"""Trained weights from the JAX package's npz archives.

`load_params_npz` reads the single-file float32 archives the JAX package
writes (`dl_ofdm_tpu/train/checkpoint.py:97`, e.g. the committed
`runs/arms/*.npz`) into a nested dict of numpy arrays, and
`params_from_flax` turns such a flax param tree into a torch `state_dict`.
"""
from __future__ import annotations

import numpy as np
import torch


def load_params_npz(path: str) -> dict:
    """npz with '/'-joined keys -> nested dict of float32 numpy arrays."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax param tree -> torch state_dict with the same scope names.

    A flax `Dense` stores `kernel` [in, out] and `bias`; a torch `Linear`
    stores `weight` [out, in] and `bias`, so kernels are transposed.  Every
    other leaf (ComplexDense's wr/wi [K, F], br/bi/b) keeps its name and
    layout."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node):
        for name, value in node.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(value, dict):
                walk(path, value)
            elif name == "kernel":
                out[f"{prefix}.weight"] = torch.tensor(np.asarray(value).T)
            else:
                out[path] = torch.tensor(np.asarray(value))

    walk("", tree)
    return out
