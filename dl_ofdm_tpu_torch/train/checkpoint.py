"""Checkpoints, resume payloads and the JAX package's npz archives.

Port of `dl_ofdm_tpu/train/checkpoint.py`.

Trained weights cross between the packages through the single-file
float32 archives the JAX package writes (`checkpoint.py:97`, e.g. the
committed `runs/arms/*.npz`): `load_params_npz` reads one into a nested
dict of numpy arrays and `params_from_flax` turns such a flax param tree
into a torch `state_dict`; `params_to_flax` and `export_params_npz` go
the other way, so parameters trained here load in the JAX package.

`save` / `restore` (a `TrainState`: params, Adam's count and moments,
step) and `save_resume` / `restore_resume` (the same, plus the epoch
loop's `torch.Generator` state, the epoch and best-loss cursors, the best
params, the batch size and the configuration's signature) write one
directory holding one named-key `.npz`, `state.npz`: params and moments
under their flax paths (`params/...`, `opt/mu/...`, `opt/nu/...`,
`best/...`), scalars under `step`, `opt/count`, `cursor/...`.  The file
is written to a temporary name and moved into place, so a kill mid-write
leaves the previous payload.  These are not Orbax directories: the JAX
package writes its checkpoints with Orbax (`checkpoint.py:43-50`), which
the port does not use and does not read; neither package reads the
other's checkpoints.  A state of a tp mesh holds a split leaf's Adam
moments as the list of its shards: `save` writes them gathered, in the
same flax layout, and `restore` splits them again like the target's.  On
a mesh over processes (`mesh=`) every process calls `save` and
`save_resume`, the shards of every process are gathered
(`parallel.mesh.gather_shards`) and process 0 alone writes the one file;
`restore` and `restore_resume` give each process its own shards
(`mesh.local_tps`).
`token_name` is the reference's naming schema
(`<token>_<n>mod_snr<s>_cp<b>[_Equalizer<opt>_<chan>]`,
`dev/py/run_local_ofdm.py:77,104`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dl_ofdm_tpu_torch.parallel import distributed as pd
from dl_ofdm_tpu_torch.parallel.mesh import (gather_leaf, gather_shards,
                                             shard_of, tp_axis)

STATE_FILE = "state.npz"


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
                # contiguous, as a module's weight is (`torch.tensor` keeps
                # the transpose's strides, and a strided weight changes the
                # order of a GEMM's sums)
                out[f"{prefix}.weight"] = torch.tensor(
                    np.ascontiguousarray(np.asarray(value).T))
            else:
                out[path] = torch.tensor(np.asarray(value))

    walk("", tree)
    return out


def params_to_flax(params: dict[str, torch.Tensor]) -> dict:
    """torch `state_dict` -> flax param tree of float32 numpy arrays: the
    inverse of `params_from_flax` (a `weight` becomes the transposed
    `kernel`)."""
    tree: dict = {}
    for path, value in params.items():
        *scopes, name = path.split(".")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        arr = value.detach().cpu().numpy().astype(np.float32)
        if name == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:
            node[name] = arr
    return tree


def _flat(prefix: str, params: dict) -> dict:
    """`params` as {'<prefix>/<flax path>': float32 array} ('/'-joined flax
    paths alone where `prefix` is empty); a split leaf (the list of its
    shards) gathered on the CPU."""
    params = {k: gather_leaf(k, [s.detach() for s in v], "cpu")
              if isinstance(v, list) else v for k, v in params.items()}
    out: dict = {}

    def walk(key, node):
        for k, v in node.items():
            path = f"{key}/{k}" if key else k
            if isinstance(v, dict):
                walk(path, v)
            else:
                out[path] = v

    walk(prefix, params_to_flax(params))
    return out


def export_params_npz(path: str, params: dict[str, torch.Tensor]) -> str:
    """Write `params` as the JAX package's single-file archive
    (`dl_ofdm_tpu/train/checkpoint.py::export_params_npz`: '/'-joined flax
    paths, float32, compressed), written to a temporary name and moved into
    place.  Returns `path`."""
    flat = _flat("", params)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)
    return path


def token_name(token: str, nbits: int, snr: float, cp: bool,
               opt: int | None = None, channel: str | None = None) -> str:
    """`<token>_<n>mod_snr<s>_cp<b>[_Equalizer<opt>_<chan>]`."""
    name = f"{token}_{nbits}mod_snr{int(snr)}_cp{cp}"
    if channel is not None:
        opt_str = "" if opt is None else str(opt)
        name += f"_Equalizer{opt_str}_{channel}"
    return name


# -- checkpoints: one directory, one named-key npz ----------------------------

def _unflat(data, prefix: str, like: dict, path: str, mesh=None) -> dict:
    """The tensors under `prefix/` of `data`, keyed, ordered, typed and
    placed as `like` (where `like` holds a list of a split leaf's shards,
    the tensor is split along its tp axis into shards placed as those:
    every shard, or this process's tp indices `mesh.local_tps` on a
    mesh); raises if their names or shapes differ from it."""
    tree: dict = {}
    start = prefix + "/"
    for key in data.files:
        if key.startswith(start):
            node = tree
            *scopes, name = key[len(start):].split("/")
            for sc in scopes:
                node = node.setdefault(sc, {})
            node[name] = data[key]
    got = params_from_flax(tree)
    if set(got) != set(like):
        raise ValueError(
            f"{path}: '{prefix}' holds {sorted(set(got) ^ set(like))} where "
            "the target does not, or lacks them")
    out = {}
    for k, v in like.items():
        want = list((v[0] if isinstance(v, list) else v).shape)
        if isinstance(v, list):
            tp = len(v) if mesh is None else mesh.shape["tp"]
            want[tp_axis(k, len(want))] *= tp
        if list(got[k].shape) != want:
            raise ValueError(f"{path}: '{prefix}' {k} has shape "
                             f"{tuple(got[k].shape)}, the target "
                             f"{tuple(want)}")
        if isinstance(v, list):
            tps = range(len(v)) if mesh is None else mesh.local_tps
            out[k] = [shard_of(k, got[k], tp, t).to(device=s.device,
                                                    dtype=s.dtype)
                      for t, s in zip(tps, v)]
        else:
            out[k] = got[k].to(device=v.device, dtype=v.dtype)
    return out


def _write_npz(path: str, arrays: dict) -> str:
    """`arrays` as `<path>/state.npz`, written to a temporary name and moved
    into place.  Returns the directory's absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "state.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def _state_arrays(state, mesh=None) -> dict | None:
    """The state's arrays in the process that writes (None in the others,
    which hand it their shards of the moments)."""
    opt = state.opt_state
    mu, nu = opt["mu"], opt["nu"]
    if mesh is not None:
        mu, nu = (gather_shards(mesh, m, "cpu") for m in (mu, nu))
    if not _writes(mesh):
        return None
    return {"step": np.int64(state.step), "opt/count": np.int64(opt["count"]),
            **_flat("params", state.params), **_flat("opt/mu", mu),
            **_flat("opt/nu", nu)}


def _writes(mesh) -> bool:
    """Whether this process writes: always, but on a mesh over processes,
    where process 0 alone does."""
    return mesh is None or not mesh.multiprocess or pd.is_main_process()


def _written(mesh) -> None:
    """On a mesh over processes, wait until process 0 has written."""
    if mesh is not None and mesh.multiprocess:
        pd.barrier(mesh.home)


def save(path: str, state, mesh=None) -> str:
    """Write a `TrainState` (params, Adam's count and moments, step) to the
    directory `path`.  On a mesh over processes every process calls it
    and process 0 writes.  Returns its absolute path."""
    arrays = _state_arrays(state, mesh)
    if arrays is not None:
        _write_npz(path, arrays)
    _written(mesh)
    return os.path.abspath(path)


def _restore_state(data, target, path: str, mesh=None):
    from dl_ofdm_tpu_torch.train.loop import TrainState
    opt = target.opt_state
    return TrainState(
        _unflat(data, "params", target.params, path),
        {"count": int(data["opt/count"]),
         "mu": _unflat(data, "opt/mu", opt["mu"], path, mesh),
         "nu": _unflat(data, "opt/nu", opt["nu"], path, mesh)},
        int(data["step"]))


def restore(path: str, target, mesh=None):
    """The `TrainState` saved at `path`, its tensors keyed, ordered, typed
    and placed as those of `target` (an `init_state()` result; on a mesh
    over processes, this process's, with `mesh`); raises if the names or
    shapes differ.  A mesh's replicas are the caller's to rebuild."""
    path = os.path.abspath(path)
    with np.load(os.path.join(path, STATE_FILE)) as data:
        return _restore_state(data, target, path, mesh)


# -- resume payloads (state + generator + cursors) ------------------------------

_SIG_LEN = 40   # a sha1 hexdigest


def _sig_to_array(sig: str | None) -> np.ndarray:
    buf = (sig or "").encode()[:_SIG_LEN].ljust(_SIG_LEN, b"\0")
    return np.frombuffer(buf, dtype=np.uint8).copy()


def _sig_from_array(arr) -> str | None:
    s = bytes(np.asarray(arr, dtype=np.uint8)).rstrip(b"\0").decode()
    return s or None


def save_resume(path: str, *, state, generator: torch.Generator, epoch: int,
                best_loss: float, best_epoch: int, best_params: dict,
                batch_frames: int, config_sig: str | None = None,
                mesh=None) -> str:
    """Write a full mid-run resume payload to the directory `path`: the
    state, `generator`'s state, the epoch and best cursors, the best params
    (not written again where they are the state's own tensors), the batch
    size and `config_sig`, embedded so that it is atomic with the payload.
    A sidecar `<path>.sig` copy is written after it, for inspection
    (`checkpoint.py:143-165`).  On a mesh over processes every process
    calls it and process 0 writes."""
    same = best_params.keys() == state.params.keys() and all(
        best_params[k] is v for k, v in state.params.items())
    arrays = _state_arrays(state, mesh)
    out = os.path.abspath(path)
    if arrays is None:
        _written(mesh)
        return out
    arrays.update({
        "generator": generator.get_state().numpy(),
        "config_sig": _sig_to_array(config_sig),
        "cursor/epoch": np.int64(epoch),
        "cursor/best_epoch": np.int64(best_epoch),
        "cursor/best_loss": np.float64(best_loss),
        "cursor/batch_frames": np.int64(batch_frames),
        "best_is_state": np.bool_(same)})
    if not same:
        arrays.update(_flat("best", best_params))
    _write_npz(path, arrays)
    if config_sig is not None:
        sig_path = out + ".sig"
        tmp = sig_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(config_sig)
        os.replace(tmp, sig_path)
    _written(mesh)
    return out


def has_checkpoint(path: str) -> bool:
    """Whether the directory `path` holds a checkpoint or resume payload."""
    return os.path.isfile(os.path.join(os.path.abspath(path), STATE_FILE))


has_resume = has_checkpoint


def resume_sig(path: str) -> str | None:
    """The configuration signature of the sidecar beside a resume payload
    (None where there is none)."""
    sig_path = os.path.abspath(path) + ".sig"
    if not os.path.isfile(sig_path):
        return None
    with open(sig_path) as f:
        return f.read().strip()


def restore_resume(path: str, state_target, mesh=None) -> dict:
    """A `save_resume` payload: {"state", "generator_state" (a CPU uint8
    tensor for `Generator.set_state`), "best_params", "config_sig" (the
    embedded one, else the sidecar's, else None), "cursor": {"epoch",
    "best_epoch", "best_loss", "batch_frames"}}; tensors as `restore`
    places them (this process's shards with `mesh`)."""
    path = os.path.abspath(path)
    with np.load(os.path.join(path, STATE_FILE)) as data:
        state = _restore_state(data, state_target, path, mesh)
        best = (state.params if bool(data["best_is_state"])
                else _unflat(data, "best", state_target.params, path))
        return {
            "state": state,
            "generator_state": torch.from_numpy(data["generator"].copy()),
            "best_params": best,
            "config_sig": (_sig_from_array(data["config_sig"])
                           or resume_sig(path)),
            "cursor": {"epoch": int(data["cursor/epoch"]),
                       "best_epoch": int(data["cursor/best_epoch"]),
                       "best_loss": float(data["cursor/best_loss"]),
                       "batch_frames": int(data["cursor/batch_frames"])}}
