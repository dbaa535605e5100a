"""One optimizer step over every leaf in one launch (`csrc/fused_adam.cu`).

The training step's optimizer layer: the L2 term's gradient (the fused
route's `stop_grad(BER) * reg_coeff * sum(0.01 ||w||^2)` over the `Dense`
leaves), Adam as `train.loop.Adam.update` computes it (optax's order, the
same float32 roundings) and the parameter write, with the fused step's loss
scalars.  No TPU kernel stands behind it: optax's update is XLA's to fuse.

  * `fused_adam_kernel` launches the CUDA kernel on a leaf set's
    `AdamLayout` (made once a leaf set and cached by its caller); it counts
    its launches in `fused_adam_kernel.launches`;
  * `fused_adam_ref` is its plain version, the same arithmetic in PyTorch
    operations: the reference the tests hold the kernel to; its L2 term
    and loss scalars, `l2_fold`, are also those of `train.loop.Adam.step`
    where the kernel does not take the leaves;
  * `AdamLayout.of` decides from the leaves alone whether the kernel takes
    them: float32 tensors on one CUDA device, parameters and moments
    contiguous, each gradient contiguous or a strided view of at most two
    dimensions, every leaf under 2^31 elements; `kernel_layout` copies
    other float32 CUDA leaves to that layout.

Both return an `AdamStep`: new tensors for the parameters and both moments
(the inputs are never written, so a caller's old state stays valid), the
loss scalars where the confusion counts are given, and the gradients the
update used on request.  The kernel's parameters, moments and gradients
are views of one buffer a step, each leaf's on 512 bytes; its loss scalars
are views of a 5-value buffer of their own, so a loss a caller keeps holds
20 bytes.  A layout keeps a few buffers of each kind with their views and
writes one again only once no caller holds any tensor on it
(`AdamLayout.take`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import operator
import sys
from typing import NamedTuple

import numpy as np
import torch

from dl_ofdm_tpu_torch.ops import cuda_build

# the source's THREADS * ITEMS, THREADS and MAX_LEAVES
TILE, THREADS, MAX_LEAVES = 1024, 256, 48
BLOCKS_PER_SM = 4
ALIGN = 128               # floats: each leaf's outputs start on 512 bytes
L2_SCALE = 0.01           # the Dense layers' l2(0.01)
DENSE = "Dense"           # the leaves the L2 term covers
SCALARS = ("reg", "ber", "log_ber", "loss", "total_loss")


@dataclasses.dataclass(frozen=True)
class AdamHyper:
    """One step's Adam scalars, in double as the host computes them; both
    versions round each to float32, as the foreach path rounds its
    scalars."""
    b1: float
    b2: float
    eps: float
    lr: float
    count: int            # the step's count (1 for the first update)

    def floats(self) -> tuple:
        """(b1, 1 - b1, b2, 1 - b2, 1 - b1^t, 1 - b2^t, eps, -lr)."""
        b1, b2, t = self.b1, self.b2, self.count
        return (b1, 1 - b1, b2, 1 - b2, 1 - b1 ** t, 1 - b2 ** t, self.eps,
                -self.lr)

    def kernel_floats(self) -> tuple:
        """`floats` with the bias corrections as their reciprocals: what
        PyTorch multiplies a CUDA tensor by where it divides it by them."""
        b1, omb1, b2, omb2, c1, c2, eps, neg_lr = self.floats()
        return b1, omb1, b2, omb2, 1.0 / c1, 1.0 / c2, eps, neg_lr


class AdamStep(NamedTuple):
    """Lists in the leaves' order; `scalars` (keys `SCALARS`, 0-dim float32)
    only with counts, `grads` only on request."""
    params: list
    mu: list
    nu: list
    scalars: dict | None
    grads: list | None


def l2_fold(keys, ws, gs, conf, ce, reg_coeff: float):
    """The fused step's L2 term in PyTorch operations: (the gradients, the
    `DENSE` leaves' with the L2 term's gradient added
    (`fused_model.reg_grads`), and the loss scalars `SCALARS`) from the
    int64 2x2 counts `conf` and the mean CE `ce`.  The kernel folds the
    same in its launch; `fused_adam_ref` and `train.loop.Adam.step`'s
    plain path fold with this."""
    # here, not at the top: `train` imports this module
    from dl_ofdm_tpu_torch.train import metrics as M
    log_ber, ber = M.ber_from_confusion(conf)
    factor = ber * (reg_coeff * 2.0 * L2_SCALE)
    gs = [g + w * factor if DENSE in k else g
          for k, w, g in zip(keys, ws, gs)]
    reg = M.l2_regularization(dict(zip(keys, ws)), L2_SCALE, DENSE)
    loss = ce + ber * reg_coeff * reg
    return gs, dict(zip(SCALARS, (reg, ber, log_ber, loss, loss + log_ber)))


def fused_adam_ref(keys, ws, gs, mus, nus, hp: AdamHyper, conf=None,
                   ce=None, reg_coeff: float = 0.0,
                   return_grads: bool = False) -> AdamStep:
    """The kernel's arithmetic in PyTorch operations, on any device.  With
    `conf` (int64 2x2 counts) and `ce`, the `DENSE` leaves' gradients take
    the L2 term and the loss scalars are those of the fused step
    (`l2_fold`)."""
    scalars = None
    if conf is not None:
        gs, scalars = l2_fold(keys, ws, gs, conf, ce, reg_coeff)
    # divisions by Python numbers, as the foreach path's: on the CPU a
    # division, on a card a product with the reciprocal (`kernel_floats`)
    b1, omb1, b2, omb2, c1, c2, eps, neg_lr = hp.floats()
    new_w, new_mu, new_nu = [], [], []
    for w, g, mu, nu in zip(ws, gs, mus, nus):
        m = g * omb1 + mu * b1
        v = (g * g) * omb2 + nu * b2
        new_w.append(w + ((m / c1) / (torch.sqrt(v / c2) + eps)) * neg_lr)
        new_mu.append(m)
        new_nu.append(v)
    return AdamStep(new_w, new_mu, new_nu, scalars,
                    list(gs) if return_grads else None)


def plain_float32(ws, gs, mus, nus) -> bool:
    """Every leaf's parameter, gradient and moments float32 tensors of one
    shape, all on one device: what either version takes (a split leaf's
    list of shards is not)."""
    ts = (*ws, *gs, *mus, *nus)
    if not ws or not all(isinstance(t, torch.Tensor) for t in ts):
        return False
    dev = ws[0].device
    return all(t.dtype == torch.float32 and t.device == dev for t in ts) \
        and all(g.shape == w.shape and m.shape == w.shape
                and v.shape == w.shape for w, g, m, v in zip(ws, gs, mus, nus))


class _AdamLeaf(ctypes.Structure):
    """`AdamLeaf` of csrc/fused_adam.cu, field for field."""
    _fields_ = [("w", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("off", ctypes.c_longlong), ("n", ctypes.c_int),
                ("cols", ctypes.c_int), ("s0", ctypes.c_int),
                ("s1", ctypes.c_int), ("tile0", ctypes.c_int),
                ("dense", ctypes.c_int)]


_FLOATS = ("b1", "omb1", "b2", "omb2", "r1", "r2", "eps", "neg_lr",
           "l2_coeff", "reg_coeff")


class _AdamArgs(ctypes.Structure):
    """`AdamArgs` of csrc/fused_adam.cu, field for field."""
    _fields_ = ([("out", ctypes.c_void_p), ("plane", ctypes.c_longlong)]
        + [(n, ctypes.c_void_p) for n in ("conf", "ce", "scalars",
                                          "partials", "chunk_sums", "done")]
        + [(n, ctypes.c_float) for n in _FLOATS]
        + [(n, ctypes.c_int) for n in ("leaves", "tiles", "grid", "chunk",
                                       "chunks", "write_grads")]
        + [("leaf", _AdamLeaf * MAX_LEAVES)])


def _grad_view(g: torch.Tensor):
    """(cols, s0, s1): element e of the leaf at g[(e // cols) * s0 +
    (e % cols) * s1]; None for a layout the kernel does not read."""
    if g.is_contiguous():
        return 1, 1, 0
    if g.dim() == 1:
        return 1, g.stride(0), 0
    if g.dim() == 2:
        return g.shape[1], g.stride(0), g.stride(1)
    return None


def kernel_layout(ws, gs, mus, nus):
    """The leaves in the layout the kernel reads (parameters and moments
    contiguous, a gradient of more than two dimensions contiguous unless it
    is), copying only what is not; None where they are not float32 tensors
    of one shape on one CUDA device (CPU leaves, a split leaf's shards).
    Raises on a leaf of 2^31 - TILE elements or more."""
    if not plain_float32(ws, gs, mus, nus) or ws[0].device.type != "cuda":
        return None
    if any(w.numel() >= 2 ** 31 - TILE for w in ws):
        raise ValueError("fused_adam_kernel takes leaves of fewer than "
                         f"2^31 - {TILE} elements")
    return ([w.contiguous() for w in ws],
            [g if _grad_view(g) is not None else g.contiguous() for g in gs],
            [m.contiguous() for m in mus], [v.contiguous() for v in nus])


class _Launch(NamedTuple):
    args: _AdamArgs
    ref: object              # ctypes.byref(args)
    ptrs: np.ndarray         # uint64 view of args
    slots: np.ndarray        # where in `ptrs` each leaf's 4 pointers go
    sel: np.ndarray          # which of the step's pointers goes there


class _Slot(NamedTuple):
    """One output buffer and its views: `planes[p][i]` is leaf i's plane p
    (parameters, first and second moments, gradients), `views` all of
    them; `base` what `_holds` reads while only the layout holds the
    buffer."""
    buf: torch.Tensor
    planes: list
    views: list
    base: list


def _holds(slot: _Slot) -> list:
    """The use count of the slot's storage, then each view's reference
    count: a tensor that shares the buffer (any view or alias of it) adds
    to the first, a reference to one of the slot's views to the others."""
    return [torch._C._storage_Use_Count(slot.buf.untyped_storage()._cdata),
            *map(sys.getrefcount, slot.views)]


class AdamLayout:
    """The launches of one leaf set (keys, shapes, gradient layouts, device):
    each leaf's output offset and tiles, one `AdamArgs` a chunk of up to
    MAX_LEAVES leaves with everything but the step's pointers and scalars
    written, the loss scalars' workspace (block partials, chunk sums, the
    finished-blocks counter), zeroed once, and a few output buffers.

    Outputs: a step writes a buffer that nothing outside the layout holds,
    and the loss scalars into a small one of their own, and hands out
    their views.  Where the caller has let go of
    every view of an earlier step's buffer and of every tensor on it (its
    storage's use count and its views' reference counts are the layout's
    own), the buffer and its views serve again, so a step makes no tensor;
    otherwise it takes a new one.  No tensor a caller holds is written.
    The layout keeps its POOL newest buffers: a step's input and output
    and one a caller still holds for a while (a state kept as the best).

    The reuse assumes one stream, the current one, for every step and
    every reader of its outputs, and holders that Python sees: a tensor
    that shares the buffer, or a reference to one of its views.  A C++
    owner of a view's own tensor (a saved tensor of a graph not yet run
    backward, a collective's pending work, a captured CUDA graph) is not
    seen; the port hands its outputs to none of them."""

    POOL = 3                  # buffers kept a plane count

    def __init__(self, keys, ws, gs, sms: int):
        dev = ws[0].device
        self.device, self.index = dev, ws[0].get_device()
        self.keys = list(keys)
        self.shapes = [w.shape for w in ws]
        self.gstrides = [g.stride() for g in gs]
        ns = [w.numel() for w in ws]
        offs, pos = [], 0
        for n in ns:
            offs.append(pos)
            pos += -(-n // ALIGN) * ALIGN
        self.plane = pos
        # each leaf's parameters, moments (and gradients) as views of a
        # plane: (shape, strides, offset in the plane)
        self.views = [(s, torch.empty(s, device="meta").stride(), o)
                      for s, o in zip(self.shapes, offs)]
        self.pool = {0: [], 3: [], 4: []}
        groups = [range(i, min(i + MAX_LEAVES, len(ws)))
                  for i in range(0, len(ws), MAX_LEAVES)]
        tiles = [sum(-(-ns[i] // TILE) for i in grp) for grp in groups]
        grids = [min(t, BLOCKS_PER_SM * sms) for t in tiles]
        # float64 block partials, chunk sums, then the uint32 counter
        self.work = torch.zeros(max(grids) + len(groups) + 1,
                                dtype=torch.float64, device=dev)
        work = self.work.data_ptr()
        size = ctypes.sizeof(_AdamLeaf) // 8
        first = _AdamArgs.leaf.offset // 8
        self.launches = []
        for c, (grp, n_tiles, grid) in enumerate(zip(groups, tiles, grids)):
            a = _AdamArgs(plane=self.plane, partials=work,
                          chunk_sums=work + 8 * max(grids),
                          done=work + 8 * (max(grids) + len(groups)),
                          leaves=len(grp), tiles=n_tiles, grid=grid,
                          chunk=c, chunks=len(groups))
            tile0 = 0
            for j, i in enumerate(grp):
                leaf = a.leaf[j]
                leaf.off, leaf.n, leaf.tile0 = offs[i], ns[i], tile0
                leaf.cols, leaf.s0, leaf.s1 = _grad_view(gs[i])
                leaf.dense = int(DENSE in keys[i])
                tile0 += -(-ns[i] // TILE)
            slots = [first + j * size + f for j in range(len(grp))
                     for f in range(4)]
            sel = [4 * i + f for i in grp for f in range(4)]
            self.launches.append(_Launch(
                a, ctypes.byref(a), np.frombuffer(a, np.uint8).view(np.uint64),
                np.array(slots), np.array(sel)))

    @staticmethod
    def key(keys, ws, gs, mus, nus):
        """What a layout depends on, or None where the kernel does not take
        these leaves."""
        if not plain_float32(ws, gs, mus, nus) or ws[0].device.type != "cuda":
            return None
        if not all(t.is_contiguous() for t in (*ws, *mus, *nus)) or any(
                w.numel() >= 2 ** 31 - TILE or _grad_view(g) is None
                for w, g in zip(ws, gs)):
            return None
        return (ws[0].device, tuple(keys), tuple(w.shape for w in ws),
                tuple(g.stride() for g in gs))

    def _made(self, keys, ws, gs, mus, nus) -> bool:
        """Whether the leaves are this layout's without the full check:
        parameters and moments one of its buffers' views (so laid out as it
        lays them out) and gradients of its shapes and strides."""
        if keys != self.keys:
            return False
        slots = (*self.pool[3][::-1], *self.pool[4])
        for p, ts in enumerate((ws, mus, nus)):
            if not any(all(map(operator.is_, ts, s.planes[p])) for s in slots):
                return False
        return all(isinstance(g, torch.Tensor) and g.dtype == torch.float32
                   and g.get_device() == self.index for g in gs) \
            and [g.stride() for g in gs] == self.gstrides \
            and [g.shape for g in gs] == self.shapes

    @classmethod
    def of(cls, cache: dict, keys, ws, gs, mus, nus):
        """The cached layout of these leaves (made on first sight), or None
        where the kernel does not take them.  `cache[None]` holds the last
        layout given, whose own outputs pass on a shorter check."""
        last = cache.get(None)
        if last is not None and last._made(keys, ws, gs, mus, nus):
            return last
        key = cls.key(keys, ws, gs, mus, nus)
        if key is None:
            return None
        lay = cache.get(key)
        if lay is None:
            sms = torch.cuda.get_device_properties(key[0]).multi_processor_count
            lay = cache[key] = cls(keys, ws, gs, sms)
        cache[None] = lay
        return lay

    def write(self, ptrs: np.ndarray) -> None:
        """Each leaf's four pointers from `ptrs` (w, g, mu, nu of leaf 0,
        then of leaf 1, ...) into its launch's arguments."""
        for c in self.launches:
            c.ptrs[c.slots] = ptrs[c.sel]

    def take(self, planes: int) -> _Slot:
        """An output buffer of `planes` planes (0: the loss scalars, a
        buffer of their own with one 0-dim view each) that nothing outside
        the layout holds: a kept one where one is free, else a new one,
        kept in place of the oldest where POOL are kept (a caller may still
        hold that one: it is freed with the caller's last tensor on it)."""
        pool = self.pool[planes]
        for slot in reversed(pool):          # the newest is the input
            if _holds(slot) == slot.base:
                return slot
        if planes:
            buf = torch.empty(planes * self.plane, device=self.device)
            ps = [[buf.as_strided(s, st, p * self.plane + o)
                   for s, st, o in self.views] for p in range(planes)]
        else:
            buf = torch.empty(len(SCALARS), device=self.device)
            ps = [list(buf.unbind())]
        slot = _Slot(buf, ps, [v for plane in ps for v in plane], [])
        slot.base.extend(_holds(slot))
        pool.append(slot)
        del pool[:-self.POOL]
        return slot


@functools.cache
def _adam_fn():
    fn = cuda_build.load("fused_adam").fused_adam
    fn.argtypes = [ctypes.POINTER(_AdamArgs), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_adam_kernel(lay: AdamLayout, ws, gs, mus, nus, hp: AdamHyper,
                      conf=None, ce=None, reg_coeff: float = 0.0,
                      return_grads: bool = False) -> AdamStep:
    """Launch the kernel on leaves that `lay` was made for
    (`AdamLayout.of`): one launch a chunk of MAX_LEAVES leaves, one for
    the nets of the port.  `conf` (int64 [2, 2] contiguous) and `ce`
    (float32, one element), on the leaves' device, turn on the L2 term and
    the loss scalars."""
    l2 = conf is not None
    if l2 and not (
            conf.dtype == torch.int64 and conf.shape == (2, 2)
            and conf.is_contiguous() and conf.get_device() == lay.index
            and ce.dtype == torch.float32 and ce.numel() == 1
            and ce.get_device() == lay.index):
        raise ValueError("fused_adam_kernel takes int64 [2, 2] contiguous "
                         "counts and a float32 CE on the leaves' device")
    planes = 4 if return_grads else 3
    slot = lay.take(planes)
    base = slot.buf.data_ptr()
    sc = lay.take(0) if l2 else None
    lay.write(np.array([t.data_ptr() for quad in zip(ws, gs, mus, nus)
                        for t in quad], np.uint64))
    floats = hp.kernel_floats() + (reg_coeff * 2.0 * L2_SCALE, reg_coeff)
    fn = _adam_fn()
    stream = torch._C._cuda_getCurrentRawStream(lay.index)
    for c in lay.launches:
        a = c.args
        a.out, a.write_grads = base, int(return_grads)
        a.conf = conf.data_ptr() if l2 else None
        a.ce = ce.data_ptr() if l2 else None
        a.scalars = sc.buf.data_ptr() if l2 else None
        for name, v in zip(_FLOATS, floats):
            setattr(a, name, v)
        err = fn(c.ref, lay.index, stream)
        if err != 0:
            raise RuntimeError(f"fused_adam kernel launch failed: CUDA "
                               f"error {err}")
        fused_adam_kernel.launches += 1
    # new lists and dict: the caller's references to the views
    p = slot.planes
    return AdamStep(list(p[0]), list(p[1]), list(p[2]),
                    dict(zip(SCALARS, sc.planes[0])) if l2 else None,
                    list(p[3]) if return_grads else None)


fused_adam_kernel.launches = 0
