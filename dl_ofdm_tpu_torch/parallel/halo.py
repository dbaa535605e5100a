"""Halo-exchange FIR over a ring of ranks (overlap-save across shards).

Port of `dl_ofdm_tpu/parallel/halo.py`.  A long IQ time block is cut
along time into one shard per rank (the sequence-parallel counterpart of
the FIR channel, SURVEY.md section 5.7); each shard needs F - 1 boundary
samples of its neighbours to compute its part of np.convolve's 'same'
window exactly.  The halos travel around the ring in one of two ways:

  * 'ppermute', the counterpart of the XLA collective: tensor copies
    between the ranks' devices (`Tensor.to`; on one card a view);
  * 'dma', the counterpart of the Pallas `make_async_remote_copy` kernel
    (`_dma_ring_exchange`, `halo.py:27-72`): `ring_exchange`, which
    launches `csrc/ring_exchange.cu` for ranks on CUDA devices and takes
    its plain version `ring_exchange_ref` for ranks on the CPU.

The global edges are zero (np.convolve's zero padding).  Each rank's FIR is
`fir_shift_accum` on its extended window: the same operations in the same
order as `channel.fir.fir_same_iq` of the whole block, so the result is
bit-equal to it.

A rank is one entry of the device list; a device may repeat (virtual
ranks, `parallel/mesh.py`).  Nothing here falls back: a CUDA rank goes
through the kernel, and a failed build or launch raises.

CUDA graphs: the ring keeps no state on the host, so on one card the whole
halo FIR (`exchange='dma'`) is captured with `torch.cuda.graph` as it
stands and replays with new shard contents.  Across cards, capture one
graph a card around `ring_exchange_kernel(..., out=, device=)` and replay
every card's graph the same number of times.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from dl_ofdm_tpu_torch.ops import cuda_build
from dl_ofdm_tpu_torch.ops.pallas_kernels import fir_shift_accum
from dl_ofdm_tpu_torch.parallel.mesh import Mesh

RING_MAX_RANKS = 16          # csrc/ring_exchange.cu: RING_MAX_RANKS
RING_WORDS = 3               # a side's words on its card: epoch, credit, data


def ring_exchange_ref(left_tails: list, right_heads: list):
    """recv_l[r] = left_tails[(r - 1) mod P] and recv_r[r] =
    right_heads[(r + 1) mod P], each a new tensor on rank r's device (the
    device of `left_tails[r]`): plain copies in rank order.  At P = 1 a
    rank receives its own slices."""
    p = len(left_tails)
    devs = [t.device for t in left_tails]
    recv_l = [left_tails[(r - 1) % p].to(devs[r], copy=True)
              for r in range(p)]
    recv_r = [right_heads[(r + 1) % p].to(devs[r], copy=True)
              for r in range(p)]
    return recv_l, recv_r


class _RingSide(ctypes.Structure):
    """`RingSide` of csrc/ring_exchange.cu, field for field."""
    _fields_ = [("src", ctypes.c_void_p), ("src_stride", ctypes.c_longlong),
                ("dst", ctypes.c_void_p), ("epoch", ctypes.c_void_p),
                ("credit_in", ctypes.c_void_p), ("data_in", ctypes.c_void_p),
                ("credit_out", ctypes.c_void_p),
                ("data_out", ctypes.c_void_p)]


class _RingArgs(ctypes.Structure):
    """`RingArgs` of csrc/ring_exchange.cu, field for field."""
    _fields_ = [("blocks", ctypes.c_int), ("rows", ctypes.c_int),
                ("cols", ctypes.c_int * 2),
                ("side", _RingSide * (2 * RING_MAX_RANKS))]


_WORD_FIELDS = ("epoch", "credit_in", "data_in", "credit_out", "data_out")


@functools.cache
def _ring_lib():
    lib = cuda_build.load("ring_exchange")
    lib.ring_exchange_f32.argtypes = [ctypes.POINTER(_RingArgs),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.ring_exchange_f32.restype = ctypes.c_int
    lib.ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.ring_enable_peer.restype = ctypes.c_int
    lib.ring_empty_launch.argtypes = [ctypes.c_void_p]
    lib.ring_empty_launch.restype = ctypes.c_int
    return lib


class RingSidePlan(NamedTuple):
    """One block of the ring.  Rank `rank` pushes its left tail (direction
    0) into `dst_rank`'s recv_l, or its right head (direction 1) into
    `dst_rank`'s recv_r; `src_rank`'s side of the same direction fills
    the rank's own receive buffer.  Its handshake words, each a (card,
    word) of the cards' word tensors: `epoch`, `credit_in` and `data_in`
    are its own, on its card; `credit_out` is `src_rank`'s side's
    credit_in and `data_out` is `dst_rank`'s side's data_in."""
    rank: int
    direction: int
    dst_rank: int
    src_rank: int
    epoch: tuple
    credit_in: tuple
    data_in: tuple
    credit_out: tuple
    data_out: tuple


class RingCardPlan(NamedTuple):
    """A card's launch: its ranks in rank order; block 2j is the left tail
    of ranks[j], block 2j + 1 its right head."""
    device: torch.device
    ranks: tuple
    sides: tuple


class RingPlan(NamedTuple):
    """The ring over a tuple of rank devices: `template` 'copy' where every
    rank is on one card (one launch of 2P blocks, no words), 'handshake'
    where they span cards (one launch a card, RING_WORDS words a side on
    its card); the cards in order of their first rank; each rank's card
    index and its slot among that card's ranks."""
    template: str
    cards: tuple
    card_of: tuple
    slot_of: tuple


def ring_plan(devices) -> RingPlan:
    """The ring's launch plan over `devices` (one entry a rank, repeats
    allowed); needs no card.  Raises outside 1..RING_MAX_RANKS ranks."""
    p = len(devices)
    if not 1 <= p <= RING_MAX_RANKS:
        raise ValueError(f"ring_exchange_kernel: 1..{RING_MAX_RANKS} ranks, "
                         f"got {p}")
    ranks_of: dict = {}
    card_of, slot_of = [], []
    for r, d in enumerate(devices):
        ranks = ranks_of.setdefault(d, [])
        card_of.append(list(ranks_of).index(d))
        slot_of.append(len(ranks))
        ranks.append(r)

    def word(r, direction, k):
        return card_of[r], RING_WORDS * (2 * slot_of[r] + direction) + k

    cards = []
    for dev, ranks in ranks_of.items():
        sides = []
        for r in ranks:
            for direction, shift in ((0, 1), (1, -1)):
                dst, src = (r + shift) % p, (r - shift) % p
                sides.append(RingSidePlan(
                    r, direction, dst, src, word(r, direction, 0),
                    word(r, direction, 1), word(r, direction, 2),
                    word(src, direction, 1), word(dst, direction, 2)))
        cards.append(RingCardPlan(dev, tuple(ranks), tuple(sides)))
    return RingPlan("copy" if len(cards) == 1 else "handshake", tuple(cards),
                    tuple(card_of), tuple(slot_of))


class _Ring:
    """A ring's state, made once a tuple of rank devices: its plan and, for
    the handshake, its words (int32 zeros, RING_WORDS a side, on each card;
    never reset: the epochs only grow) with peer access enabled between
    neighbouring cards.  Raises where a pair cannot reach each other
    (nothing is staged through the host), or where it would be made inside
    a CUDA graph capture."""

    def __init__(self, devs: tuple):
        self.plan = plan = ring_plan(devs)
        self.word_base: list[int] = []
        self.words: list[torch.Tensor] = []
        if plan.template == "copy":
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "ring_exchange_kernel: run one exchange on these devices "
                "before capturing one; its handshake words are made then")
        p = len(devs)
        for r, d in enumerate(devs):
            for nb in {devs[(r - 1) % p], devs[(r + 1) % p]}:
                if nb != d and not enable_peer_access(d.index, nb.index):
                    raise RuntimeError(
                        f"ring_exchange_kernel: {d} cannot reach {nb}'s "
                        "memory (no peer access); the ring does not stage "
                        "through the host")
        for card in plan.cards:
            w = torch.zeros(2 * RING_WORDS * len(card.ranks),
                            dtype=torch.int32, device=card.device)
            # zero before any partner's first store lands
            torch.cuda.synchronize(card.device)
            self.words.append(w)
            self.word_base.append(w.data_ptr())


_RINGS: dict[tuple, _Ring] = {}


class _CardLaunch(NamedTuple):
    """One card's launch: its `_RingArgs` (`ref` passes it to the library),
    a uint64 view of the struct's bytes, and for each pointer slot of the
    view (`slots`) the index of its pointer among a call's (`sel`)."""
    device: torch.device
    args: _RingArgs
    ref: object
    view: np.ndarray
    slots: np.ndarray
    sel: np.ndarray


class _RingLaunch:
    """The launch plan of one (devices, shapes, strides): a `_RingArgs` a
    card with all but the tensors' pointers written, a numpy view of it and
    the source of each pointer slot, and the receive buffers' layout, one
    contiguous buffer a card: its ranks' recv_l, then their recv_r."""

    def __init__(self, ring: _Ring, shape_l, shape_r, strides_l, strides_r):
        plan = ring.plan
        p = len(plan.card_of)
        b, hl, hr = shape_l[0], shape_l[1], shape_r[1]
        self.p, self.handshake = p, int(plan.template == "handshake")
        self.shapes = (tuple(shape_l), tuple(shape_r))
        n_l, n_r = b * hl * 2, b * hr * 2
        self.cards = [(c.device, len(c.ranks) * n_l, len(c.ranks) * n_r,
                       c.ranks) for c in plan.cards]
        # pointer sources: the 2P slices, then recv_l[r] and recv_r[r],
        # each at a byte offset of its card's buffer
        self.recv_card = np.array(plan.card_of * 2)
        self.recv_off = np.array(
            [4 * plan.slot_of[r] * n_l for r in range(p)]
            + [4 * (self.cards[plan.card_of[r]][1] + plan.slot_of[r] * n_r)
               for r in range(p)], np.uint64)
        first = _RingArgs.side.offset // 8
        size = ctypes.sizeof(_RingSide) // 8
        src, dst = _RingSide.src.offset // 8, _RingSide.dst.offset // 8
        self.launches = []
        for card in plan.cards:
            args = _RingArgs(blocks=len(card.sides), rows=b)
            args.cols[0], args.cols[1] = 2 * hl, 2 * hr
            slots, sel = [], []
            for i, sd in enumerate(card.sides):
                side = args.side[i]
                side.src_stride = (strides_l, strides_r)[sd.direction][sd.rank]
                for name in _WORD_FIELDS if ring.words else ():
                    c, w = getattr(sd, name)
                    setattr(side, name, ring.word_base[c] + 4 * w)
                slots += [first + i * size + src, first + i * size + dst]
                sel += [sd.direction * p + sd.rank,
                        (2 + sd.direction) * p + sd.dst_rank]
            self.launches.append(_CardLaunch(
                card.device, args, ctypes.byref(args),
                np.frombuffer(args, np.uint8).view(np.uint64),
                np.array(slots), np.array(sel)))

    def write(self, ptrs: np.ndarray) -> None:
        """Write every card's pointers from `ptrs`: the 2P slices (left
        tails, then right heads) and the 2P receive buffers (recv_l, then
        recv_r)."""
        for c in self.launches:
            c.view[c.slots] = ptrs[c.sel]

    def alloc(self):
        """Fresh receive buffers, one `torch.empty` a card: (recv_l, recv_r,
        the cards' base addresses)."""
        (b, hl, _), (_, hr, _) = self.shapes
        recv_l, recv_r = [None] * self.p, [None] * self.p
        bases = []
        for dev, n_l, n_r, ranks in self.cards:
            k = len(ranks)
            if hl == hr:                    # one view, one unbind
                buf = torch.empty(2 * k, b, hl, 2, device=dev)
                views = buf.unbind(0)
                ls, rs = views[:k], views[k:]
            else:
                buf = torch.empty(n_l + n_r, device=dev)
                ls = buf[:n_l].view(k, b, hl, 2).unbind(0)
                rs = buf[n_l:].view(k, b, hr, 2).unbind(0)
            bases.append(buf.data_ptr())
            for r, a, c in zip(ranks, ls, rs):
                recv_l[r], recv_r[r] = a, c
        return recv_l, recv_r, np.array(bases, np.uint64)

    def out_ptrs(self, out) -> np.ndarray:
        """The pointers of caller-given receive buffers, checked."""
        if len(out) != 2 or any(len(o) != self.p for o in out):
            raise ValueError(f"ring_exchange_kernel: out = (recv_l, recv_r), "
                             f"{self.p} tensors each")
        ptrs = []
        for recv, shape in zip(out, self.shapes):
            for r, t in enumerate(recv):
                dev = self.cards[int(self.recv_card[r])][0]
                if t.device != dev or t.dtype != torch.float32 or tuple(
                        t.shape) != shape or not t.is_contiguous():
                    raise ValueError(
                        f"ring_exchange_kernel: out tensor {r} must be "
                        f"contiguous float32 {shape} on {dev}")
                ptrs.append(t.data_ptr())
        return np.array(ptrs, np.uint64)


_LAUNCHES: dict[tuple, _RingLaunch] = {}


@functools.cache
def enable_peer_access(dev: int, peer: int) -> bool:
    """Let CUDA device `dev` reach `peer`'s memory (once a pair); False
    where it cannot, in which case the ring refuses the pair."""
    can = ctypes.c_int(0)
    err = _ring_lib().ring_enable_peer(dev, peer, ctypes.byref(can))
    if err != 0:
        raise RuntimeError(f"enabling peer access {dev} -> {peer} failed: "
                           f"CUDA error {err}")
    return bool(can.value)


def _side_strides(t: torch.Tensor) -> int:
    """The row stride (floats) of a [B, n, 2] slice whose rows are
    contiguous runs of 2n floats; raises on any other layout."""
    if t.dim() != 3 or t.shape[2] != 2 or (
            t.shape[1] > 1 and t.stride(1) != 2) or t.stride(2) != 1:
        raise ValueError(f"ring_exchange_kernel: a slice [B, n, 2] with "
                         f"contiguous rows, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t.stride(0)


def _ring_launch(left_tails: list, right_heads: list) -> _RingLaunch:
    """Check a call's slices and make its launch plan."""
    p = len(left_tails)
    if not 1 <= p <= RING_MAX_RANKS or len(right_heads) != p:
        raise ValueError(f"ring_exchange_kernel: 1..{RING_MAX_RANKS} ranks "
                         f"with one left tail and one right head each, got "
                         f"{p} and {len(right_heads)}")
    devs = tuple(t.device for t in left_tails)
    ts = list(left_tails) + list(right_heads)
    if not all(d.type == "cuda" for d in devs) or any(
            h.device != d for h, d in zip(right_heads, devs)):
        raise ValueError("ring_exchange_kernel: each rank's slices on its "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ring_exchange_kernel takes float32 tensors")
    shape_l, shape_r = left_tails[0].shape, right_heads[0].shape
    if any(t.shape != shape_l for t in left_tails) or any(
            t.shape != shape_r for t in right_heads) or \
            shape_l[0] != shape_r[0] or shape_l[0] < 1 or \
            shape_l[1] < 1 or shape_r[1] < 1:
        raise ValueError(f"ring_exchange_kernel: every left tail [B, hl, 2] "
                         f"and right head [B, hr, 2] alike, got "
                         f"{tuple(shape_l)} and {tuple(shape_r)}")
    strides_l = [_side_strides(t) for t in left_tails]
    strides_r = [_side_strides(t) for t in right_heads]
    ring = _RINGS.get(devs)
    if ring is None:
        ring = _RINGS[devs] = _Ring(devs)
    return _RingLaunch(ring, shape_l, shape_r, strides_l, strides_r)


def _launch_of(left_tails: list, right_heads: list) -> _RingLaunch:
    key = tuple((t.device, t.dtype, t.shape, t.stride())
                for t in (*left_tails, *right_heads))
    launch = _LAUNCHES.get(key)
    if launch is None:
        launch = _LAUNCHES[key] = _ring_launch(left_tails, right_heads)
    return launch


def ring_buffers(left_tails: list, right_heads: list):
    """Receive buffers for `ring_exchange_kernel(..., out=)`: (recv_l,
    recv_r), fresh, one `torch.empty` a card, as a call makes them."""
    recv_l, recv_r, _ = _launch_of(left_tails, right_heads).alloc()
    return recv_l, recv_r


def ring_exchange_kernel(left_tails: list, right_heads: list, out=None,
                         device=None):
    """Launch the ring kernel: every rank's slices on a CUDA device,
    float32, left tails [B, hl, 2] and right heads [B, hr, 2] with
    contiguous rows (row strides are passed; `x[:, -hl:, :]` of a
    contiguous shard qualifies) -> (recv_l, recv_r), as
    `ring_exchange_ref`, fresh tensors (one buffer a card).  Raises on
    anything else, and where two neighbouring cards cannot reach each
    other (nothing is staged through the host).

    Every rank on one card: one launch of the copy template.  Ranks on
    two or more cards: one launch of the handshake template a card, on
    its current stream, each depending on nothing but that stream; the
    launches are issued back to back with no host sync.  A stream must
    not wait on another card's ring launch before its own card's launch
    is issued, or the two deadlock.  The handshake's state lives on the
    cards, so the exchange can be captured in a CUDA graph and replayed
    with nothing reset; run one exchange on the devices before the first
    capture, which makes that state.

    out: (recv_l, recv_r), P tensors each (`ring_buffers` makes them) to
      fill instead of fresh ones.
    device: launch only this card's part, with `out` (every card pushes
      into the others' buffers): to capture each card in its own CUDA
      graph.  Every card's part must then run the same number of times,
      each card's graph replayed as often as the others', or a card waits
      for a partner that never comes (the kernel traps after 10 s).
    """
    launch = _launch_of(left_tails, right_heads)
    if device is not None:
        device = torch.device(device)
    if out is None:
        if device is not None:
            raise ValueError("ring_exchange_kernel: one card's part needs "
                             "out=, the buffers every card pushes into")
        recv_l, recv_r, bases = launch.alloc()
        recv = bases[launch.recv_card] + launch.recv_off
    else:
        recv_l, recv_r = out
        recv = launch.out_ptrs(out)
    ptrs = np.concatenate((np.array([t.data_ptr() for t in (
        *left_tails, *right_heads)], np.uint64), recv))
    launch.write(ptrs)
    lib = _ring_lib()
    ran = False
    for c in launch.launches:
        if device is not None and c.device != device:
            continue
        # the current stream's handle, without building a Stream object
        index = c.device.index
        err = lib.ring_exchange_f32(c.ref, launch.handshake, index,
                                    torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"ring_exchange kernel launch on {c.device} "
                               f"failed: CUDA error {err}")
        ring_exchange_kernel.launches += 1
        ran = True
    if not ran:
        raise ValueError(f"ring_exchange_kernel: no rank on {device}")
    return recv_l, recv_r


ring_exchange_kernel.launches = 0


def ring_exchange(left_tails: list, right_heads: list):
    """Each rank's `left_tail` to its right neighbour and `right_head` to
    its left one: (recv_l, recv_r) with recv_l[r] = left_tails[(r-1) mod P]
    and recv_r[r] = right_heads[(r+1) mod P], unmasked, any P >= 1.  The
    kernel where the ranks lie on CUDA devices, the plain version where
    they lie on the CPU; a mix raises."""
    kinds = {t.device.type for t in list(left_tails) + list(right_heads)}
    if kinds == {"cpu"}:
        return ring_exchange_ref(left_tails, right_heads)
    if kinds == {"cuda"}:
        return ring_exchange_kernel(left_tails, right_heads)
    raise ValueError(f"ring_exchange: ranks on {sorted(kinds)}; all on "
                     "CUDA devices or all on the CPU")


_dma_ring_exchange = ring_exchange      # the JAX package's name


def _ppermute(slices: list, shift: int, devs: list) -> list:
    """recv[r] = slices[(r - shift) mod P] on rank r's device (the
    `jax.lax.ppermute` of `perm=[(i, (i + shift) % P)]`)."""
    p = len(slices)
    return [slices[(r - shift) % p].to(devs[r]) for r in range(p)]


def _ranks(mesh_or_devices) -> list[torch.device]:
    if isinstance(mesh_or_devices, Mesh):
        return list(mesh_or_devices.devices.flat)
    return [torch.device(d) for d in mesh_or_devices]


def halo_fir_same_iq(shards: list, h: torch.Tensor, offset: int,
                     mesh_or_devices, exchange: str = "ppermute") -> list:
    """The 'same' FIR of a block cut along time over a ring of ranks.

    Args:
      shards: P tensors [B, L_local, 2], rank r's on its device: the block
        [B, P * L_local, 2] cut into consecutive pieces.
      h: [B, F, 2] FIR kernels, the same for every rank (moved to each).
      offset: static alignment in [0, F-1]: (F-1)//2 for np.convolve
        'same', 0 for causal filtering.
      mesh_or_devices: a `Mesh` (its devices in order) or the P devices.
      exchange: 'ppermute' (copies between the ranks' devices) or 'dma'
        (`ring_exchange`: the ring kernel on CUDA ranks).

    Returns the P output shards [B, L_local, 2]: out[n] = sum_k h[k]
    x[n + offset - k] over the whole block, zero outside it.
    """
    devs = _ranks(mesh_or_devices)
    p = len(devs)
    if len(shards) != p:
        raise ValueError(f"{len(shards)} shards for {p} ranks")
    f = h.shape[1]
    b, l_local, _ = shards[0].shape
    if not 0 <= offset <= f - 1:
        raise ValueError(f"offset {offset} outside [0, {f - 1}]")
    halo_l, halo_r = f - 1 - offset, offset
    if l_local < max(halo_l, halo_r, 1):
        raise ValueError(f"a shard of {l_local} samples is shorter than "
                         f"its halo ({max(halo_l, halo_r)})")
    if exchange == "dma":
        if halo_l or halo_r:
            # the ring moves max(halo, 1) samples each way; the padded
            # exchange of a zero halo is left unused, as in JAX
            hl, hr = max(halo_l, 1), max(halo_r, 1)
            recv_l, recv_r = ring_exchange([x[:, -hl:, :] for x in shards],
                                           [x[:, :hr, :] for x in shards])
        else:
            recv_l = recv_r = None
    elif exchange == "ppermute":
        recv_l = (_ppermute([x[:, -halo_l:, :] for x in shards], 1, devs)
                  if halo_l else None)
        recv_r = (_ppermute([x[:, :halo_r, :] for x in shards], -1, devs)
                  if halo_r else None)
    else:
        raise ValueError(exchange)
    out = []
    for r, (x, dev) in enumerate(zip(shards, devs)):
        parts = []
        if halo_l:
            parts.append(torch.zeros_like(recv_l[r]) if r == 0
                         else recv_l[r])
        parts.append(x)
        if halo_r:
            parts.append(torch.zeros_like(recv_r[r]) if r == p - 1
                         else recv_r[r])
        ext = torch.cat(parts, dim=1)       # [B, halo_l + L_local + halo_r, 2]
        hd = h.to(dev)
        # ext[m] = x_global[start - halo_l + m], so out[n] = sum_k h[k]
        # ext[n + F - 1 - k]: fir_shift_accum's pre-aligned rows
        yr, yi = fir_shift_accum(ext[..., 0], ext[..., 1], hd[..., 0],
                                 hd[..., 1], l_local)
        out.append(torch.stack([yr, yi], dim=-1))
    return out
