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

Across processes (a `Mesh` over a `torch.distributed` group, each process
passing its own ranks' shards): 'ppermute' is `batch_isend_irecv` between
the processes (NCCL on cards, gloo on the CPU; card tensors over gloo
raise: nothing is staged through the host), as is 'dma' on CPU ranks; 'dma'
on card ranks is `ring_exchange_across`, the ring kernel's handshake
template with each process launching only its own ranks' blocks, on its
own stream, into receive buffers and handshake words that the kernel
library allocates and every partner maps through CUDA IPC (the handles go
round by `all_gather_object` once a ring and once a shape).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from dl_ofdm_tpu_torch.ops import cuda_build
from dl_ofdm_tpu_torch.ops.pallas_kernels import fir_shift_accum
from dl_ofdm_tpu_torch.parallel import distributed as pd
from dl_ofdm_tpu_torch.parallel.mesh import Mesh

RING_MAX_RANKS = 16          # csrc/ring_exchange.cu: RING_MAX_RANKS
RING_WORDS = 3               # a side's words on its card: epoch, credit, data
IPC_HANDLE_BYTES = 64        # CUDA_IPC_HANDLE_SIZE


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
    lib.ring_ipc_alloc.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.c_char_p]
    lib.ring_ipc_open.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_void_p)]
    lib.ring_ipc_close.argtypes = [ctypes.c_void_p]
    lib.ring_ipc_free.argtypes = [ctypes.c_int, ctypes.c_void_p]
    for f in ("ring_ipc_alloc", "ring_ipc_open", "ring_ipc_close",
              "ring_ipc_free"):
        getattr(lib, f).restype = ctypes.c_int
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


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _tensor_at(ptr: int, shape: tuple) -> torch.Tensor:
    """A float32 tensor of `shape` over card memory at `ptr` that PyTorch
    did not allocate (`__cuda_array_interface__`; it does not own it)."""
    class _View:
        __cuda_array_interface__ = {"shape": tuple(shape), "typestr": "<f4",
                                    "data": (int(ptr), False), "version": 2,
                                    "strides": None}
    return torch.as_tensor(_View())


class _IpcRing:
    """The ring over a mesh whose ranks span processes: its plan over
    "cards" that are (process, device) pairs (two processes on one card
    are two cards of the plan: two contexts), and its handshake words,
    RING_WORDS a side, in one allocation of the kernel library a card,
    made and zeroed by the card's process and mapped by its partners
    (CUDA IPC).  The words are never reset: the epochs only grow.  Made
    collectively: every process of the mesh makes it at once."""

    def __init__(self, keys: tuple, me: int):
        self.plan = plan = ring_plan(keys)
        self.me = me
        self.local = [c for c, card in enumerate(plan.cards)
                      if card.device[0] == me]
        # the cards the local sides reach (sources' credits, destinations'
        # data words and receive buffers), each from the local card of the
        # first side that reaches it
        self.reach: dict[int, torch.device] = {}
        for c in self.local:
            card = plan.cards[c]
            for sd in card.sides:
                for r in (sd.src_rank, sd.dst_rank):
                    self.reach.setdefault(plan.card_of[r],
                                          torch.device(card.device[1]))
        self.allocs: list[tuple[int, int]] = []
        self.opened: list[int] = []
        self.words = [2 * RING_WORDS * len(card.ranks) for card in plan.cards]
        self.word_base = self.shared([4 * n for n in self.words])

    def shared(self, nbytes: list[int]) -> list[int]:
        """One zeroed allocation of `nbytes[c]` bytes on each card c, made
        by its process and mapped by the processes that reach it: each
        card's base address in this process (0 where unreached)."""
        lib = _ring_lib()
        mine = {}
        for c in self.local:
            dev = torch.device(self.plan.cards[c].device[1])
            ptr = ctypes.c_void_p()
            handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
            _check(lib.ring_ipc_alloc(dev.index, max(nbytes[c], 16),
                                      ctypes.byref(ptr), handle),
                   f"ring_ipc_alloc on {dev}")
            self.allocs.append((dev.index, ptr.value))
            mine[c] = (handle.raw, ptr.value)
        handles = {}
        for part in pd.all_gather_object({c: h for c, (h, _) in
                                          mine.items()}):
            handles.update(part)
        bases = []
        for c in range(len(self.plan.cards)):
            if c in mine:
                bases.append(mine[c][1])
            elif c in self.reach:
                ptr = ctypes.c_void_p()
                dev = self.reach[c]
                _check(lib.ring_ipc_open(dev.index, handles[c],
                                         ctypes.byref(ptr)),
                       f"mapping card {self.plan.cards[c].device} into "
                       f"process {self.me} from {dev} (the 'dma' ring "
                       "across processes needs them on one host, with "
                       "peer access between their cards)")
                self.opened.append(ptr.value)
                bases.append(ptr.value)
            else:
                bases.append(0)
        return bases

    def release(self) -> None:
        """Unmap the partners' memory, wait for every process, free this
        process's (collective)."""
        lib = _ring_lib()
        for ptr in self.opened:
            _check(lib.ring_ipc_close(ptr), "ring_ipc_close")
        self.opened.clear()
        pd.barrier(torch.device(self.plan.cards[self.local[0]].device[1]))
        for index, ptr in self.allocs:
            _check(lib.ring_ipc_free(index, ptr), "ring_ipc_free")
        self.allocs.clear()


class _IpcLaunch:
    """A cross-process ring's launch plan of one shape: `_RingLaunch`'s
    arguments for every card (only the local ones launch) and the
    receive buffers, one shared allocation a card (its ranks' recv_l,
    then their recv_r), persistent: the local ranks' views of them are
    what an exchange returns."""

    def __init__(self, ring: _IpcRing, local: list[int], shape_l, shape_r,
                 strides_l, strides_r):
        p = len(ring.plan.card_of)
        st_l, st_r = [0] * p, [0] * p
        for r, a, b in zip(local, strides_l, strides_r):
            st_l[r], st_r[r] = a, b
        self.launch = launch = _RingLaunch(ring, shape_l, shape_r, st_l, st_r)
        self.me = ring.me
        bases = np.array(ring.shared([4 * (n_l + n_r) for _, n_l, n_r, _ in
                                      launch.cards]), np.uint64)
        self.recv = bases[launch.recv_card] + launch.recv_off
        self.recv_l = [_tensor_at(self.recv[r], shape_l) for r in local]
        self.recv_r = [_tensor_at(self.recv[p + r], shape_r) for r in local]
        self.slices = np.zeros(2 * p, np.uint64)


_IPC_RINGS: dict[tuple, _IpcRing] = {}
_IPC_LAUNCHES: dict[tuple, _IpcLaunch] = {}


def _mesh_keys(mesh: Mesh) -> tuple:
    """Each rank's (process, device name): the ring's cards."""
    return tuple((int(p), str(d)) for p, d in zip(mesh.process.flat,
                                                 mesh.devices.flat))


def ring_exchange_across(left_tails: list, right_heads: list, mesh: Mesh):
    """The ring kernel over a mesh whose ranks span processes: this
    process's ranks' slices (`mesh.local_ranks` in order; float32 on its
    CUDA devices, left tails [B, hl, 2] and right heads [B, hr, 2] with
    contiguous rows, alike on every rank) -> (recv_l, recv_r) of its
    ranks, as `ring_exchange_ref` over the whole ring.

    Collective: every process calls it at once, with the same shapes.
    Each process launches the handshake template for its own cards only,
    on each card's current stream; its receive buffers and words live in
    memory the kernel library allocated and its partners mapped (CUDA
    IPC, handles exchanged once a ring and once a shape).  The results
    are views of those buffers, valid until the next exchange of the
    same shape (which the handshake holds back until this process's
    stream has read them): clone to keep them."""
    local = mesh.local_ranks
    if len(left_tails) != len(local) or len(right_heads) != len(local):
        raise ValueError(f"ring_exchange_across: {len(local)} local ranks, "
                         f"got {len(left_tails)} left tails and "
                         f"{len(right_heads)} right heads")
    ts = list(left_tails) + list(right_heads)
    devs = [mesh.rank_devices[r] for r in local]
    if any(t.device != d for t, d in zip(ts, devs * 2)) or any(
            d.type != "cuda" for d in devs):
        raise ValueError("ring_exchange_across: each rank's slices on its "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ring_exchange_kernel takes float32 tensors")
    shape_l, shape_r = tuple(left_tails[0].shape), tuple(right_heads[0].shape)
    if any(tuple(t.shape) != shape_l for t in left_tails) or any(
            tuple(t.shape) != shape_r for t in right_heads) or \
            shape_l[0] != shape_r[0]:
        raise ValueError("ring_exchange_across: every left tail and right "
                         "head alike")
    strides_l = [_side_strides(t) for t in left_tails]
    strides_r = [_side_strides(t) for t in right_heads]
    keys = _mesh_keys(mesh)
    ring = _IPC_RINGS.get(keys)
    if ring is None:
        ring = _IPC_RINGS[keys] = _IpcRing(keys, mesh.process_index)
    key = (keys, shape_l, shape_r, tuple(strides_l), tuple(strides_r))
    ipc = _IPC_LAUNCHES.get(key)
    if ipc is None:
        ipc = _IPC_LAUNCHES[key] = _IpcLaunch(ring, local, shape_l, shape_r,
                                              strides_l, strides_r)
    p = len(ring.plan.card_of)
    for i, r in enumerate(local):
        ipc.slices[r] = left_tails[i].data_ptr()
        ipc.slices[p + r] = right_heads[i].data_ptr()
    ipc.launch.write(np.concatenate((ipc.slices, ipc.recv)))
    lib = _ring_lib()
    for c in ipc.launch.launches:
        if c.device[0] != ipc.me:
            continue
        index = torch.device(c.device[1]).index
        err = lib.ring_exchange_f32(c.ref, 1, index,
                                    torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"ring_exchange kernel launch on "
                               f"{c.device} failed: CUDA error {err}")
        ring_exchange_kernel.launches += 1
        ring_exchange_across.launches += 1
    return list(ipc.recv_l), list(ipc.recv_r)


ring_exchange_across.launches = 0


def release_rings() -> None:
    """Free the cross-process rings' shared memory (collective: every
    process of their meshes calls it; later exchanges make them anew)."""
    for ring in _IPC_RINGS.values():
        ring.release()
    _IPC_RINGS.clear()
    _IPC_LAUNCHES.clear()


def _ppermute_across(slices: list, shift: int, mesh: Mesh) -> list:
    """recv[i] = the slice of global rank (local_ranks[i] - shift) mod P,
    on local rank i's device: a copy where that rank is this process's,
    else received by `batch_isend_irecv` (NCCL for card tensors, gloo
    for CPU ones).  Collective."""
    p, proc = mesh.devices.size, mesh.process.reshape(-1)
    local = mesh.local_ranks
    pos = {r: i for i, r in enumerate(local)}
    devs = [mesh.rank_devices[r] for r in local]
    if any(t.is_cuda for t in slices) and dist.get_backend() != "nccl":
        raise ValueError(
            f"the 'ppermute' exchange across processes takes card tensors "
            f"over NCCL only (this group is {dist.get_backend()}; nothing "
            "is staged through the host): use exchange='dma'")
    out, ops = [None] * len(local), []
    for i, r in enumerate(local):
        src = (r - shift) % p
        if src in pos:
            out[i] = slices[pos[src]].to(devs[i])
        else:
            out[i] = torch.empty(slices[i].shape, dtype=slices[i].dtype,
                                 device=devs[i])
            ops.append(dist.P2POp(dist.irecv, out[i], int(proc[src]),
                                  tag=r))
    for i, r in enumerate(local):
        dst = (r + shift) % p
        if dst not in pos:
            ops.append(dist.P2POp(dist.isend, slices[i].contiguous(),
                                  int(proc[dst]), tag=dst))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def ring_exchange(left_tails: list, right_heads: list, mesh: Mesh | None = None):
    """Each rank's `left_tail` to its right neighbour and `right_head` to
    its left one: (recv_l, recv_r) with recv_l[r] = left_tails[(r-1) mod P]
    and recv_r[r] = right_heads[(r+1) mod P], unmasked, any P >= 1.  The
    kernel where the ranks lie on CUDA devices, the plain version where
    they lie on the CPU; a mix raises.  On a `mesh` over processes, this
    process's ranks' slices: the kernel across processes
    (`ring_exchange_across`) on cards, the plain version's messages
    between the processes on the CPU."""
    kinds = {t.device.type for t in list(left_tails) + list(right_heads)}
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"ring_exchange: ranks on {sorted(kinds)}; all on "
                         "CUDA devices or all on the CPU")
    if mesh is not None and mesh.multiprocess:
        if kinds == {"cuda"}:
            return ring_exchange_across(left_tails, right_heads, mesh)
        return (_ppermute_across(left_tails, 1, mesh),
                _ppermute_across(right_heads, -1, mesh))
    if kinds == {"cpu"}:
        return ring_exchange_ref(left_tails, right_heads)
    return ring_exchange_kernel(left_tails, right_heads)


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
        [B, P * L_local, 2] cut into consecutive pieces.  On a `Mesh` over
        processes, this process's ranks' shards (`mesh.local_ranks`), and
        every process calls at once.
      h: [B, F, 2] FIR kernels, the same for every rank (moved to each).
      offset: static alignment in [0, F-1]: (F-1)//2 for np.convolve
        'same', 0 for causal filtering.
      mesh_or_devices: a `Mesh` (its devices in order) or the P devices.
      exchange: 'ppermute' (copies between the ranks' devices) or 'dma'
        (`ring_exchange`: the ring kernel on CUDA ranks).

    Returns the P output shards [B, L_local, 2] (this process's, across
    processes): out[n] = sum_k h[k] x[n + offset - k] over the whole
    block, zero outside it.
    """
    mesh = mesh_or_devices if isinstance(mesh_or_devices, Mesh) else None
    multi = mesh is not None and mesh.multiprocess
    devs = _ranks(mesh_or_devices)
    p = len(devs)
    ranks = mesh.local_ranks if multi else list(range(p))
    devs = [devs[r] for r in ranks]
    if len(shards) != len(devs):
        raise ValueError(f"{len(shards)} shards for {len(devs)} ranks")
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
                                           [x[:, :hr, :] for x in shards],
                                           mesh)
        else:
            recv_l = recv_r = None
    elif exchange == "ppermute":
        permute = (functools.partial(_ppermute_across, mesh=mesh) if multi
                   else lambda sl, shift: _ppermute(sl, shift, devs))
        recv_l = (permute([x[:, -halo_l:, :] for x in shards], 1)
                  if halo_l else None)
        recv_r = (permute([x[:, :halo_r, :] for x in shards], -1)
                  if halo_r else None)
    else:
        raise ValueError(exchange)
    out = []
    for i, (x, dev) in enumerate(zip(shards, devs)):
        r = ranks[i]
        parts = []
        if halo_l:
            parts.append(torch.zeros_like(recv_l[i]) if r == 0
                         else recv_l[i])
        parts.append(x)
        if halo_r:
            parts.append(torch.zeros_like(recv_r[i]) if r == p - 1
                         else recv_r[i])
        ext = torch.cat(parts, dim=1)       # [B, halo_l + L_local + halo_r, 2]
        hd = h.to(dev)
        # ext[m] = x_global[start - halo_l + m], so out[n] = sum_k h[k]
        # ext[n + F - 1 - k]: fir_shift_accum's pre-aligned rows
        yr, yi = fir_shift_accum(ext[..., 0], ext[..., 1], hd[..., 0],
                                 hd[..., 1], l_local)
        out.append(torch.stack([yr, yi], dim=-1))
    return out
