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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dl_ofdm_tpu_torch.ops import cuda_build
from dl_ofdm_tpu_torch.ops.pallas_kernels import fir_shift_accum
from dl_ofdm_tpu_torch.parallel.mesh import Mesh

RING_MAX_RANKS = 16          # csrc/ring_exchange.cu: RING_MAX_RANKS
RING_THREADS = 256


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
                ("dst", ctypes.c_void_p), ("flag_out", ctypes.c_void_p),
                ("flag_in", ctypes.c_void_p)]


class _RingArgs(ctypes.Structure):
    """`RingArgs` of csrc/ring_exchange.cu, field for field."""
    _fields_ = [("blocks", ctypes.c_int), ("rows", ctypes.c_int),
                ("cols", ctypes.c_int * 2), ("epoch", ctypes.c_uint),
                ("side", _RingSide * (2 * RING_MAX_RANKS))]


@functools.cache
def _ring_lib():
    lib = cuda_build.load("ring_exchange")
    lib.ring_exchange_f32.argtypes = [ctypes.POINTER(_RingArgs),
                                      ctypes.c_int, ctypes.c_void_p]
    lib.ring_exchange_f32.restype = ctypes.c_int
    lib.ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.ring_enable_peer.restype = ctypes.c_int
    lib.ring_empty_launch.argtypes = [ctypes.c_void_p]
    lib.ring_empty_launch.restype = ctypes.c_int
    return lib


class _Ring:
    """What a ring (its tuple of rank devices) keeps between exchanges: its
    cards with their ranks, each rank's two flag words [recv_l, recv_r] on
    its own card (allocated once, never reset) and the epoch of the last
    exchange; each exchange stores and waits for the next epoch.  Peer
    access between neighbouring cards is enabled here; raises where a
    pair cannot reach each other (nothing is staged through the host)."""

    def __init__(self, devs: tuple):
        p = len(devs)
        for r, d in enumerate(devs):
            for nb in {devs[(r - 1) % p], devs[(r + 1) % p]}:
                if nb != d and not enable_peer_access(d.index, nb.index):
                    raise RuntimeError(
                        f"ring_exchange_kernel: {d} cannot reach {nb}'s "
                        "memory (no peer access); the ring does not stage "
                        "through the host")
        self.cards: dict[torch.device, list[int]] = {}
        for r, d in enumerate(devs):
            self.cards.setdefault(d, []).append(r)
        self.flags = {c: torch.zeros(len(rs), 2, dtype=torch.int32, device=c)
                      for c, rs in self.cards.items()}
        self.flag_addr = [0] * len(devs)
        for c, rs in self.cards.items():
            for j, r in enumerate(rs):
                self.flag_addr[r] = self.flags[c].data_ptr() + 8 * j
        self.epoch = 0


_RINGS: dict[tuple, _Ring] = {}


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


def ring_exchange_kernel(left_tails: list, right_heads: list):
    """Launch the ring kernel: every rank's slices on a CUDA device,
    float32, left tails [B, hl, 2] and right heads [B, hr, 2] with
    contiguous rows (row strides are passed; `x[:, -hl:, :]` of a
    contiguous shard qualifies) -> (recv_l, recv_r), as
    `ring_exchange_ref`.  One launch a card, on its current stream; the
    launches are issued back to back with no host sync.  Raises on
    anything else, and where two neighbouring cards cannot reach each
    other (nothing is staged through the host)."""
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
    rows = shape_l[0]
    strides_l = [_side_strides(t) for t in left_tails]
    strides_r = [_side_strides(t) for t in right_heads]
    ring = _RINGS.get(devs)
    if ring is None:
        ring = _RINGS[devs] = _Ring(devs)
    ring.epoch = epoch = (ring.epoch + 1) & 0xFFFFFFFF
    flags = ring.flag_addr
    # one receive buffer a direction and card, a view of it a rank
    recv_l, recv_r = [None] * p, [None] * p
    for c, ranks in ring.cards.items():
        for recv, shape in ((recv_l, shape_l), (recv_r, shape_r)):
            for r, view in zip(ranks, torch.empty(
                    (len(ranks), *shape), device=c).unbind(0)):
                recv[r] = view
    cards = list(ring.cards)
    if len(cards) > 1:
        # a push may not land in a receive buffer that its card's stream
        # has not finished with: every stream waits on all the others'
        # work so far, recorded before any launch
        marks = {c: torch.cuda.current_stream(c).record_event()
                 for c in cards}
        for c in cards:
            for o in cards:
                if o != c:
                    torch.cuda.current_stream(c).wait_event(marks[o])
    lib = _ring_lib()
    for c, ranks in ring.cards.items():
        args = _RingArgs()
        args.rows = rows
        args.cols[0], args.cols[1] = 2 * shape_l[1], 2 * shape_r[1]
        args.epoch = epoch
        args.blocks = 2 * len(ranks)
        for j, r in enumerate(ranks):
            right, left = (r + 1) % p, (r - 1) % p
            # block 2j pushes rank r's tail into its right neighbour's
            # recv_l and waits for its own recv_l; block 2j+1 the heads
            args.side[2 * j] = _RingSide(
                left_tails[r].data_ptr(), strides_l[r],
                recv_l[right].data_ptr(), flags[right], flags[r])
            args.side[2 * j + 1] = _RingSide(
                right_heads[r].data_ptr(), strides_r[r],
                recv_r[left].data_ptr(), flags[left] + 4, flags[r] + 4)
        with torch.cuda.device(c):
            err = lib.ring_exchange_f32(
                ctypes.byref(args), RING_THREADS,
                torch.cuda.current_stream(c).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ring_exchange kernel launch on {c} failed: "
                               f"CUDA error {err}")
        ring_exchange_kernel.launches += 1
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
