"""The ring exchange's launch plan and the C structs behind the port's
ctypes bindings, on the CPU (no card): `parallel/halo.py::ring_plan` built
from `torch.device("cuda", i)` objects (the template, the handshake words
that partners signal and wait on, every side covered once), the pointer
slots of a launch's `_RingArgs`, and `_RingSide`, `_RingArgs` and
`_ProbeArgs` against their structs in `csrc/`, field for field."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from dl_ofdm_tpu_torch.ops import cuda_build
from dl_ofdm_tpu_torch.ops import prng_probe as pp
from dl_ofdm_tpu_torch.parallel import halo


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


LAYOUTS = {"one card, 4 ranks": _cuda(0, 0, 0, 0),
           "one card, 1 rank": _cuda(0),
           "four cards": _cuda(0, 1, 2, 3),
           "two cards": _cuda(0, 1),
           "two cards, 2 ranks each": _cuda(0, 0, 1, 1),
           "interleaved": _cuda(0, 1, 0, 1, 2, 2),
           "four cards, 16 ranks": _cuda(*(i // 4 for i in range(16)))}


def _sides(plan):
    return [s for c in plan.cards for s in c.sides]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_ring_plan_template_and_cards(name):
    devs = LAYOUTS[name]
    plan = halo.ring_plan(devs)
    n_cards = len(set(devs))
    assert plan.template == ("copy" if n_cards == 1 else "handshake")
    assert [c.device for c in plan.cards] == list(dict.fromkeys(devs))
    for c, card in enumerate(plan.cards):
        assert card.ranks == tuple(r for r, d in enumerate(devs)
                                   if d == card.device)
        # block 2j: the tail of ranks[j], block 2j + 1 its head
        assert [(s.rank, s.direction) for s in card.sides] == [
            (r, k) for r in card.ranks for k in (0, 1)]
        for r in card.ranks:
            assert plan.card_of[r] == c
            assert card.ranks[plan.slot_of[r]] == r


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_ring_plan_covers_every_side_once(name):
    devs = LAYOUTS[name]
    p = len(devs)
    sides = _sides(halo.ring_plan(devs))
    assert sorted((s.rank, s.direction) for s in sides) == [
        (r, k) for r in range(p) for k in (0, 1)]
    for s in sides:
        # the tail goes right into recv_l, the head left into recv_r
        shift = 1 if s.direction == 0 else -1
        assert s.dst_rank == (s.rank + shift) % p
        assert s.src_rank == (s.rank - shift) % p
    # every receive buffer is filled by exactly one side
    assert sorted((s.dst_rank, s.direction) for s in sides) == [
        (r, k) for r in range(p) for k in (0, 1)]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_ring_plan_words_pair_each_side_with_its_partners(name):
    """Each side's data and credit words are the ones its partners wait on
    and signal: its data_out is its destination's data_in, its credit_out
    its source's credit_in; its own words lie on its card; each word is
    used by exactly one side."""
    plan = halo.ring_plan(LAYOUTS[name])
    sides = _sides(plan)
    by_key = {(s.rank, s.direction): s for s in sides}
    for s in sides:
        dst = by_key[(s.dst_rank, s.direction)]
        src = by_key[(s.src_rank, s.direction)]
        assert s.data_out == dst.data_in
        assert s.credit_out == src.credit_in
        # what s waits on is what its partners signal
        assert src.data_out == s.data_in
        assert dst.credit_out == s.credit_in
        card = plan.card_of[s.rank]
        assert {s.epoch[0], s.credit_in[0], s.data_in[0]} == {card}
    own = [w for s in sides for w in (s.epoch, s.credit_in, s.data_in)]
    assert len(own) == len(set(own)) == halo.RING_WORDS * len(sides)
    for c, card in enumerate(plan.cards):
        assert sorted(w for k, w in own if k == c) == list(
            range(halo.RING_WORDS * len(card.sides)))
    # each signalled word has one signaller, and it is a waited-on word
    for field, target in (("data_out", "data_in"),
                          ("credit_out", "credit_in")):
        out = [getattr(s, field) for s in sides]
        assert sorted(out) == sorted(getattr(s, target) for s in sides)


def test_ring_plan_refuses_17_ranks():
    with pytest.raises(ValueError, match="1..16 ranks"):
        halo.ring_plan(_cuda(*range(17)))
    with pytest.raises(ValueError, match="1..16 ranks"):
        halo.ring_plan([])
    x = torch.zeros(2, 3, 2)
    with pytest.raises(ValueError, match="1..16 ranks"):
        halo.ring_exchange_kernel([x] * 17, [x] * 17)


def _fake_ring(plan, base=0x10000):
    """A `_Ring` whose words sit at made-up addresses (no card)."""
    ring = halo._Ring.__new__(halo._Ring)
    ring.plan = plan
    ring.word_base = [base * (c + 1) for c in range(len(plan.cards))]
    ring.words = ring.word_base if plan.template == "handshake" else []
    return ring


@pytest.mark.parametrize("name", ["one card, 4 ranks", "four cards",
                                  "two cards, 2 ranks each"])
def test_ring_launch_writes_each_pointer_where_its_side_reads_it(name):
    """The `_RingArgs` of each card: the side's slice, its stride, its
    destination's receive buffer and its words' addresses (handshake
    only), after the call's pointers go through the numpy view."""
    devs = LAYOUTS[name]
    p = len(devs)
    plan = halo.ring_plan(devs)
    ring = _fake_ring(plan)
    strides_l = [1000 + r for r in range(p)]
    strides_r = [2000 + r for r in range(p)]
    launch = halo._RingLaunch(ring, (64, 6, 2), (64, 1, 2), strides_l,
                              strides_r)
    # pointer k of the call: slices lt[0..P), rh[0..P), recv_l, recv_r
    ptrs = np.arange(4 * p, dtype=np.uint64) * 64 + (1 << 40)
    launch.write(ptrs)
    assert len(launch.launches) == len(plan.cards)
    assert launch.handshake == (plan.template == "handshake")
    for c, card in zip(launch.launches, plan.cards):
        args = c.args
        assert c.device == card.device
        assert args.blocks == 2 * len(card.ranks) and args.rows == 64
        assert list(args.cols) == [12, 2]
        for i, s in enumerate(card.sides):
            side = args.side[i]
            k = s.direction
            assert side.src == int(ptrs[k * p + s.rank])
            assert side.src_stride == (strides_l, strides_r)[k][s.rank]
            assert side.dst == int(ptrs[(2 + k) * p + s.dst_rank])
            for field in halo._WORD_FIELDS:
                c, w = getattr(s, field)
                want = (ring.word_base[c] + 4 * w if ring.words else None)
                assert getattr(side, field) == want, field


def test_ring_launch_lays_receive_buffers_out_by_card():
    """One buffer a card: its ranks' recv_l [B, hl, 2], then their recv_r
    [B, hr, 2], each at its slot."""
    devs = LAYOUTS["interleaved"]
    plan = halo.ring_plan(devs)
    launch = halo._RingLaunch(_fake_ring(plan), (3, 5, 2), (3, 2, 2),
                              [0] * 6, [0] * 6)
    n_l, n_r = 3 * 5 * 2, 3 * 2 * 2
    for r, d in enumerate(devs):
        card = plan.card_of[r]
        k = len(plan.cards[card].ranks)
        slot = plan.slot_of[r]
        assert launch.recv_card[r] == launch.recv_card[len(devs) + r] == card
        assert launch.recv_off[r] == 4 * slot * n_l
        assert launch.recv_off[len(devs) + r] == 4 * (k * n_l + slot * n_r)
        assert launch.cards[card][:3] == (d, k * n_l, k * n_r)


@pytest.mark.parametrize("hr", [6, 1])
def test_ring_launch_alloc_puts_each_buffer_at_its_offset(hr):
    """The receive buffers that a call makes (one `torch.empty` a card,
    here the CPU's) lie where the launch's pointers send the pushes."""
    p = 4
    plan = halo.ring_plan([torch.device("cpu")] * p)
    launch = halo._RingLaunch(_fake_ring(plan), (64, 6, 2), (64, hr, 2),
                              [0] * p, [0] * p)
    recv_l, recv_r, bases = launch.alloc()
    assert [tuple(t.shape) for t in recv_l] == [(64, 6, 2)] * p
    assert [tuple(t.shape) for t in recv_r] == [(64, hr, 2)] * p
    assert all(t.is_contiguous() for t in recv_l + recv_r)
    want = bases[launch.recv_card] + launch.recv_off
    assert [t.data_ptr() for t in recv_l + recv_r] == want.tolist()


# -- the C structs behind the ctypes bindings ------------------------------

_C_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
              "unsigned int": ctypes.c_uint, "uint32_t": ctypes.c_uint32}


def _c_struct(source: str, name: str) -> list:
    """[(field, C type, array length or None)] of `struct name { ... };`
    in csrc/`source`, comments stripped; array lengths are evaluated with
    the file's #defines."""
    with open(os.path.join(cuda_build.CSRC_DIR, source)) as f:
        text = f.read()
    defines = dict(re.findall(r"^#define\s+(\w+)\s+(\d+)\s*$", text, re.M))
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(.*?[\s*])(\w+\s*(?:\[[^\]]*\])?"
                     r"(?:\s*,\s*\w+\s*(?:\[[^\]]*\])?)*)$", decl, re.S)
        ctype = " ".join(m.group(1).replace("const", "").split())
        for item in m.group(2).split(","):
            item = item.strip()
            n = None
            am = re.match(r"(\w+)\s*\[(.*)\]$", item)
            if am:
                item = am.group(1)
                n = eval(am.group(2), {}, {k: int(v) for k, v in
                                           defines.items()})
            fields.append((item, ctype, n))
    return fields


def _same_type(ct, ctype: str, structs: dict) -> bool:
    if ctype.endswith("*"):
        return ct is ctypes.c_void_p
    if ctype in structs:
        return ct is structs[ctype]
    return ct is _C_SCALARS[ctype]


@pytest.mark.parametrize("source,name,cls", [
    ("ring_exchange.cu", "RingSide", halo._RingSide),
    ("ring_exchange.cu", "RingArgs", halo._RingArgs),
    ("philox_probe.cu", "ProbeArgs", pp._ProbeArgs)])
def test_ctypes_structs_match_their_c_structs(source, name, cls):
    structs = {"RingSide": halo._RingSide}
    fields = _c_struct(source, name)
    assert [f for f, _, _ in fields] == [f for f, *_ in cls._fields_]
    for (field, ctype, n), (_, ct) in zip(fields, cls._fields_):
        if n is None:
            assert _same_type(ct, ctype, structs), (field, ctype, ct)
        else:
            assert issubclass(ct, ctypes.Array) and ct._length_ == n, field
            assert _same_type(ct._type_, ctype, structs), (field, ctype)
