"""The dp cell's placement of its ranks: each rank on a slice of its own of
the cores the run may use, the slices together all of them."""
from __future__ import annotations

import multiprocessing as mp
import os

import pytest

from benchmark.drivers.train_dp import pin_cores


def _pinned(rank, world, q):
    mine = pin_cores(rank, world)
    q.put((mine, sorted(os.sched_getaffinity(0))))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ranks_take_disjoint_slices_of_the_cores(world):
    cores = sorted(os.sched_getaffinity(0))
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    got = []
    for rank in range(world):
        p = ctx.Process(target=_pinned, args=(rank, world, q))
        p.start()
        got.append(q.get(timeout=60))
        p.join(timeout=60)
        assert p.exitcode == 0
    slices = [mine for mine, _ in got]
    # each process runs on the slice it returned
    assert all(mine == held for mine, held in got)
    if len(cores) >= world:
        assert sorted(c for s in slices for c in s) == cores
    else:
        assert all(set(s) <= set(cores) and s for s in slices)
    # the caller's own placement is left as it was
    assert sorted(os.sched_getaffinity(0)) == cores
