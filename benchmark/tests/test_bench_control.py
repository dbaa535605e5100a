"""The comparison that decides `correct` fails where it should, on the CPU
at sizes a test run holds, with each cell's own limits
(`benchmark/limits/`):

  * the control, the reference in fp8 put in the program's place (the
    precision below the configurations' bf16 GEMM inputs), reads not
    correct;
  * a whole run (set-up, window, check; the look for a card skipped) with
    the timed path broken underneath reads not correct, once for each
    fault the cell can have: a training step that returns its state
    unchanged, half of the batch left out with the mean taken over the
    rest, an answer altered where it is produced.

The same comparison on the chip at the cells' own sizes: `calibrate.py`
(PERF.md gives its readings)."""
import copy
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import faults, harness  # noqa: E402
from benchmark.run import run_cell  # noqa: E402

CPU = torch.device("cpu")
TRAIN_CELLS = ("bpsk64.train_1k", "bpsk64.train_37k")
DP_CELL = "big512.train_dp4"
SEED = 2 ** 33 + 19


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)


def small_train(name: str, frames: int = 64):
    c = harness.cell(name)
    c.traffic = dict(c.traffic, frames_per_step=frames, eval_frames=frames)
    c.config = copy.deepcopy(c.config)
    c.config["train"]["msg_length"] = frames * 7 * 2
    return c


def small_dp(frames: int = 4):
    """The data-parallel cell on two gloo processes, two frames a row."""
    c = harness.cell(DP_CELL)
    c.traffic = dict(c.traffic, processes=2, frames_per_step=frames,
                     eval_frames=frames)
    c.config = copy.deepcopy(c.config)
    c.config["train"]["msg_length"] = frames * 7
    return c


def small_sweep(frames_per_point: int = 4):
    c = harness.cell("big512.sweep_awgn")
    c.traffic = dict(c.traffic, frames_per_point=frames_per_point,
                     check_calls=2)
    return c


def correct(cell, mode="program"):
    result, checks = run_cell(cell, SEED, 0.2, False, CPU, mode=mode)
    return all(c.ok for c in checks), {c.name: c.value for c in checks}


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_control_fails(name):
    ok, readings = correct(small_train(name), "control")
    assert not ok, readings


def test_sweep_control_fails():
    ok, readings = correct(small_sweep(), "control")
    assert not ok, readings


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_fails(name, fault):
    with faults.planted(fault):
        ok, readings = correct(small_train(name))
    assert not ok, readings
    if fault == "unchanged":
        assert readings["change_gap"] == 1.0


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_sweep_fault_fails(fault):
    with faults.planted(fault):
        ok, readings = correct(small_sweep())
    assert not ok, readings


def test_dp_control_fails():
    ok, readings = correct(small_dp(), "control")
    assert not ok, readings


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange"])
def test_dp_fault_fails(fault):
    result, checks = run_cell(small_dp(), SEED, 0.2, False, CPU, fault=fault)
    assert not result["correct"], {c.name: c.value for c in checks}


def test_dp_rank_loading_jax_refused(tmp_path, monkeypatch):
    """A module that only a rank other than the run's own process loads
    (here `flax`, put in place at the spawned ranks' start) stops the run
    without a result."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules['flax'] = types.ModuleType('flax')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), *filter(None, [os.environ.get("PYTHONPATH")])]))
    assert "flax" not in sys.modules
    with pytest.raises(SystemExit, match="flax"):
        run_cell(small_dp(), SEED, 0.2, False, CPU)
