"""The 16QAM point_batch cell (`qam16.sweep_awgn`, kind `sweep_point`) on
the CPU, at sizes a test run holds:

  * the reference's Gray maps and bit order (`reference/qam.py`) equal the
    port's `const_table_iq` and `indices_from_bits`, for 1 to 4 bits a
    symbol, and its transmitter is `link.transmit` at one bit a symbol;
  * its receiver input equals `Trainer.synthesize` on the same bits and
    unit noise, normalized over the whole call as the cell calls it;
  * TF32 rounding, the control's precision, rounds to nearest even;
  * the check samples one call at each SNR point the window reached;
  * a whole small run (set-up, window, check; the look for a card
    skipped) reads correct, and not correct for the TF32 control and for
    each fault the cell can have (`half_batch`, `bit_order`), and loads
    no JAX.
"""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.drivers import sweep_point  # noqa: E402
from benchmark.reference import link, qam  # noqa: E402
from benchmark.run import run_cell  # noqa: E402
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig  # noqa: E402
from dl_ofdm_tpu_torch.ofdm import constellation  # noqa: E402
from dl_ofdm_tpu_torch.train.loop import Trainer  # noqa: E402

CELL = "qam16.sweep_awgn"
CPU = torch.device("cpu")
SEED = 2 ** 33 + 26


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
def test_gray_map_and_bit_order_are_the_ports(nbits):
    every = constellation.bits_from_indices(torch.arange(2 ** nbits), nbits)
    assert torch.equal(qam.symbol_index(every),
                       constellation.indices_from_bits(every))
    assert torch.equal(qam.symbol_index(every), torch.arange(2 ** nbits))
    ref = torch.view_as_real(qam.symbols(every))
    # the port keeps its table in float32
    assert torch.allclose(ref.float(), constellation.const_table_iq(nbits),
                          rtol=0, atol=1e-6)


def test_one_bit_a_symbol_is_the_bpsk_link():
    bits = torch.randint(0, 2, (3, 320), generator=torch.Generator()
                         .manual_seed(1))
    p = link.plan(64)
    assert torch.equal(qam.transmit(bits[..., None], p),
                       link.transmit(bits, p))


@pytest.mark.parametrize("snr", [-10.0, 12.0, 30.0])
def test_receiver_input_is_synthesize(snr):
    """The port's float32 input against the reference's float64: both
    normalize each position to unit variance, so float32's rounding over
    the power, the moments and the division reads ~1e-6; 1e-4 is two
    orders above it and far below a wrong symbol or scale (O(0.1))."""
    b = 12
    trainer = Trainer(OFDMConfig(nbits=4), TrainConfig(), channel="AWGN",
                      device="cpu")
    g = torch.Generator().manual_seed(7)
    bits = torch.randint(0, 2, (b, 320, 4), dtype=torch.int32, generator=g)
    unit = torch.randn(b, 7, 80, 2, generator=g)
    _, rx, *_ = trainer.synthesize(
        b, torch.full((b,), snr), torch.Generator().manual_seed(8),
        norm_groups=torch.ones(b, 1), bits=bits, unit_noise=unit)
    ref = qam.awgn_call(bits, unit, snr, 64)
    assert torch.allclose(rx.double(), ref, rtol=0, atol=1e-4)


def test_tf32_rounds_to_nearest_even():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + 1.5 * ulp, 1 + 0.51 * ulp,
                      1 + 0.49 * ulp, -(1 + 0.51 * ulp), 3.0])
    want = torch.tensor([1.0, 1 + 2 * ulp, 1 + ulp, 1.0, -(1 + ulp), 3.0])
    out = qam.tf32(x)
    assert torch.equal(out, want)
    assert not (out.view(torch.int32) & 0x1FFF).any()


def test_sample_takes_one_call_at_each_point_reached():
    tr = harness.cell(CELL).traffic
    full = sweep_point.sample_calls(SEED, 10 * 41 + 3, tr)
    assert sorted(sweep_point.point_of(i, tr) for i in full) == list(
        range(41))
    assert full == sweep_point.sample_calls(SEED, 10 * 41 + 3, tr)
    part = sweep_point.sample_calls(SEED, 95, tr)
    assert [sweep_point.point_of(i, tr) for i in part] == list(range(10))


def small():
    c = harness.cell(CELL)
    c.traffic = dict(c.traffic, frames_per_call=16, calls_per_point=1,
                     check_calls=3, snr_db=[-10, 10, 30])
    return c


def _readings(mode="program", fault=None):
    result, checks = run_cell(small(), SEED, 0.3, False, CPU, mode=mode,
                              fault=fault)
    return all(c.ok for c in checks), {c.name: c.value for c in checks}


def test_cell_is_correct():
    ok, readings = _readings()
    assert ok, readings


def test_control_fails():
    ok, readings = _readings("control")
    assert not ok, readings


@pytest.mark.parametrize("fault", sweep_point.FAULTS)
def test_fault_fails(fault):
    ok, readings = _readings(fault=fault)
    assert not ok, readings


def test_altered_does_not_apply():
    with pytest.raises(ValueError, match="altered"):
        _readings(fault="altered")


def test_run_loads_no_jax():
    code = ("import sys, torch; sys.path.insert(0, 'benchmark/tests'); "
            "from test_bench_qam16 import small, SEED; "
            "from benchmark import harness; from benchmark.run import "
            "run_cell; torch.set_num_threads(2); "
            "run_cell(small(), SEED, 0.2, False, torch.device('cpu')); "
            "print('loaded', harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded []"
