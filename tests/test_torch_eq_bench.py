"""The benchmark's equalizer configuration and ETU sweep on the CPU.

  * The port's equalized receiver (registry id 12) against the plain
    reference `benchmark/reference/equalizer.py` on seeded random weights:
    forward outputs, the loss and every `Equalizer.*` gradient, at a small
    nfft and at nfft 64.  Both run in float64 here, so the two differ only
    by the order of their sums (the reference takes each complex product as
    one product of stacked real planes and the complex convolution as one
    two-channel convolution; the port as four real ones): every tolerance is
    1e-9 relative, some six orders above float64's rounding over these
    depths and some six below any mistake in the equations.
  * The equalizer step keeps the frozen receiver bit for bit and counts its
    steps and frames (`EqualizerTrainer.curriculum_steps`, `.frames`).
  * The block convolution runs with cuDNN's TF32 off in the forward and in
    both gradients, and hands the caller's setting back.
  * The model FLOPs of `eq_train_mfu_pct` against a count by hand.
  * A whole small run of each new cell (set-up, window, check; the look for
    a card skipped) reads correct for the program and not correct for the
    fp8 control and for each fault planted under the timed path.
  * The eq cell's weights are the benchmark's: its own draw of the
    equalizer (each leaf at its fan-in) and the arm read by each side's own
    loader, so a fault in the port's loader reads not correct and the
    port's initializer is not called.
"""
import copy
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness, work, work_eq  # noqa: E402
from benchmark.drivers import train_eq  # noqa: E402
from benchmark.reference import equalizer as eqref  # noqa: E402
from benchmark.run import run_cell  # noqa: E402
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig  # noqa: E402
from dl_ofdm_tpu_torch.models.equalizers import EQUALIZER_REGISTRY  # noqa: E402
from dl_ofdm_tpu_torch.models.receiver import EqualizedReceiver  # noqa: E402
from dl_ofdm_tpu_torch.ops import complex_ops  # noqa: E402
from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer  # noqa: E402

CPU = torch.device("cpu")
RTOL = 1e-9
SEED = 2 ** 33 + 22


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)


def _trainer(frames=4, **kw):
    return EqualizerTrainer(OFDMConfig(nbits=1), TrainConfig(
        batch_size=7 * frames, msg_length=7 * frames, opt=12,
        curriculum_tail=True), channel="mixRayleigh", mobile=True,
        device="cpu", **kw)


# (nfft, cp, pilots a frame, pilot comb, frame_size) of the two sizes
SMALL = (16, 4, 4, (2, 6, 9, 13), 24)


def _model(size):
    """(model, pilot comb, frame_size) in float64 with every parameter,
    biases too, drawn from a seeded generator."""
    if size == "nfft64":
        plan = _trainer().plan
        nfft, cp, pilots = 64, plan.cp_len, plan.pilot_size
        comb, frame = tuple(plan.pilot_carriers), plan.frame_size
    else:
        nfft, cp, pilots, comb, frame = SMALL
    model = EqualizedReceiver(
        nbits=1, nfft=nfft, cp_len=cp, nfilter=nfft, frame_size=frame,
        nsymbol=7, pilot_size=pilots, pilot_carriers=comb,
        eq_spec=EQUALIZER_REGISTRY[12]).double()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for v in model.parameters():
            v.add_(0.1 * torch.randn(v.shape, generator=g,
                                     dtype=torch.float64))
    return model, [int(c) for c in comb], frame


def _inputs(model, frame, b=3):
    g = torch.Generator().manual_seed(11)
    eq = model.Equalizer
    x = torch.randn(b, 7, eq.nfft + eq.cp_len, 2, generator=g,
                    dtype=torch.float64)
    bits = torch.randint(0, 2, (b, frame, 1), generator=g,
                         dtype=torch.int32)
    return x, bits


def _close(a, b):
    err = float((a - b).norm() / b.norm())
    assert err < RTOL, err


@pytest.mark.parametrize("size", ["small", "nfft64"])
def test_forward_matches_the_reference(size):
    model, comb, frame = _model(size)
    x, _ = _inputs(model, frame)
    p = dict(model.state_dict())
    with torch.no_grad():
        logits, _, eq, snr, chest = model(x)
        r_logits, r_eq, r_snr, r_chest = eqref.forward(p, x, comb, 1)
    for a, b in ((eq, r_eq), (chest, r_chest), (snr, r_snr),
                 (logits, r_logits)):
        assert a.shape == b.shape
        _close(a, b)


@pytest.mark.parametrize("size", ["small", "nfft64"])
def test_loss_and_equalizer_gradients_match_the_reference(size):
    model, comb, frame = _model(size)
    x, bits = _inputs(model, frame)
    tt = _trainer()
    tt.model = model
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    keys = [k for k in params if k.startswith("Equalizer.")]
    for k in keys:
        params[k].requires_grad_()
    loss, _ = tt._loss_fn(params, bits, x)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    ref = dict(params)
    for k in keys:
        ref[k] = params[k].detach().clone().requires_grad_()
    r_loss = eqref.loss(ref, x, bits.reshape(bits.shape[0], -1), comb, 1)
    r_grads = torch.autograd.grad(r_loss, [ref[k] for k in keys])
    _close(loss.detach(), r_loss.detach())
    assert len(keys) == 28
    for k, a, b in zip(keys, grads, r_grads):
        _close(a, b)


def test_step_keeps_the_frozen_receiver_and_counts_itself():
    tt = _trainer()
    rx = {k: v.clone() for k, v in tt.model.receiver.state_dict().items()}
    tt.pretrained_rx = rx
    g = torch.Generator().manual_seed(3)
    state = tt.init_state(g)
    steps, frames = (EqualizerTrainer.curriculum_steps,
                     EqualizerTrainer.curriculum_frames)
    for _ in range(3):
        new, _ = tt.train_step_curriculum(state, g)
        assert any(not torch.equal(new.params[k], state.params[k])
                   for k in tt._trainable)
        state = new
    for k, v in rx.items():
        assert torch.equal(state.params[f"receiver.{k}"], v), k
    assert EqualizerTrainer.curriculum_steps - steps == 3
    assert EqualizerTrainer.curriculum_frames - frames == 3 * tt.batch_frames


def test_block_conv_turns_tf32_off_in_forward_and_backward(monkeypatch):
    seen = []
    fwd, bwd = torch.nn.functional.conv2d, torch.ops.aten.convolution_backward

    def conv_spy(*a, **k):
        seen.append(("forward", torch.backends.cudnn.allow_tf32))
        return fwd(*a, **k)

    def bwd_spy(*a, **k):
        seen.append(("backward", torch.backends.cudnn.allow_tf32))
        return bwd(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "conv2d", conv_spy)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", bwd_spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    conv = complex_ops.ComplexConv2d(1, 1, (7, 16), padding="same")
    x = torch.randn(2, 7, 16, 1, 2, requires_grad=True)
    y = conv(x)
    torch.autograd.grad(y.sum(), [x, conv.wr, conv.wi])
    # four real convolutions, each with its backward
    assert seen == [("forward", False)] * 4 + [("backward", False)] * 4
    assert torch.backends.cudnn.allow_tf32 is True


def test_block_conv_equals_autograd_of_f_conv2d():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 1, 13, 79, generator=g, requires_grad=True)
    w = torch.randn(1, 1, 7, 16, generator=g, requires_grad=True)
    dy = torch.randn(3, 1, 7, 64, generator=g)
    ours = complex_ops.conv2d_float32(x, w)
    plain = torch.nn.functional.conv2d(x, w)
    assert torch.equal(ours, plain)
    for a, b in zip(torch.autograd.grad(ours, [x, w], dy),
                    torch.autograd.grad(plain, [x, w], dy)):
        assert torch.equal(a, b)


def test_eq12_forward_flops_by_hand():
    # per frame, 7 symbols of 64 subcarriers, CP 16, 16 pilots:
    by_hand = (7 * 2 * 160 * 128          # Dense_in per symbol
               + 7 * 8 * 64 * 64          # ToFreq
               + 2 * 896 * 32             # Dense_pilot
               + 2 * 32 * 896             # Dense_interp0
               + 2 * 896 * 896            # Dense_interp1
               + 2 * 896 * 896            # Dense_block0
               # BlockConv0: 37 of 49 symbol taps and 3,072 of 4,096
               # subcarrier taps fall inside the 'same' window
               + 8 * 37 * 3072
               + 2 * 7 * 8 * 64 * 64      # CorrT, ToTime
               + 7 * 2 * 256 * 160)       # Dense_out per symbol
    assert by_hand == 5_783_552
    assert work_eq.eq12_forward_flops(7, 64, 16, 16) == by_hand
    assert work_eq.same_taps(7, 7) == 4 + 5 + 6 + 7 + 6 + 5 + 4
    assert work_eq.same_taps(3, 2) == 2 + 2 + 1
    # the frozen receiver beside it, as `eq_train_mfu_pct` adds them
    assert work.dccn_forward_flops(7, 80, 64, 320, 1) == 1_441_280


# -- whole runs of the new cells on the CPU ---------------------------------

def small_eq(frames=16):
    c = harness.cell("eq12.train_mix_9k")
    c.traffic = dict(c.traffic, frames_per_step=frames, eval_frames=frames)
    c.config = copy.deepcopy(c.config)
    c.config["train"]["msg_length"] = frames * 7 * 2
    return c


def small_sweep():
    c = harness.cell("bpsk64.sweep_etu")
    c.traffic = dict(c.traffic, frames_per_point=4, check_calls=2)
    return c


def _run(cell, mode="program", fault=None):
    result, checks = run_cell(cell, SEED, 0.2, False, CPU, mode=mode,
                              fault=fault)
    return all(c.ok for c in checks), {c.name: c.value for c in checks}


@pytest.mark.parametrize("make", [small_eq, small_sweep],
                         ids=["eq12", "sweep_etu"])
def test_cell_is_correct(make):
    ok, readings = _run(make())
    assert ok, readings


@pytest.mark.parametrize("make", [small_eq, small_sweep],
                         ids=["eq12", "sweep_etu"])
def test_cell_control_fails(make):
    ok, readings = _run(make(), "control")
    assert not ok, readings


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_eq_fault_fails(fault):
    ok, readings = _run(small_eq(), fault=fault)
    assert not ok, readings
    if fault == "unchanged":
        assert readings["change_gap"] == 1.0


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_sweep_etu_fault_fails(fault):
    ok, readings = _run(small_sweep(), fault=fault)
    assert not ok, readings


def test_eq_frozen_receiver_moved_fails(monkeypatch):
    """A step that moves one leaf of the receiver by a rounding reads
    frozen_moved."""
    apply = EqualizerTrainer._apply

    def moving(self, state, grads):
        new = apply(self, state, grads)
        k = "receiver.Dense_llr.bias"
        new.params[k] = new.params[k] + 1e-6
        return new

    monkeypatch.setattr(EqualizerTrainer, "_apply", moving)
    ok, readings = _run(small_eq())
    assert not ok and readings["frozen_moved"] == 1, readings


def test_eq_cell_refuses_a_port_without_the_step_counter(monkeypatch):
    monkeypatch.delattr(EqualizerTrainer, "curriculum_steps")
    with pytest.raises(SystemExit, match="curriculum_steps"):
        _run(small_eq())


def test_eq_unknown_fault_is_refused():
    with pytest.raises(ValueError, match="tf32_conv"):
        with train_eq.planted("no_such_fault"):
            pass


def test_eq_loader_fault_fails(monkeypatch):
    """The program reads the frozen arm with the port's loader, the
    reference with the benchmark's own: a leaf the loader gets wrong (one
    bias off by a rounding) is not shared by the two sides."""
    from dl_ofdm_tpu_torch.train import checkpoint as ckpt
    load = ckpt.params_from_flax

    def off(tree):
        out = load(tree)
        out["Dense_llr.bias"] = out["Dense_llr.bias"] + 1e-6
        return out

    monkeypatch.setattr(ckpt, "params_from_flax", off)
    ok, readings = _run(small_eq())
    assert not ok and readings["frozen_moved"] == 1, readings


def test_eq_cell_does_not_use_the_ports_initializer(monkeypatch):
    """The equalizer's weights come from the benchmark's draw, so a fault
    in the port's initializer or graft cannot reach both sides."""
    def refused(self, generator=None):
        raise AssertionError("init_state called")

    monkeypatch.setattr(EqualizerTrainer, "init_state", refused)
    ok, readings = _run(small_eq())
    assert ok, readings


def test_draw_equalizer_scales_each_leaf_by_its_fan_in():
    """Biases zero; each weight within 2 std of flax's lecun_normal (a
    normal truncated at 2 std and scaled by 1/0.8796, the truncated unit
    normal's std) and its variance times its fan-in 1, within four
    standard errors of a sample variance, sqrt(2 / n) of it."""
    shapes = {k: tuple(v.shape)
              for k, v in _trainer().model.state_dict().items()
              if k.startswith("Equalizer.")}
    w = train_eq.draw_equalizer(shapes, SEED, CPU)
    assert list(w) == list(shapes)
    fans = {"Equalizer.Dense_in.weight": 160,
            "Equalizer.ToFreq.wr": 64, "Equalizer.BlockConv0.wr": 7 * 64}
    for k, v in w.items():
        assert tuple(v.shape) == shapes[k]
        if k.endswith(("bias", "br", "bi")):
            assert not v.any(), k
            continue
        fan = v.shape[1] if k.endswith("weight") else v.numel() // v.shape[-1]
        assert fans.get(k, fan) == fan, k
        std = (1 / fan) ** 0.5 / 0.87962566
        assert float(v.abs().max()) <= 2 * std * (1 + 1e-6), k
        ratio = float(v.double().var() * fan)
        assert abs(ratio - 1) < 4 * (2 / v.numel()) ** 0.5, (k, ratio)
