"""The reference against the port's plain CPU path at tiny sizes: the frozen
Philox layout, the plan, the transmitter, the training step's frames,
the DCCN's forward, loss and Adam, `Trainer.train_step` on the fused
route's plain versions over three steps, and `eval_batch`."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402
from benchmark.drivers import train as train_driver  # noqa: E402
from benchmark.reference import dccn, link, philox  # noqa: E402
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig  # noqa: E402
from dl_ofdm_tpu_torch.eval import sweep  # noqa: E402
from dl_ofdm_tpu_torch.ofdm.plan import build_plan  # noqa: E402
from dl_ofdm_tpu_torch.ofdm.tx import ofdm_modulate_frames_iq  # noqa: E402
from dl_ofdm_tpu_torch.ops import fused_synth  # noqa: E402
from dl_ofdm_tpu_torch.train.loop import Trainer, TrainState  # noqa: E402

CPU = torch.device("cpu")
TRAIN = {"reg_coeff": 1e-4, "init_learning": 1e-3, "lr_decay_steps": 500,
         "lr_decay_rate": 0.98}


def test_philox_words_are_the_kernels():
    seeds = (123456789, 4000000000)
    rows = torch.arange(5)
    for stream, n in ((0, 320), (3, 560), (1, 9)):
        ours = philox.words(seeds, rows, stream, n)
        port = fused_synth.philox_words(torch.tensor(seeds), rows, stream, n)
        assert torch.equal(ours, port)


@pytest.mark.parametrize("nfft", [64, 512])
def test_plan(nfft):
    p, q = link.plan(nfft), build_plan(OFDMConfig(nfft=nfft, nfilter=nfft))
    assert np.array_equal(p.data_sc, q.data_sc)
    assert np.array_equal(p.pilot_sc, q.pilot_sc) and p.cp == q.cp_len


@pytest.mark.parametrize("nfft", [64, 512])
def test_transmitter(nfft):
    bits = torch.randint(0, 2, (3, link.plan(nfft).frame_size, 1),
                         generator=torch.Generator().manual_seed(1))
    ours = torch.view_as_real(link.transmit(bits[..., 0], link.plan(nfft)))
    port = ofdm_modulate_frames_iq(bits.to(torch.int32), build_plan(
        OFDMConfig(nfft=nfft, nfilter=nfft)))
    torch.testing.assert_close(ours.float(), port, atol=2e-6, rtol=0)


def test_training_frames():
    """The frames the synthesize chain draws from two seed words."""
    tr = Trainer(OFDMConfig(), TrainConfig(batch_size=8 * 7),
                 channel="ETU", device="cpu")
    seeds = (987654321, 123)
    snr = torch.full((8,), 5.0)
    idx, yr, yi, nr, ni, stats = fused_synth.fused_synthesize_ref(
        tr._fused_synth_spec, 8, fused_synth.noise_std(snr),
        seeds=torch.tensor(seeds))
    _, c, _, _ = fused_synth._combine_stats(stats.sum(0), 8)
    port = torch.stack([yr * c[0] + nr * c[1] - c[2],
                        yi * c[3] + ni * c[4] - c[5]], -1)
    bits, rx = link.training_batch(seeds, 8, 64, "ETU", 5.0, CPU)
    assert torch.equal(bits, idx.to(torch.int64) & 1)
    torch.testing.assert_close(rx.float().reshape(8, -1, 2), port,
                               atol=2e-4, rtol=1e-4)


def _weights(tr, seed=7):
    shapes = {k: tuple(v.shape) for k, v in tr.model.state_dict().items()}
    w = harness.draw_weights(shapes, seed, CPU)
    # non-zero biases, so that every leaf's path is compared
    return {k: v + 0.01 if v.dim() == 1 else v for k, v in w.items()}


def test_forward_loss_and_adam():
    tr = Trainer(OFDMConfig(), TrainConfig(batch_size=8 * 7), channel="ETU",
                 device="cpu")
    w = _weights(tr)
    bits, rx = link.training_batch((5, 6), 8, 64, "ETU", 5.0, CPU)
    x = rx.float()
    tr.model.load_state_dict(w)
    torch.testing.assert_close(dccn.forward(w, x, 1),
                               tr.model(x)[0], atol=1e-5, rtol=1e-5)
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    loss, aux = tr._loss_fn(params, bits.reshape(8, -1, 1), x)
    ours, _, _ = dccn.loss_terms(w, x, bits, 1, TRAIN["reg_coeff"])
    torch.testing.assert_close(ours, loss, atol=1e-6, rtol=1e-6)
    g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    state = tr.optimizer.init(w)
    upd, _ = tr.optimizer.update(g, state)
    mine = dccn.adam_step(w, g, {"count": 0, "mu": {k: 0 * v for k, v in
                                                    w.items()},
                                 "nu": {k: 0 * v for k, v in w.items()}},
                          TRAIN)
    for k in w:
        torch.testing.assert_close(mine[k], w[k] + upd[k], atol=1e-7,
                                   rtol=1e-6)


def test_train_step_three_steps():
    """`Trainer.train_step` on the fused route's plain versions (float32
    GEMM inputs) against the reference's three steps on the same words."""
    frames = 16
    tr = Trainer(OFDMConfig(), TrainConfig(
        batch_size=frames * 7, fused_model_matmul_dtype="float32"),
        channel="ETU", device="cpu")
    w = _weights(tr)
    gen = torch.Generator().manual_seed(11)
    state = TrainState(dict(w), tr.optimizer.init(w), 0)
    seeds, losses = [], []
    snr = torch.full((frames,), 5.0)
    for i in range(3):
        seeds.append(train_driver._seed_words(torch, gen, CPU, False))
        state, aux = tr.train_step(state, gen, snr, fused=True)
        losses.append(float(aux["loss"]))
        if i == 0:
            g1 = {k: v / 0.1 for k, v in state.opt_state["mu"].items()}
    cell = harness.Cell("t", 1, {"ofdm": {"nfft": 64, "nbits": 1},
                                 "train": TRAIN},
                        {"frames_per_step": frames, "channel": "ETU",
                         "snr_db": 5.0}, {}, [], [])
    ref = train_driver.reference_run(cell, w, seeds, CPU, "float32")
    prog = {"loss": losses, "grad1": g1,
            "change": {k: state.params[k] - w[k] for k in w}}
    r = train_driver.readings(prog, ref)
    assert r["loss_gap"] < 2e-5 and r["grad_gap"] < 2e-4 \
        and r["change_gap"] < 2e-3, r


def test_eval_batch():
    """`eval_batch` (float32 receiver) against the reference's counts on the
    same bits and unit noise, interleaved over 5 SNR points."""
    tr = Trainer(OFDMConfig(), TrainConfig(), channel="AWGN", device="cpu")
    w = _weights(tr)
    tr.model.load_state_dict(w)
    snrs = [-5, 0, 5, 10, 15]
    snr_vec, onehot = sweep.interleaved_groups(snrs, 40, "cpu")
    gen = torch.Generator().manual_seed(3)
    bits = torch.randint(0, 2, (40, 320, 1), dtype=torch.int32,
                         generator=gen)
    unit = torch.randn(40, 7, 80, 2, generator=gen)
    errors, ce = sweep.eval_batch(tr, snr_vec, onehot, gen, bits=bits,
                                  unit_noise=unit)
    groups = onehot.argmax(1)
    x = link.awgn_batch(bits[..., 0], unit, snr_vec, groups, 64)
    e_ref, ce_ref = dccn.eval_counts(w, x, bits, groups, 5, 1)
    assert (errors - e_ref).abs().sum() <= 2
    torch.testing.assert_close(ce.double(), ce_ref, rtol=1e-4, atol=0)


def test_dp2_mesh_steps_over_gloo():
    """The data-parallel driver's whole run over two gloo processes (the
    port's mesh step, float32 receiver) against the reference's three
    steps on the rows' frames drawn again from the rank generators' seeds:
    equal to float32 rounding."""
    from benchmark.run import run_cell
    cell = harness.Cell(
        "dp2", 2, {"ofdm": {"nbits": 1, "nfft": 64, "nsymbol": 7,
                            "nfilter": 64, "compute_dtype": None},
                   "train": dict(TRAIN, msg_length=8 * 7),
                   "route": "autograd"},
        {"kind": "train_dp", "processes": 2, "channel": "AWGN",
         "snr_db": 5.0, "frames_per_step": 8, "eval_frames": 8,
         "trace_seconds": 1.0},
        {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5},
        [{"name": "train_iq_per_s", "unit": "IQ/s"},
         {"name": "setup_s", "unit": "s"}], [])
    result, checks = run_cell(cell, 2 ** 40 + 3, 0.2, False, CPU)
    assert result["correct"] and result["attempted"] >= 1, checks
