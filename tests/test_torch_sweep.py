"""The port's serving slice end to end against the JAX package: one
interleaved sweep batch of the committed 16QAM arm on the same bits and
noise, the sweep protocols and the CSV schema."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel.awgn import awgn_channel
from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.eval.sweep import SweepResult as JResult
from dl_ofdm_tpu.ops.norms import batch_norm_ref
from dl_ofdm_tpu.train import metrics as JM
from dl_ofdm_tpu.train.loop import Trainer as JTrainer
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval import sweep as tsweep
from dl_ofdm_tpu_torch.train.checkpoint import load_params_npz, params_from_flax
from dl_ofdm_tpu_torch.train.loop import Trainer

ARM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "runs", "arms", "OFDM_Dense3_4mod_snr20_cpTrue.npz")


@pytest.fixture(scope="module")
def port_trainer():
    tr = Trainer(OFDMConfig(nbits=4), TrainConfig(), channel="AWGN",
                 device="cpu")
    tr.model.load_state_dict(params_from_flax(load_params_npz(ARM)))
    return tr


def _jax_interleaved(snrs, batch_frames):
    """`dl_ofdm_tpu/eval/sweep.py:84-99` for one device."""
    n_pts = len(snrs)
    rep = max(max(1, batch_frames // n_pts), 4)
    snr_np = np.repeat(np.asarray(snrs, np.float32), rep)
    idx_np = np.repeat(np.arange(n_pts), rep)
    order = np.argsort(np.tile(np.arange(rep), n_pts), kind="stable")
    return snr_np[order], np.eye(n_pts, dtype=np.float32)[idx_np[order]]


@pytest.mark.parametrize("snrs,batch_frames", [([0.0, 10.0, 20.0], 12),
                                               (list(range(-10, 31)), 2000)])
def test_interleaved_layout_matches_jax(snrs, batch_frames):
    snr_t, oh_t = tsweep.interleaved_groups(snrs, batch_frames, "cpu")
    snr_j, oh_j = _jax_interleaved(snrs, batch_frames)
    np.testing.assert_array_equal(snr_t.numpy(), snr_j)
    np.testing.assert_array_equal(oh_t.numpy(), oh_j)


def test_one_interleaved_batch_matches_jax(port_trainer, rng):
    snrs = [0.0, 8.0, 16.0]
    snr_vec, onehot = _jax_interleaved(snrs, 12)
    n = len(snr_vec)
    jt = JTrainer(JCfg(nbits=4), JTc(), channel="AWGN")
    params = jax.tree.map(jnp.asarray, load_params_npz(ARM))
    bits = rng.integers(0, 2, size=(n, jt.plan.frame_size, 4)).astype(np.int32)
    key_c, key_n = jax.random.split(jax.random.PRNGKey(4))

    # JAX: TX -> RayleighChannel (AWGN) -> awgn_channel -> batch_norm_ref ->
    # apply -> the sweep's eval_batch counts (sweep.py:101-121)
    wf = jt.tx(jnp.asarray(bits))
    ch = jt.channel(key_c, wf)
    y, _ = awgn_channel(key_n, ch.y, jnp.asarray(snr_vec))
    unit = np.asarray(jax.random.normal(key_n, y.shape, jnp.bfloat16)
                      .astype(jnp.float32))
    rx_in = batch_norm_ref(y, group_onehot=jnp.asarray(onehot))
    logits, _ = jt.model.apply({"params": params}, rx_in)
    logits = np.asarray(logits)
    pred = np.asarray(JM.bit_predictions(jnp.asarray(logits)))
    err_j = ((pred != bits).sum(axis=(1, 2))[:, None] * onehot).sum(0)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        logits.reshape(n, -1, 2)), axis=-1))
    y1h = np.eye(2, dtype=np.float32)[bits.reshape(n, -1)]
    ce_j = -np.mean(np.sum(y1h * logp, -1), 1) @ onehot

    err_t, ce_t = tsweep.eval_batch(
        port_trainer, torch.from_numpy(snr_vec), torch.from_numpy(onehot),
        bits=torch.from_numpy(bits), unit_noise=torch.tensor(unit))
    # a bit whose two JAX logits lie within 1e-5 may fall either way
    ties = (np.abs(logits[..., 1] - logits[..., 0]) < 1e-5).sum(axis=(1, 2))
    ties = ties @ onehot
    assert err_j.sum() > 0
    np.testing.assert_array_less(np.abs(err_t.numpy() - err_j), ties + 0.5)
    np.testing.assert_allclose(ce_t.numpy(), ce_j, rtol=1e-5)


def test_interleaved_sweep_runs(port_trainer):
    lines = []
    res = tsweep.ber_sweep(port_trainer, torch.Generator().manual_seed(0),
                           snrs=[-10, 0, 30], frames_per_point=8,
                           batch_frames=12, log_fn=lines.append)
    assert len(lines) == 3 and lines[0].startswith("SNR: -10.00, BER: ")
    assert res.ber.shape == res.loss.shape == (3,)
    assert np.all((res.ber > 0.05) & (res.ber < 0.6))
    assert np.all(np.isfinite(res.loss))


def test_point_batch_sweep_runs(port_trainer):
    res = tsweep.ber_sweep(port_trainer, torch.Generator().manual_seed(0),
                           snrs=[-10, 30], frames_per_point=128,
                           batch_frames=64, log_fn=lambda *a: None,
                           point_batch=True)
    # 64-frame normalization moments leave a floor near 1e-3 at 30 dB
    assert res.ber[0] > 0.3 and res.ber[1] < 1e-2
    assert np.all(np.isfinite(res.loss)) and res.loss[0] > res.loss[1]


def test_csv_schema_matches_jax(tmp_path):
    snr = np.arange(-10.0, 31.0)
    ber = np.linspace(0.4, 0.0, 41)
    loss = np.linspace(6.0, 1e-6, 41)
    a = JResult(snr, ber, loss).to_csv(str(tmp_path / "jax" / "a.csv"))
    b = tsweep.SweepResult(snr, ber, loss).to_csv(
        str(tmp_path / "port" / "a.csv"))
    with open(a) as fa, open(b) as fb:
        text = fb.read()
        assert text == fa.read()
    assert text.splitlines()[0] == "SNR,BER,Loss"
    assert len(text.splitlines()) == 42


def test_entry_points_need_cuda_unless_asked_for_cpu():
    from dl_ofdm_tpu_torch import resolve_device
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(OFDMConfig(), TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
