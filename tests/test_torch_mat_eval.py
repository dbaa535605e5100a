"""The port's `.mat` interop and plots (`dl_ofdm_tpu_torch/eval/`:
`mat_export`, `mat_eval`, `plots`) against the JAX package's, on the CPU:
files written by either package read back bit-equal by the other,
`evaluate_on_mat` on the same waveforms, noise and weights as JAX's (logits
within 1e-5 of their largest value, equal error counts but for bits whose
logits tie within that), `closed_form_ber` equal, `plot_ber_curves`
writing a PNG."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel.awgn import awgn_channel as jawgn
from dl_ofdm_tpu.config import OFDMConfig as JCfg
from dl_ofdm_tpu.eval import mat_eval as jeval
from dl_ofdm_tpu.eval import mat_export as jexport
from dl_ofdm_tpu.eval import plots as jplots
from dl_ofdm_tpu.models.dccn import DCCNReceiver as JRx
from dl_ofdm_tpu.ofdm.plan import build_plan as jbuild
from dl_ofdm_tpu.ops.norms import batch_norm_ref as jbn
from dl_ofdm_tpu_torch.config import OFDMConfig as TCfg
from dl_ofdm_tpu_torch.eval import mat_eval as teval
from dl_ofdm_tpu_torch.eval import mat_export as texport
from dl_ofdm_tpu_torch.eval import plots as tplots
from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver as TRx
from dl_ofdm_tpu_torch.ofdm.plan import build_plan as tbuild
from dl_ofdm_tpu_torch.train import checkpoint as tckpt

SNRS = (0, 10)


def _load(mod, tmp, nbits, plan, longcp=True, **kw):
    return mod.load_mat_waveforms(str(tmp), nbits, "AWGN", plan.nfft,
                                  plan.nsymbol, plan.frame_size,
                                  longcp=longcp, **kw)


@pytest.mark.parametrize("nbits,longcp", [(1, True), (4, False)])
def test_jax_written_file_reads_bit_equal(tmp_path, nbits, longcp):
    jplan = jbuild(JCfg(nbits=nbits, longcp=longcp))
    path = jexport.export_mat_waveforms(jplan, nbits, "AWGN", 5,
                                        str(tmp_path), seed=3, longcp=longcp)
    assert os.path.basename(path) == teval.mat_file_name(nbits, "AWGN", 64,
                                                          longcp)
    jiq, jbits = _load(jeval, tmp_path, nbits, jplan, longcp)
    tiq, tbits = _load(teval, tmp_path, nbits, jplan, longcp, device="cpu")
    assert tiq.dtype == torch.float32 and tbits.dtype == torch.int32
    assert np.array_equal(tiq.numpy(), np.asarray(jiq))
    assert np.array_equal(tbits.numpy(), np.asarray(jbits))


@pytest.mark.parametrize("nbits,longcp", [(2, True), (3, False)])
def test_port_written_file_reads_bit_equal_in_jax(tmp_path, nbits, longcp):
    """The port writes JAX's bits (injected); JAX's loader reads what the
    port's does, bit for bit, and the waveform is JAX's within float32
    rounding of the two modulators."""
    jplan = jbuild(JCfg(nbits=nbits, longcp=longcp))
    tplan = tbuild(TCfg(nbits=nbits, longcp=longcp))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jexport.export_mat_waveforms(jplan, nbits, "AWGN", 4, str(jdir), seed=9,
                                 longcp=longcp)
    _, jbits = _load(jeval, jdir, nbits, jplan, longcp)
    path = texport.export_mat_waveforms(tplan, nbits, "AWGN", 4, str(tdir),
                                        longcp=longcp,
                                        bits=np.asarray(jbits), device="cpu")
    assert os.path.basename(path) == os.listdir(jdir)[0]
    jiq, jb2 = _load(jeval, tdir, nbits, jplan, longcp)
    tiq, tb2 = _load(teval, tdir, nbits, jplan, longcp, device="cpu")
    assert np.array_equal(np.asarray(jiq), tiq.numpy())
    assert np.array_equal(np.asarray(jb2), tb2.numpy())
    assert np.array_equal(tb2.numpy(), np.asarray(jbits))
    want, _ = _load(jeval, jdir, nbits, jplan, longcp)
    np.testing.assert_allclose(tiq.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_export_draws_bits_from_its_seed(tmp_path):
    plan = tbuild(TCfg(nbits=2))
    a = texport.export_mat_waveforms(plan, 2, "EVA", 6, str(tmp_path / "a"),
                                     seed=4, device="cpu")
    b = texport.export_mat_waveforms(plan, 2, "EVA", 6, str(tmp_path / "b"),
                                     seed=4, device="cpu")
    assert os.path.basename(a) == "TX_bit_iq_QPSK_EVA_FFT64.mat"
    import scipy.io as sio
    ma, mb = sio.loadmat(a), sio.loadmat(b)
    assert np.array_equal(ma["txbits"], mb["txbits"])
    assert ma["Ch_Data"].shape == (7 * 80, 6)
    assert 0.4 < ma["txbits"].mean() < 0.6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            texport.export_mat_waveforms(plan, 2, "EVA", 6, str(tmp_path))


def _receivers(nbits, rng):
    plan = jbuild(JCfg(nbits=nbits))
    kw = dict(nbits=nbits, nfft=64, cp_len=plan.cp_len, nfilter=64,
              frame_size=plan.frame_size)
    jrx, trx = JRx(**kw), TRx(nsymbol=7, **kw)
    x = rng.normal(size=(2, 7, 80, 2)).astype(np.float32)
    params = jrx.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    trx.load_state_dict(tckpt.params_from_flax(params), strict=True)
    return plan, jrx, {"params": jax.tree.map(jnp.asarray, params)}, trx


def test_evaluate_on_mat_matches_jax(tmp_path, rng):
    """JAX's `evaluate_on_mat` and the port's on one file, JAX's noise
    (bf16 unit normals from JAX's keys, `mat_eval.py:43-59`) injected into
    the port, one set of weights: per point the logits within 1e-5 of
    their largest value, the CE within 1e-5, the bit errors equal but for
    bits whose two logits JAX and the port order differently."""
    plan, jrx, jvars, trx = _receivers(2, rng)
    jexport.export_mat_waveforms(plan, 2, "AWGN", 24, str(tmp_path), seed=1)
    jiq, jbits = _load(jeval, tmp_path, 2, plan)
    tiq, tbits = _load(teval, tmp_path, 2, plan, device="cpu")
    want = jeval.evaluate_on_mat(jrx, jvars["params"], jiq, jbits, snrs=SNRS,
                                 seed=5, log_fn=lambda *a: None)
    key = jax.random.PRNGKey(5)
    noise = []
    for i, snr in enumerate(SNRS):
        key, k = jax.random.split(key)
        unit = jax.random.normal(k, jiq.shape, dtype=jnp.bfloat16)
        noise.append(torch.from_numpy(np.asarray(unit, np.float32)))
        snr_vec = jnp.full((jiq.shape[0],), snr, jnp.float32)
        jlog = np.asarray(jrx.apply(jvars, jbn(jawgn(k, jiq, snr_vec)[0]))[0])
        tlog, conf, ce = teval.mat_point(trx, tiq, tbits, snr,
                                         unit_noise=noise[-1])
        scale = float(np.abs(jlog).max())
        np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0,
                                   atol=1e-5 * scale)
        margin = np.abs(jlog[..., 1] - jlog[..., 0])
        near = int((margin < 2e-5 * scale).sum())
        jerr = int(((jlog[..., 1] > jlog[..., 0]) != np.asarray(jbits)).sum())
        assert abs(int(conf[0, 1] + conf[1, 0]) - jerr) <= near
    got = teval.evaluate_on_mat(trx, tiq, tbits, snrs=SNRS,
                                log_fn=lambda *a: None, unit_noise=noise)
    np.testing.assert_array_equal(got.snr, want.snr)
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)
    n_bits = tbits.numel()
    np.testing.assert_allclose(got.ber * n_bits, want.ber * n_bits,
                               rtol=0, atol=2)


def test_evaluate_on_mat_draws_from_its_seed(tmp_path, rng):
    """Without injected noise the sweep draws from its seed: the same seed
    gives the same result; the file round trip decodes no worse than
    chance at 10 dB with random weights (it runs end to end)."""
    plan, _, _, trx = _receivers(1, rng)
    texport.export_mat_waveforms(tbuild(TCfg()), 1, "AWGN", 16,
                                 str(tmp_path), seed=2, device="cpu")
    iq, bits = _load(teval, tmp_path, 1, plan, device="cpu")
    logs = []
    a = teval.evaluate_on_mat(trx, iq, bits, snrs=SNRS, seed=3,
                              log_fn=logs.append)
    b = teval.evaluate_on_mat(trx, iq, bits, snrs=SNRS, seed=3,
                              log_fn=lambda *x: None)
    assert np.array_equal(a.ber, b.ber) and np.array_equal(a.loss, b.loss)
    assert len(logs) == 2 and logs[1].startswith("SNR: 10.00, BER: ")
    assert np.all(np.isfinite(a.loss)) and np.all((a.ber >= 0) & (a.ber <= 1))


@pytest.mark.parametrize("mod", ["BPSK", "qpsk", "16QAM"])
def test_closed_form_ber_equal(mod):
    snr = np.linspace(-5, 15, 21)
    np.testing.assert_array_equal(tplots.closed_form_ber(mod, snr),
                                  jplots.closed_form_ber(mod, snr))


def test_closed_form_ber_rejects_other_modulations():
    with pytest.raises(ValueError):
        tplots.closed_form_ber("8QAM", np.zeros(2))


def test_plot_ber_curves_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "ber.png")
    snr = np.arange(-10, 31, 5)
    ber = np.loadtxt(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "runs",
        "BER_OFDM_EVA_LS-Quadeer_lte_64_Gray.csv"), delimiter=",")[1]
    assert tplots.plot_ber_curves({"LS-Quadeer": (snr, ber),
                                   "zeros": (snr, np.zeros(9))},
                                  title="EVA", out_png=out) == out
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
