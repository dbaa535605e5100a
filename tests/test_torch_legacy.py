"""The port's ablation and legacy paths against the JAX package on the same
inputs and draws: PAPR clipping, the three AWGN variants, the complex FFT
FIR variants, the legacy Rayleigh channels, the legacy transmitters, the
DNN ablation receiver and the end-to-end blocks; and the cases of
`tests/test_legacy.py`, `tests/test_plan_tx.py` (PAPR) and
`tests/test_models.py` (e2e shapes, the phase variant) on the port.

Tolerances: float32 paths within 1e-5 (absolute, or of the largest value
where the outputs are O(10)); the complex FFT variants within 1e-4 of
`np.convolve`, JAX's own bound (`tests/test_channel.py:50-69`); the
legacy transmitters' index quirks bit-equal (the plans, the pilot
slices of the port's own waveform) and their waveforms within 1e-6 of
JAX's; the models' forward passes and gradients within 1e-5 of each
leaf's largest value (float32 sums in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel import awgn as jawgn
from dl_ofdm_tpu.channel import fir as jfir
from dl_ofdm_tpu.channel import legacy as jleg
from dl_ofdm_tpu.config import OFDMConfig as JCfg
from dl_ofdm_tpu.models import dccn as jdccn
from dl_ofdm_tpu.models import e2e_blocks as je2e
from dl_ofdm_tpu.ofdm import legacy_tx as jltx
from dl_ofdm_tpu.ofdm import papr as jpapr
from dl_ofdm_tpu.ofdm.plan import build_plan as jbuild_plan
from dl_ofdm_tpu_torch import models as tmodels
from dl_ofdm_tpu_torch import ofdm as tofdm
from dl_ofdm_tpu_torch.channel import awgn as tawgn
from dl_ofdm_tpu_torch.channel import fir as tfir
from dl_ofdm_tpu_torch.channel import legacy as tleg
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.models import dccn as tdccn
from dl_ofdm_tpu_torch.models import e2e_blocks as te2e
from dl_ofdm_tpu_torch.ofdm import legacy_tx as tltx
from dl_ofdm_tpu_torch.ofdm import papr as tpapr
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.train import checkpoint as tckpt
from dl_ofdm_tpu_torch.train.loop import Trainer

T = torch.from_numpy


def _np(x):
    return np.array(x)


def _complex(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


# -- PAPR ----------------------------------------------------------------------

def test_papr_exports_and_clip_papr_matches_jax(rng):
    assert tofdm.clip_papr is tpapr.clip_papr
    assert tofdm.clip_papr_iq is tpapr.clip_papr_iq
    x = _complex(rng, 4, 256) * 0.1
    x[1, 7] = 3.0
    want = _np(jpapr.clip_papr(jnp.asarray(x), peak=4.0))
    got = tpapr.clip_papr(T(x), peak=4.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    iq = rng.normal(size=(3, 50, 2)).astype(np.float32) * 2
    jy, jp = jpapr.clip_papr_iq(jnp.asarray(iq), peak=1.5)
    ty, tp = tpapr.clip_papr_iq(T(iq), peak=1.5)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_allclose(float(tp), float(jp), atol=1e-5)


def test_clip_papr_relative_threshold():
    """`tests/test_plan_tx.py` on the port: samples above peak x mean power
    are scaled down to the threshold amplitude, none is amplified, the
    others pass through exactly."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=512) + 1j * rng.normal(size=512)) * 0.1
    x[7] = 3.0 + 0j
    y = tpapr.clip_papr(T(x.astype(np.complex64)), peak=8.0).numpy()
    avg = np.mean(np.abs(x) ** 2)
    assert np.abs(y[7]) == pytest.approx(np.sqrt(8.0 * avg), rel=1e-5)
    assert np.all(np.abs(y) <= np.abs(x) + 1e-7)
    mask = np.abs(x) ** 2 < 8.0 * avg
    np.testing.assert_array_equal(y[mask], x[mask].astype(np.complex64))


def test_clip_papr_iq_absolute_norm():
    x = np.zeros((4, 2), np.float32)
    x[0] = [3.0, 4.0]
    x[1] = [0.3, 0.4]
    y, pwr = tpapr.clip_papr_iq(T(x), peak=2.0)
    y = y.numpy()
    assert np.linalg.norm(y[0]) == pytest.approx(2.0, rel=1e-5)
    np.testing.assert_allclose(y[1], x[1], rtol=1e-6)
    assert float(pwr) == pytest.approx(np.mean(np.sum(y ** 2, -1)), rel=1e-5)


# -- AWGN variants -------------------------------------------------------------------

def test_awgn_channel_phase_on_jax_draws(rng):
    key = jax.random.PRNGKey(4)
    x = rng.normal(size=(16, 7, 80, 2)).astype(np.float32) * 3 + 1
    snr = rng.uniform(-5, 20, size=16).astype(np.float32)
    jy, jp = jawgn.awgn_channel_phase(key, jnp.asarray(x), jnp.asarray(snr))
    ka, kp = jax.random.split(key)
    shape = (16, 7, 80, 1)
    amp = _np(jax.random.normal(ka, shape))
    phase = _np(jax.random.uniform(kp, shape, maxval=2 * jnp.pi))
    ty, tp = tawgn.awgn_channel_phase(T(x), T(snr), unit_amp=T(amp),
                                      phase=T(phase))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)


def test_awgn_phase_variant_noise_power():
    """`tests/test_models.py::test_awgn_phase_variant` on the port: the total
    complex noise power is level^2 = 0.5 10^(-SNR/10)."""
    x = T(np.random.default_rng(0).normal(size=(32, 7, 80, 2)).astype(
        np.float32))
    y, npow = tawgn.awgn_channel_phase(x, torch.full((32,), 10.0),
                                       torch.Generator().manual_seed(0))
    assert y.shape == x.shape
    assert float(npow) == pytest.approx(0.5 * 10 ** (-10 / 10), rel=0.2)


@pytest.mark.parametrize("norm", [True, False])
def test_awgn_channel_norm_on_jax_draws(norm, rng):
    key = jax.random.PRNGKey(5)
    x = rng.normal(size=(16, 7, 80, 2)).astype(np.float32) * 2 - 1
    snr = rng.uniform(-5, 20, size=16).astype(np.float32)
    jy, jp = jawgn.awgn_channel_norm(key, jnp.asarray(x), jnp.asarray(snr),
                                     norm=norm)
    unit = _np(jax.random.normal(key, x.shape, jnp.float32))
    ty, tp = tawgn.awgn_channel_norm(T(x), T(snr), norm=norm,
                                     unit_noise=T(unit))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)


def test_awgn_norm_batchnorm_moments_and_noise_power():
    """`tests/test_legacy.py::TestAWGNNorm` on the port's own draws."""
    g = torch.Generator().manual_seed(11)
    x = 5.0 * torch.randn(4096, 7, 80, 2, generator=g) + 2.0
    y, npow = tawgn.awgn_channel_norm(x, torch.full((4096,), 10.0), g,
                                      norm=False)
    level = np.sqrt(0.5) * 10 ** (-10 / 20.0)
    np.testing.assert_allclose(float(npow), 2 * level ** 2, rtol=0.05)
    assert abs(float(y.mean())) < 0.02
    np.testing.assert_allclose(float(y.var(unbiased=False)),
                               0.5 + level ** 2, rtol=0.05)


def test_awgn_norm_toggle_scales_by_rms():
    g = torch.Generator().manual_seed(12)
    x = torch.randn(2048, 7, 80, 2, generator=g)
    snr = torch.zeros(2048)
    _, np_off = tawgn.awgn_channel_norm(x, snr, g, norm=False)
    _, np_on = tawgn.awgn_channel_norm(x, snr, g, norm=True)
    np.testing.assert_allclose(float(np_off), 1.0, rtol=0.05)
    np.testing.assert_allclose(float(np_on), 1.0, rtol=0.05)


def test_awgn_channel_complex_on_jax_draws(rng):
    key = jax.random.PRNGKey(6)
    x = _complex(rng, 8, 7, 80)
    snr = rng.uniform(-5, 20, size=8).astype(np.float32)
    jy, jp = jawgn.awgn_channel_complex(key, jnp.asarray(x), jnp.asarray(snr))
    kr, ki = jax.random.split(key)
    unit = (_np(jax.random.normal(kr, x.shape))
            + 1j * _np(jax.random.normal(ki, x.shape))).astype(np.complex64)
    ty, tp = tawgn.awgn_channel_complex(T(x), T(snr), unit_noise=T(unit))
    assert ty.dtype == torch.complex64
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
    y2, _ = tawgn.awgn_channel_complex(T(x), T(snr),
                                       torch.Generator().manual_seed(0))
    assert y2.shape == x.shape and torch.isfinite(torch.view_as_real(y2)).all()


# -- the complex FFT FIR variants -------------------------------------------------

def test_fir_same_batched_matches_np_convolve_and_jax(rng):
    x = _complex(rng, 5, 97)
    h = _complex(rng, 5, 13)
    got = tfir.fir_same_batched(T(x), T(h), 6).numpy()
    assert got.dtype == np.complex64
    for i in range(5):
        np.testing.assert_allclose(got[i], np.convolve(x[i], h[i], "same"),
                                   atol=1e-4)
        np.testing.assert_array_equal(
            tfir.np_convolve_same_reference(x[i], h[i]),
            jfir.np_convolve_same_reference(x[i], h[i]))
    np.testing.assert_allclose(
        got, _np(jfir.fir_same_batched(jnp.asarray(x), jnp.asarray(h), 6)),
        atol=1e-4)


def test_fir_same_varlen_per_row_alignment(rng):
    lens = [13, 9, 11, 1]
    x = _complex(rng, 4, 80)
    h = np.zeros((4, 13), np.complex64)
    for i, n in enumerate(lens):
        h[i, :n] = _complex(rng, n)
    off = np.asarray([(n - 1) // 2 for n in lens], np.int32)
    got = tfir.fir_same_varlen(T(x), T(h), T(off)).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i], np.convolve(x[i], h[i, :n], "same"),
                                   atol=1e-4)
    np.testing.assert_allclose(got, _np(jfir.fir_same_varlen(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(off))), atol=1e-4)


@pytest.mark.parametrize("offset", ["scalar", "rows"])
def test_fir_per_symbol_matches_jax_and_its_windows(offset, rng):
    b, s, n_sc, f, n_taps = 3, 7, 80, 11, 20
    tx = _complex(rng, b, s, n_sc)
    h = _complex(rng, b, s, f)
    off = 5 if offset == "scalar" else np.asarray([5, 3, 0], np.int32)
    toff = off if offset == "scalar" else T(off)
    got = tfir.fir_per_symbol(T(tx), T(h), n_taps, toff).numpy()
    want = _np(jfir.fir_per_symbol(jnp.asarray(tx), jnp.asarray(h), n_taps,
                                   off if offset == "scalar"
                                   else jnp.asarray(off)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the reference's window semantics, one row by np.convolve
    offs = np.broadcast_to(off, (b,))
    pre = np.concatenate([np.zeros((b, n_taps), np.complex64),
                          tx.reshape(b, -1)], axis=1)
    for r in range(b):
        for i in (0, 3, 6):
            win = pre[r, n_sc * i:n_taps + n_sc * (i + 1)]
            full = np.convolve(win, h[r, i])
            start = n_taps + offs[r]
            np.testing.assert_allclose(got[r, i], full[start:start + n_sc],
                                       atol=1e-4)


# -- the legacy Rayleigh channels ----------------------------------------------------

@pytest.mark.parametrize("chan", ["ETU", "EPA", "EVA", "Flat"])
@pytest.mark.parametrize("rate,n_signal", [(0.96e6, 560), (1e7, 560),
                                           (1e7, 30)])
def test_legacy_tap_coeff_equals_jax(chan, rate, n_signal):
    np.testing.assert_array_equal(tleg.legacy_tap_coeff(chan, rate, n_signal),
                                  jleg.legacy_tap_coeff(chan, rate, n_signal))


def test_legacy_tap_coeff_etu_reference_equations():
    """`tests/test_legacy.py`: the ETU weights at 0.96 Msps from the
    reference equations, the linear-power quirk, 6 taps (51 at 10 MHz)."""
    coeff = tleg.legacy_tap_coeff("ETU", 0.96e6, 560)
    t_ns = 1e9 / 0.96e6
    delay = np.array([0, 50, 120, 200, 230, 500, 1600, 2300, 5000.0])
    pdb = np.array([-1.0, -1, -1, 0, 0, 0, -3, -5, -7])
    c_taps, c_idx = np.unique(np.ceil(delay / t_ns).astype(int),
                              return_index=True)
    c_pow = 10.0 ** (pdb[c_idx] / 10)
    expect = np.zeros(int(np.ceil(delay[-1] / t_ns)) + 1)
    expect[c_taps] = c_pow / np.sqrt(c_pow.sum())
    np.testing.assert_allclose(coeff, expect, rtol=1e-6)
    assert not np.allclose(coeff[coeff > 0],
                           np.sqrt(c_pow) / np.sqrt(c_pow.sum()))
    assert len(coeff) == 6 and len(tleg.legacy_tap_coeff("ETU", 1e7, 560)) \
        == 51
    np.testing.assert_array_equal(tleg.legacy_tap_coeff("Flat", 1e7, 100),
                                  np.ones(1, np.float32))


@pytest.mark.parametrize("chan,rate", [("ETU", 0.96e6), ("ETU", 1e7),
                                       ("EPA", 1e7)])
def test_rayleigh_channel_legacy_on_jax_draws(chan, rate, rng):
    key = jax.random.PRNGKey(3)
    n_fr, n_sym, n_sc, nfft = 4, 7, 80, 64
    x = rng.normal(size=(n_fr, n_sym, n_sc, 2)).astype(np.float32)
    jy, jh = jleg.rayleigh_channel_legacy(key, jnp.asarray(x), nfft, chan,
                                          rate)
    n_fir = len(jleg.legacy_tap_coeff(chan, rate, n_sym * n_sc))
    unit = _np(jax.random.normal(key, (n_fr, n_fir, 2), jnp.float32))
    ty, th = tleg.rayleigh_channel_legacy(T(x), nfft, chan, rate,
                                          unit_taps=T(unit))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=1e-5)
    # the reference equations: np.convolve 'same', H = fft(ht, nfft)
    ht = (unit[..., 0] + 1j * unit[..., 1]) / np.sqrt(2.0) * \
        tleg.legacy_tap_coeff(chan, rate, n_sym * n_sc)
    xc = (x[..., 0] + 1j * x[..., 1]).reshape(n_fr, -1)
    for i in range(n_fr):
        yc = np.convolve(xc[i], ht[i], mode="same")
        got = ty[i].reshape(-1, 2).numpy()
        np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], yc, atol=2e-4)
        hf = np.fft.fft(ht[i], nfft)
        for s in (0, 6):
            np.testing.assert_allclose(th[i, s, :, 0] + 1j * th[i, s, :, 1],
                                       hf, atol=2e-4)


def test_rayleigh_channel_legacy_awgn_passthrough():
    x = torch.ones(2, 7, 80, 2)
    y, h = tleg.rayleigh_channel_legacy(x, 64, "AWGN")
    assert torch.equal(y, x) and h.shape == (2, 7, 64, 2)
    assert torch.equal(h[..., 0], torch.ones(2, 7, 64))
    assert torch.equal(h[..., 1], torch.zeros(2, 7, 64))


@pytest.mark.parametrize("chan,rate", [("ETU", 1e7), ("EPA", 1e7),
                                       ("ETU", 0.96e6)])
def test_batch_coherent_on_jax_draws(chan, rate, rng):
    key = jax.random.PRNGKey(7)
    b, s, t = 3, 7, 80
    x = rng.normal(size=(b, s, t, 2)).astype(np.float32)
    snr = rng.uniform(0, 20, size=b).astype(np.float32)
    jy, jp = jleg.rayleigh_channel_batch_coherent(
        key, jnp.asarray(x), jnp.asarray(snr), chan, rate)
    n_fir = len(jleg.legacy_tap_coeff(chan, rate, s * t))
    kh, kn = jax.random.split(key)
    taps = _np(jax.random.normal(kh, (n_fir, 2), jnp.float32))
    noise = _np(jax.random.normal(kn, (b, s * t, 2), jnp.float32))
    ty, tp = tleg.rayleigh_channel_batch_coherent(
        T(x), T(snr), chan, rate, unit_taps=T(taps), unit_noise=T(noise))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)


def test_batch_coherent_tf_same_alignment(rng):
    """`tests/test_legacy.py`: TF 'SAME' cross-correlation, out[n] =
    sum_k h[k] x[n - (F-1)//2 + k], one kernel for the batch (noise
    negligible at 300 dB)."""
    b, s, t = 3, 2, 40
    x = rng.normal(size=(b, s, t, 2)).astype(np.float32)
    coeff = tleg.legacy_tap_coeff("EPA", 1e7, s * t)
    n_fir = len(coeff)
    taps = rng.normal(size=(n_fir, 2)).astype(np.float32)
    y, _ = tleg.rayleigh_channel_batch_coherent(
        T(x), torch.full((b,), 300.0), "EPA", 1e7, unit_taps=T(taps),
        generator=torch.Generator().manual_seed(0))
    ht = (taps[:, 0] + 1j * taps[:, 1]) / np.sqrt(2.0) * coeff
    xc = (x[..., 0] + 1j * x[..., 1]).reshape(b, -1)
    pad_l = (n_fir - 1) // 2
    for i in range(b):
        xp = np.pad(xc[i], (pad_l, n_fir - 1 - pad_l))
        expect = np.array([np.dot(ht, xp[n:n + n_fir]) for n in range(s * t)])
        got = y[i].reshape(-1, 2).numpy()
        np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], expect,
                                   atol=1e-4)


# -- the legacy transmitters ------------------------------------------------------------

def _bits_to_syms_np(bits):
    from dl_ofdm_tpu.ofdm.constellation import _table_np
    nbits = bits.shape[-1]
    idx = bits.reshape(-1, nbits) @ (1 << np.arange(nbits)[::-1])
    return _table_np(nbits)[idx]


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_symbol_pilot_tx_matches_jax_and_numpy(nbits, rng):
    plan, jplan = build_plan(OFDMConfig(nbits=nbits)), jbuild_plan(
        JCfg(nbits=nbits))
    n_sym, n_data = 2 * plan.nsymbol, len(plan.data_carriers)
    bits = rng.integers(0, 2, (n_sym, n_data, nbits)).astype(np.int32)
    iq, pilot = tltx.ofdm_modulate_symbol_pilots(T(bits), plan)
    jiq, jpilot = jltx.ofdm_modulate_symbol_pilots(jnp.asarray(bits), jplan)
    np.testing.assert_allclose(iq.numpy(), _np(jiq), atol=1e-6)
    np.testing.assert_allclose(pilot.numpy(), _np(jpilot), atol=1e-6)
    # the quirk: time samples at the pilot carriers' indices, bit for bit
    assert torch.equal(pilot, iq[:, :, list(plan.pilot_carriers)])
    syms = _bits_to_syms_np(bits).reshape(n_sym, n_data)
    grid = np.zeros((n_sym, plan.nfft), np.complex64)
    grid[:, plan.data_carriers] = syms
    grid[:, plan.pilot_carriers] = plan.pilot_value
    td = np.fft.ifft(grid)
    wf = np.concatenate([td[:, -plan.cp_len:], td], axis=1).reshape(
        -1, plan.nsymbol, plan.samples_per_symbol)
    np.testing.assert_allclose(iq[..., 0] + 1j * iq[..., 1], wf, atol=2e-5)


def test_symbol_pilot_tx_shape_validation():
    plan = build_plan(OFDMConfig(nbits=1))
    with pytest.raises(ValueError, match="per-symbol data size"):
        tltx.ofdm_modulate_symbol_pilots(torch.zeros(7, 3, 1,
                                                     dtype=torch.int32), plan)
    with pytest.raises(ValueError, match="not a multiple"):
        tltx.ofdm_modulate_symbol_pilots(torch.zeros(
            5, len(plan.data_carriers), 1, dtype=torch.int32), plan)


@pytest.mark.parametrize("k,p,g", [(64, 8, 8), (64, 4, 16), (128, 16, 8),
                                   (64, 2, 8)])
def test_legacy_tx_plan_equals_jax(k, p, g):
    a, b = tltx.legacy_tx_plan(k, p, g), jltx.legacy_tx_plan(k, p, g)
    assert (a.nfft, a.cp_len, a.n_pilot, a.n_guard) == (
        b.nfft, b.cp_len, b.n_pilot, b.n_guard)
    for f in ("data_carriers", "pilot_carriers", "guard_carriers"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_legacy_tx_plan_reference_values():
    plan = tltx.legacy_tx_plan(64, 8, 8)
    assert plan.cp_len == 16
    np.testing.assert_array_equal(plan.pilot_carriers, np.arange(4, 60, 8))
    assert len(plan.data_carriers) == 49
    np.testing.assert_array_equal(plan.data_carriers, np.delete(
        np.arange(4, 60), plan.pilot_carriers - 4))
    assert 31 in plan.data_carriers or 32 in plan.data_carriers


@pytest.mark.parametrize("k,p,g", [(64, 8, 8), (64, 2, 8)])
def test_legacy_transmitter_matches_jax_and_numpy(k, p, g, rng):
    """(64, 2, 8): CP 16 <= K//P 32, so the reversed pilot slice is empty,
    as JAX's is."""
    plan = tltx.legacy_tx_plan(k, p, g)
    b, n_sym, nbits = 3, 4, 2
    bits = rng.integers(0, 2, (b, n_sym, len(plan.data_carriers),
                               nbits)).astype(np.int32)
    iq, pilot = tltx.ofdm_transmitter_iq(T(bits), k, p, g)
    jiq, jpilot = jltx.ofdm_transmitter_iq(jnp.asarray(bits), k, p, g)
    np.testing.assert_allclose(iq.numpy(), _np(jiq), atol=1e-6)
    assert pilot.shape == jpilot.shape
    np.testing.assert_allclose(pilot.numpy(), _np(jpilot), atol=1e-6)
    rev = list(range(plan.cp_len, k // p, -1))
    assert torch.equal(pilot, iq[:, :, rev])
    syms = _bits_to_syms_np(bits).reshape(b * n_sym, -1)
    grid = np.zeros((b * n_sym, k), np.complex64)
    grid[:, plan.data_carriers] = syms
    grid[:, plan.pilot_carriers] = 3 + 3j
    td = np.fft.ifft(grid)
    wf = np.concatenate([td[:, -plan.cp_len:], td], axis=1).reshape(
        b, n_sym, k + plan.cp_len)
    np.testing.assert_allclose(iq[..., 0] + 1j * iq[..., 1], wf, atol=2e-5)
    with pytest.raises(ValueError, match="data size"):
        tltx.ofdm_transmitter_iq(T(bits[:, :, 1:]), k, p, g)


# -- the DNN ablation and the end-to-end blocks ------------------------------------------

def _leaf_close(got: dict, want: dict, tol: float = 1e-5):
    assert set(got) == set(want)
    for k in want:
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, atol=tol * scale,
                                   rtol=0, err_msg=k)


def _forward_and_grads(jmod, jparams, tmod, jx, tx, cot):
    """(JAX output, port output, JAX grads, port grads) of sum(out * cot)."""
    tmod.load_state_dict(tckpt.params_from_flax(
        jax.tree.map(np.asarray, jparams)), strict=True)

    def jloss(p):
        out = jmod.apply({"params": p}, jx)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * cot), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    out = tmod(tx)
    out = out[0] if isinstance(out, tuple) else out
    tg = torch.autograd.grad((out * T(cot)).sum(), list(tmod.parameters()))
    names = [n for n, _ in tmod.named_parameters()]
    return (jout, out.detach(), tckpt.params_from_flax(
        jax.tree.map(np.asarray, jg)), dict(zip(names, tg)))


@pytest.mark.parametrize("keep_cp", [True, False])
def test_dnn_receiver_forward_and_grads_match_jax(keep_cp, rng):
    nbits = 2
    plan = jbuild_plan(JCfg(nbits=nbits))
    kw = dict(nbits=nbits, nfft=64, cp_len=plan.cp_len, nfilter=32,
              frame_size=plan.frame_size, keep_cp=keep_cp)
    jrx, trx = jdccn.DNNReceiver(**kw), tdccn.DNNReceiver(nsymbol=7, **kw)
    x = rng.normal(size=(5, 7, 80, 2)).astype(np.float32)
    jparams = jrx.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert sorted(jparams) == [f"Dense_{i}" for i in range(5)]
    cot = rng.normal(size=(5, plan.frame_size, nbits, 2)).astype(np.float32)
    jout, tout, jg, tg = _forward_and_grads(jrx, jparams, trx, jnp.asarray(x),
                                            T(x), cot)
    assert jrx.apply({"params": jparams}, jnp.asarray(x))[1] is None
    assert trx(T(x))[1] is None
    _leaf_close({"logits": tout}, {"logits": T(_np(jout))})
    _leaf_close(tg, jg)


def test_dnn_receiver_exports_and_rx_outputs():
    assert tmodels.DNNReceiver is tdccn.DNNReceiver
    assert tmodels.RxOutputs is tdccn.RxOutputs
    for name in ("DCCNReceiver", "Equalizer", "EQUALIZER_REGISTRY",
                 "EqualizedReceiver"):
        assert hasattr(tmodels, name), name
    logits = torch.zeros(2, 320, 1, 2)
    out = tdccn.RxOutputs(logits, logits.softmax(-1), None)
    assert out.equalized is None and out.chest is None
    assert [f.name for f in __import__("dataclasses").fields(out)] == [
        f.name for f in __import__("dataclasses").fields(jdccn.RxOutputs)]


def test_trainer_with_dnn_receiver_takes_the_autograd_route():
    cfg, tc = OFDMConfig(nbits=1), TrainConfig(snr=5.0, batch_size=28,
                                               msg_length=56)
    plan = build_plan(cfg)
    model = tdccn.DNNReceiver(nbits=1, nfft=64, cp_len=plan.cp_len,
                              nfilter=64, frame_size=plan.frame_size)
    tr = Trainer(cfg, tc, channel="AWGN", model=model, device="cpu")
    assert tr._fused_model_spec is None and not tr._use_fused_model
    with pytest.raises(ValueError, match="no fused route"):
        tr.train_step(tr.init_state(torch.Generator().manual_seed(0)),
                      torch.Generator(), torch.full((4,), 5.0), fused=True)
    g = torch.Generator().manual_seed(1)
    state = tr.init_state(g)
    state, aux = tr.train_step(state, g, torch.full((4,), 5.0))
    assert state.step == 1 and np.isfinite(float(aux["loss"]))
    assert set(state.params) == {f"Dense_{i}.{p}" for i in range(5)
                                 for p in ("weight", "bias")}


def _e2e_pairs(n_sc=16, s=7, nbits=2):
    return {
        "DenseBlockTx": (je2e.DenseBlockTx(codein=2, codeout=3),
                         te2e.DenseBlockTx(2, 3, n_sc, nbits), "bits"),
        "ConvBlockTx": (je2e.ConvBlockTx(nbits=nbits),
                        te2e.ConvBlockTx(nbits, n_sc, s), "bits"),
        "ConvBlockTx_noconv": (je2e.ConvBlockTx(nbits=nbits, use_conv=False),
                               te2e.ConvBlockTx(nbits, n_sc, s, False),
                               "bits"),
        "ConvBlockRx": (je2e.ConvBlockRx(nbits=nbits),
                        te2e.ConvBlockRx(nbits, n_sc, s), "iq"),
        "ConvBlockRx_noconv": (je2e.ConvBlockRx(nbits=nbits, use_conv=False),
                               te2e.ConvBlockRx(nbits, n_sc, s, False), "iq"),
        "DenseBlockRx": (je2e.DenseBlockRx(frame_size=40, nbits=nbits),
                         te2e.DenseBlockRx(40, nbits, n_sc, 2 ** nbits),
                         "soft"),
    }


@pytest.mark.parametrize("block", list(_e2e_pairs()))
def test_e2e_block_forward_and_grads_match_jax(block, rng):
    n_sc, s, nbits = 16, 7, 2
    jmod, tmod, kind = _e2e_pairs(n_sc, s, nbits)[block]
    if kind == "bits":
        x = rng.integers(0, 2, (3, s, n_sc, nbits)).astype(np.int32)
    elif kind == "iq":
        x = rng.normal(size=(3, s, n_sc, 2)).astype(np.float32)
    else:
        x = rng.normal(size=(3, s, n_sc, 2 ** nbits)).astype(np.float32)
    jparams = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    jparams = jax.tree.map(lambda v: v + 0.05 * jnp.asarray(
        rng.normal(size=v.shape).astype(np.float32)), jparams)
    jout = jmod.apply({"params": jparams}, jnp.asarray(x))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jout, tout, jg, tg = _forward_and_grads(jmod, jparams, tmod,
                                            jnp.asarray(x), T(x), cot)
    assert tuple(tout.shape) == jout.shape
    _leaf_close({"out": tout}, {"out": T(_np(jout))})
    _leaf_close(tg, jg)


def test_e2e_blocks_shapes():
    """`tests/test_models.py::test_e2e_blocks_shapes` on the port."""
    bits = torch.zeros(2, 7, 48, 2, dtype=torch.int32)
    assert te2e.DenseBlockTx(2, 3, 48, 2)(bits).shape == (2, 7, 72, 2)
    iq = te2e.ConvBlockTx(2, 48, 7)(bits)
    assert iq.shape == (2, 7, 48, 2)
    soft = te2e.ConvBlockRx(2, 48, 7)(iq)
    assert soft.shape == (2, 7, 48, 4)
    logits = te2e.DenseBlockRx(320, 2, 48, 4)(soft)
    assert logits.shape == (2, 320, 2, 2)
    blk = te2e.ConvBlockTx(2, 48, 7)
    before = {k: v.clone() for k, v in blk.state_dict().items()}
    blk.reset_parameters(torch.Generator().manual_seed(3))
    assert any(not torch.equal(before[k], v)
               for k, v in blk.state_dict().items())
