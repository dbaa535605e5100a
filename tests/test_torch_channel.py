"""The port's channel (profiles, FIR, static Rayleigh, AWGN) and input
normalization against the JAX package on the same inputs and draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel import awgn as jawgn
from dl_ofdm_tpu.channel import fir as jfir
from dl_ofdm_tpu.channel import profiles as jprof
from dl_ofdm_tpu.channel.rayleigh import RayleighChannel as JChannel
from dl_ofdm_tpu.ops import norms as jnorms
from dl_ofdm_tpu_torch.channel import awgn as tawgn
from dl_ofdm_tpu_torch.channel import fir as tfir
from dl_ofdm_tpu_torch.channel import profiles as tprof
from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel as TChannel
from dl_ofdm_tpu_torch.ops import norms as tnorms


def _jax_static_taps(channel: JChannel, key, b: int) -> np.ndarray:
    """The tap gains `dl_ofdm_tpu` RayleighChannel draws from `key`
    (`rayleigh.py:137-141`), so the port can be fed the same draws."""
    k_static, _ = jax.random.split(key)
    z = jax.random.normal(k_static, (b, channel.max_taps, 2),
                          dtype=jnp.float32) / np.sqrt(2.0)
    return np.array(z)


@pytest.mark.parametrize("name", ["etu", "epa", "eva", "custom", "flat",
                                  "awgn"])
@pytest.mark.parametrize("weighting", ["reference", "physical"])
@pytest.mark.parametrize("rate", [0.96e6, 1.92e6])
def test_profiles_exactly_equal(name, weighting, rate):
    a = jprof.get_profile(name, rate, weighting)
    b = tprof.get_profile(name, rate, weighting)
    assert (a.name, a.fd_mobile, a.n_fir, a.same_offset) == \
        (b.name, b.fd_mobile, b.n_fir, b.same_offset)
    for f in ("tap_delay_ns", "tap_pow_db", "ch_coeff", "alpha_matrix"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("offsets", [[6, 6, 6, 6], [0, 6, 5, 4]])
def test_fir_same_iq_matches_jax(offsets, rng):
    x = rng.normal(size=(4, 70, 2)).astype(np.float32)
    h = rng.normal(size=(4, 13, 2)).astype(np.float32)
    off = np.asarray(offsets)
    want = np.asarray(jfir.fir_same_iq(jnp.asarray(x), jnp.asarray(h), off))
    got = tfir.fir_same_iq(torch.from_numpy(x), torch.from_numpy(h),
                           off).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _tx(rng, b=8):
    return rng.normal(size=(b, 7, 80, 2)).astype(np.float32)


def test_awgn_passthrough_exact(rng):
    x = _tx(rng)
    jo = JChannel("awgn")(jax.random.PRNGKey(3), jnp.asarray(x))
    to = TChannel("awgn")(torch.from_numpy(x),
                          torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(to.y.numpy(), x)
    np.testing.assert_array_equal(to.y.numpy(), np.asarray(jo.y))
    np.testing.assert_array_equal(to.h_freq.numpy(), np.asarray(jo.h_freq))


@pytest.mark.parametrize("channel", ["etu", "epa", "mixRayleigh", "mixAll"])
def test_static_channel_on_the_same_taps(channel, rng):
    x = _tx(rng, b=10)
    jc, tc = JChannel(channel), TChannel(channel)
    key = jax.random.PRNGKey(11)
    jo = jc(key, jnp.asarray(x))
    z = _jax_static_taps(jc, key, 10)
    to = tc(torch.from_numpy(x), zck=torch.from_numpy(z))
    np.testing.assert_allclose(to.y.numpy(), np.asarray(jo.y), atol=1e-5)
    np.testing.assert_allclose(to.h_freq.numpy(), np.asarray(jo.h_freq),
                               atol=1e-5)


def test_static_profile_tap_power_in_distribution(rng):
    """Own draws: the mean FIR kernel power per frame (Parseval on h_freq)
    agrees with the profile's expectation and with the JAX package's draws."""
    b = 4000
    x = np.zeros((b, 1, 16, 2), np.float32)
    prof = tprof.get_profile("etu")
    expect = float(np.sum((prof.ch_coeff[:, None] * prof.alpha_matrix) ** 2))
    to = TChannel("etu", nfft=64)(torch.from_numpy(x),
                                  torch.Generator().manual_seed(5))
    jo = JChannel("etu", nfft=64)(jax.random.PRNGKey(5), jnp.asarray(x))
    p_t = float((to.h_freq ** 2).sum(-1).mean())
    p_j = float(np.mean(np.sum(np.asarray(jo.h_freq) ** 2, -1)))
    # per-frame power has a relative spread below 1; 4000 frames -> <2% sd
    assert abs(p_t / expect - 1) < 0.06
    assert abs(p_t / p_j - 1) < 0.08


def test_mobile_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TChannel("etu", mobile=True)


def test_awgn_channel_on_injected_unit_noise(rng):
    x = _tx(rng)
    snr = np.linspace(-5, 25, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    y_j, p_j = jawgn.awgn_channel(key, jnp.asarray(x), jnp.asarray(snr))
    # the unit normals awgn_channel draws (bf16 by default, awgn.py:34)
    unit = np.asarray(jax.random.normal(key, x.shape, jnp.bfloat16)
                      .astype(jnp.float32))
    y_t, p_t = tawgn.awgn_channel(torch.from_numpy(x), torch.from_numpy(snr),
                                  unit_noise=torch.tensor(unit))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(float(p_t), float(p_j), rtol=1e-5)


def test_awgn_channel_draws_bf16_unit_noise(rng):
    x = _tx(rng, b=64)
    snr = torch.zeros(64)
    g = torch.Generator().manual_seed(0)
    y, p = tawgn.awgn_channel(torch.from_numpy(x), snr, g)
    x_t = torch.from_numpy(x)
    x_norm = x_t * torch.rsqrt((x_t ** 2).sum(-1).mean())
    unit = (y - x_norm) / np.sqrt(0.5)
    # drawn in bf16: every unit normal is a bf16 value, of unit variance
    assert torch.allclose(unit, unit.to(torch.bfloat16).float(), atol=1e-5)
    assert abs(float(unit.var()) - 1) < 0.02
    assert abs(float(p) - 1) < 0.02


@pytest.mark.parametrize("groups", [None, 3])
def test_batch_norm_ref_matches_jax(groups, rng):
    x = rng.normal(loc=0.3, scale=2.0, size=(12, 7, 5, 2)).astype(np.float32)
    oh = None
    if groups:
        oh = np.eye(groups, dtype=np.float32)[np.arange(12) % groups]
    want = np.asarray(jnorms.batch_norm_ref(
        jnp.asarray(x), group_onehot=None if oh is None else jnp.asarray(oh)))
    got = tnorms.batch_norm_ref(
        torch.from_numpy(x),
        group_onehot=None if oh is None else torch.from_numpy(oh)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_leaky_relu_slope_is_tf_default():
    x = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_array_equal(
        tnorms.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(jnorms.leaky_relu(jnp.asarray(x))))
    assert float(tnorms.leaky_relu(torch.tensor(-1.0))) == pytest.approx(-0.2)
