"""The port's Jakes-Doppler channel (`channel/doppler.py`,
`fir_per_symbol_iq`, `RayleighChannel(mobile=True)`) against the JAX
package on the same inputs, tap gains and sinusoid phases."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel import doppler as jdop
from dl_ofdm_tpu.channel import fir as jfir
from dl_ofdm_tpu.channel.rayleigh import RayleighChannel as JChannel
from dl_ofdm_tpu_torch.channel import doppler as tdop
from dl_ofdm_tpu_torch.channel import fir as tfir
from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel as TChannel


def _phases(rng, b, taps):
    return [rng.uniform(0, 2 * np.pi, (b, jdop.SS, taps)).astype(np.float32)
            for _ in range(2)]


def test_jakes_frequencies_match_jax(rng):
    fd = rng.uniform(0, 300, 5).astype(np.float32)
    want = jdop.jakes_frequencies(jnp.asarray(fd), 9)
    got = tdop.jakes_frequencies(torch.from_numpy(fd), 9)
    for g, w in zip(got, want):
        assert g.shape == (5, jdop.SS, 9)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("taps", [1, 9])
def test_jakes_gains_from_phases_match_jax(taps, rng):
    b, s = 6, 7
    th_re, th_im = _phases(rng, b, taps)
    fd = np.asarray([5, 300, 70, 5, 0, 120], np.float32)
    t = np.arange(s, dtype=np.float32) * np.float32(80 / 0.96e6)
    want = jdop.jakes_gains_from_phases(jnp.asarray(th_re), jnp.asarray(th_im),
                                        jnp.asarray(fd), jnp.asarray(t), taps)
    got = tdop.jakes_gains_from_phases(torch.from_numpy(th_re),
                                       torch.from_numpy(th_im),
                                       torch.from_numpy(fd),
                                       torch.from_numpy(t), taps)
    assert got.shape == (b, s, taps, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_jakes_gains_unit_power():
    """E|z|^2 = 1 per tap and symbol, over 4,096 frames of own draws."""
    fd = torch.full((4096,), 300.0)
    t = torch.arange(7, dtype=torch.float32) * (80 / 0.96e6)
    z = tdop.jakes_gains_iq(fd, t, 9, torch.Generator().manual_seed(0))
    power = float((z ** 2).sum(-1).mean())
    assert abs(power - 1.0) < 0.05
    per_tap = (z ** 2).sum(-1).mean((0, 1))
    assert float((per_tap - 1).abs().max()) < 0.1


@pytest.mark.parametrize("offsets", [[4, 4, 4, 4, 4], [0, 4, 6, 2, 4]])
def test_fir_per_symbol_iq_matches_jax(offsets, rng):
    b, s, n_sc, f, taps = 5, 4, 20, 13, 9
    tx = rng.normal(size=(b, s, n_sc, 2)).astype(np.float32)
    h = rng.normal(size=(b, s, f, 2)).astype(np.float32)
    off = np.asarray(offsets)
    want = jfir.fir_per_symbol_iq(jnp.asarray(tx), jnp.asarray(h), taps, off)
    got = tfir.fir_per_symbol_iq(torch.from_numpy(tx), torch.from_numpy(h),
                                 taps, off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _jax_draws(jch, key, b):
    """The static taps and Jakes phases the JAX channel draws from `key`
    (`rayleigh.py:137-141`, `doppler.py:78-83`)."""
    k_static, k_dop = jax.random.split(key)
    z = jax.random.normal(k_static, (b, jch.max_taps, 2),
                          dtype=jnp.float32) / np.sqrt(2.0)
    kr, ki = jax.random.split(k_dop)
    th = [jax.random.uniform(k, (b, jdop.SS, jch.max_taps), minval=0.0,
                             maxval=2 * np.pi, dtype=jnp.float32)
          for k in (kr, ki)]
    return np.array(z), [np.array(t) for t in th]


@pytest.mark.parametrize("channel,mix", [("etu", False), ("mixRayleigh", True),
                                         ("mixAll", True),
                                         ("mixRayleigh", False)])
def test_mobile_channel_matches_jax(channel, mix, rng):
    b, s, n_sc = 13, 7, 80
    jch = JChannel(channel, nfft=64, mobile=True, mix=mix)
    tch = TChannel(channel, nfft=64, mobile=True, mix=mix)
    assert tch.has_doppler == jch.has_doppler
    prof = jch._frame_profiles(b)
    np.testing.assert_array_equal(tch._frame_doppler_mask(b, prof),
                                  jch._frame_doppler_mask(b, prof))
    np.testing.assert_array_equal(tch._fd_np, jch._fd_np)
    tx = rng.normal(size=(b, s, n_sc, 2)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jch(key, jnp.asarray(tx))
    z, th = _jax_draws(jch, key, b)
    got = tch(torch.from_numpy(tx), zck=torch.from_numpy(z),
              theta=tuple(torch.from_numpy(t) for t in th))
    assert got.h_freq.shape == (b, s, 64, 2)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), atol=1e-5)
    np.testing.assert_allclose(got.h_freq.numpy(), np.asarray(want.h_freq),
                               atol=1e-5)


def test_mobile_channel_draws_from_generator():
    """Own draws: the same generator state gives the same frames, and a
    Doppler frame's H varies over the symbols while a static one's does
    not."""
    tch = TChannel("mixRayleigh", nfft=64, mobile=True, mix=True)
    tx = torch.randn(12, 7, 80, 2, generator=torch.Generator().manual_seed(1))
    outs = [tch(tx, torch.Generator().manual_seed(4)) for _ in range(2)]
    assert torch.equal(outs[0].y, outs[1].y)
    h = outs[0].h_freq
    spread = (h - h[:, :1]).abs().amax(dim=(1, 2, 3))
    mask = tch._frame_doppler_mask(12, tch._frame_profiles(12))
    assert mask.tolist() == [i % 3 == 0 for i in range(12)]
    assert bool((spread[torch.from_numpy(mask)] > 1e-3).all())
    assert bool((spread[torch.from_numpy(~mask)] == 0).all())


def test_partitioned_doppler_path_bit_equal_to_general_path(monkeypatch):
    """`_partition_doppler = True` on JAX's case
    (`tests/test_channel.py:264-290`: 12 x 7 x 80, mixRayleigh, mobile,
    mix): the static FIR runs on the 8 static rows only and `y` and
    `h_freq` are bit-equal to the general path's, and within 1e-5 of
    JAX's partitioned path on the same draws; 13 frames fall back to the
    general path (the static FIR on all 13 rows), bit-equal too."""
    rows = []
    same_iq = tfir.fir_same_iq
    monkeypatch.setattr(tfir, "fir_same_iq",
                        lambda x, *a: rows.append(x.shape[0])
                        or same_iq(x, *a))
    jch = JChannel("mixRayleigh", nfft=64, mobile=True, mix=True)
    tch = TChannel("mixRayleigh", nfft=64, mobile=True, mix=True)
    assert not tch._partition_doppler
    key = jax.random.PRNGKey(3)
    for b, static_rows in ((12, 8), (13, 13)):
        tx = np.array(jax.random.normal(jax.random.PRNGKey(4),
                                        (b, 7, 80, 2), jnp.float32))
        z, th = _jax_draws(jch, key, b)
        draws = dict(zck=torch.from_numpy(z),
                     theta=tuple(torch.from_numpy(t) for t in th))
        outs = {}
        for part in (True, False):
            tch._partition_doppler = part
            rows.clear()
            outs[part] = tch(torch.from_numpy(tx), **draws)
            assert rows == [static_rows if part else b]
        assert torch.equal(outs[True].y, outs[False].y)
        assert torch.equal(outs[True].h_freq, outs[False].h_freq)
        jch._partition_doppler = True
        want = jch(key, jnp.asarray(tx))
        np.testing.assert_allclose(outs[True].y.numpy(), np.asarray(want.y),
                                   atol=1e-5)
        np.testing.assert_allclose(outs[True].h_freq.numpy(),
                                   np.asarray(want.h_freq), atol=1e-5)
