"""The port's complex-dtype wrappers against the JAX package's, on the CPU:
`to_complex` / `from_complex` and the `complex_ops` aliases, the complex64
`const_table`, the complex TX oracle (`ofdm_modulate_frames`, `iq_split`,
`iq_join`, `OFDMTx`) on the cases of `tests/test_plan_tx.py`, and
`jakes_gains` and `RayleighChannel.apply_complex` on JAX's own draws (the
cases of `tests/test_channel.py:115-180`).  Tolerances: the TX at
atol 1e-5; the channel at atol 1e-5, as `tests/test_torch_channel.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel import doppler as jdop
from dl_ofdm_tpu.channel.rayleigh import RayleighChannel as JChannel
from dl_ofdm_tpu.config import OFDMConfig as JCfg
from dl_ofdm_tpu.ofdm import constellation as jcon
from dl_ofdm_tpu.ofdm import tx as jtx
from dl_ofdm_tpu.ofdm.plan import build_plan as jplan
from dl_ofdm_tpu.ops import cfloat as jcf
from dl_ofdm_tpu.ops import complex_ops as jops
from dl_ofdm_tpu_torch.channel import doppler as tdop
from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel as TChannel
from dl_ofdm_tpu_torch.config import OFDMConfig
from dl_ofdm_tpu_torch.ofdm import constellation as tcon
from dl_ofdm_tpu_torch.ofdm import tx as ttx
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.ops import cfloat as tcf
from dl_ofdm_tpu_torch.ops import complex_ops as tops


def test_to_and_from_complex_match_jax(rng):
    x = rng.normal(size=(3, 5, 2)).astype(np.float32)
    want = np.asarray(jcf.to_complex(jnp.asarray(x)))
    got = tcf.to_complex(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)
    back = tcf.from_complex(got)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jcf.from_complex(want)))
    np.testing.assert_array_equal(back.numpy(), x)
    # a complex128 input is pinned to float32 pairs, as JAX's is
    c = (x[..., 0] + 1j * x[..., 1]).astype(np.complex128)
    assert tcf.from_complex(torch.from_numpy(c)).dtype == torch.float32


def test_complex_ops_aliases_are_cfloat_functions(rng):
    assert tops.complex_mul is tcf.cmul_iq
    assert tops.complex_to_iq is tcf.from_complex
    assert tops.iq_to_complex is tcf.to_complex
    a, b = (rng.normal(size=(4, 2)).astype(np.float32) for _ in range(2))
    want = np.asarray(jops.complex_mul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(
        tops.complex_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        want, atol=1e-6)


@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
def test_const_table_is_jax_complex64(nbits):
    got = tcon.const_table(nbits)
    want = np.asarray(jcon.const_table(nbits))
    assert got.dtype == torch.complex64 and want.dtype == np.complex64
    np.testing.assert_array_equal(got.numpy(), want)
    iq = tcon.const_table_iq(nbits)
    np.testing.assert_array_equal(tcf.to_complex(iq).numpy(), want)


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("longcp", [True, False])
def test_ofdm_modulate_frames_matches_jax(nbits, longcp, rng):
    plan, jp = (build_plan(OFDMConfig(nbits=nbits, longcp=longcp)),
                jplan(JCfg(nbits=nbits, longcp=longcp)))
    bits = rng.integers(0, 2, (6, plan.frame_size, nbits)).astype(np.int32)
    want = np.asarray(jtx.ofdm_modulate_frames(jnp.asarray(bits), jp))
    got = ttx.ofdm_modulate_frames(torch.from_numpy(bits), plan)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    iq = ttx.iq_split(got)
    np.testing.assert_allclose(iq.numpy(), np.asarray(jtx.iq_split(want)),
                               atol=1e-5)
    np.testing.assert_array_equal(ttx.iq_join(iq).numpy(), got.numpy())
    # the real-pair modulator of the port's paths agrees with its oracle
    np.testing.assert_allclose(
        ttx.ofdm_modulate_frames_iq(torch.from_numpy(bits), plan).numpy(),
        iq.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="frame_size"):
        ttx.ofdm_modulate_frames(torch.from_numpy(bits[:, 1:]), plan)


@pytest.mark.parametrize("cfg", [dict(nbits=2), dict(nsymbol=8, npilot=8,
                                                     nguard=8,
                                                     pilot="scattered"),
                                 dict(nfft=128)])
def test_ofdm_tx_class_matches_jax(cfg, rng):
    jt, tt = jtx.OFDMTx(JCfg(**cfg)), ttx.OFDMTx(OFDMConfig(**cfg))
    assert tt.plan.frame_size == jt.plan.frame_size
    bits = rng.integers(0, 2, (3, tt.plan.frame_size, tt.cfg.nbits)
                        ).astype(np.int32)
    jwf, jiq = jt(jnp.asarray(bits))
    wf, iq = tt(torch.from_numpy(bits))
    np.testing.assert_allclose(wf.numpy(), np.asarray(jwf), atol=1e-5)
    np.testing.assert_allclose(iq.numpy(), np.asarray(jiq), atol=1e-5)


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
    return torch.from_numpy(np.array(z)), tuple(torch.from_numpy(np.array(t))
                                                for t in th)


def test_jakes_gains_match_jax_on_its_phases():
    """`test_channel.py::test_jakes_gains_match_reference_equations`'s case:
    fd 70 Hz, 9 taps, 7 symbols, JAX's key 5."""
    fd, n_taps, s = 70.0, 9, 7
    key = jax.random.PRNGKey(5)
    t = np.arange(s, dtype=np.float32) * np.float32(80 / 0.96e6)
    want = np.asarray(jdop.jakes_gains(key, jnp.asarray([fd]),
                                       jnp.asarray(t), n_taps))
    kr, ki = jax.random.split(key)
    theta = tuple(torch.from_numpy(np.array(jax.random.uniform(
        k, (1, jdop.SS, n_taps), minval=0.0, maxval=2 * np.pi)))
        for k in (kr, ki))
    got = tdop.jakes_gains(torch.tensor([fd]), torch.from_numpy(t), n_taps,
                           theta=theta)
    assert got.dtype == torch.complex64 and got.shape == (1, s, n_taps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    own = tdop.jakes_gains(torch.tensor([fd]), torch.from_numpy(t), n_taps,
                           torch.Generator().manual_seed(0))
    assert own.shape == (1, s, n_taps) and torch.isfinite(
        torch.view_as_real(own)).all()


@pytest.mark.parametrize("channel,key,shape,mobile", [
    ("awgn", 1, (4, 7, 80), False),       # test_awgn_channel_passthrough
    ("etu", 2, (8, 7, 80), False),        # test_static_rayleigh_ht_is_...
    ("epa", 3, (64, 1, 80), False),       # test_rayleigh_tap_statistics
    ("mixAll", 4, (10, 7, 80), False),    # test_mix_all_has_awgn_...
    ("etu", 6, (3, 7, 80), True),         # test_mobile_single_channel_...
])
def test_apply_complex_matches_jax_on_its_draws(channel, key, shape, mobile,
                                                rng):
    b = shape[0]
    jch = JChannel(channel, nfft=64, mobile=mobile)
    tch = TChannel(channel, nfft=64, mobile=mobile)
    tx = (rng.normal(size=shape) + 1j * rng.normal(size=shape)
          ).astype(np.complex64)
    k = jax.random.PRNGKey(key)
    want = jch.apply_complex(k, jnp.asarray(tx))
    z, th = _jax_draws(jch, k, b)
    got = tch.apply_complex(torch.from_numpy(tx), zck=z, theta=th)
    assert got.y.dtype == torch.complex64
    assert got.h_freq.dtype == torch.complex64
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), atol=1e-5)
    np.testing.assert_allclose(got.h_freq.numpy(), np.asarray(want.h_freq),
                               atol=1e-5)
