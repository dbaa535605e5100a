"""The port's bf16 unit noise against the JAX package's.

`jax.random.normal(key, shape, bfloat16)`, which `awgn_channel` draws
(`dl_ofdm_tpu/channel/awgn.py:33`), is a lookup of 7 of each value's 8
random bits in a table of 128 bf16 values.  The port builds that table with
bf16 arithmetic and draws 7 uniform bits a value from its generator
(`dl_ofdm_tpu_torch/channel/awgn.py`).  Fed JAX's own words
(`jax.random.bits(key, shape, uint8)`), it gives JAX's normals bit for bit;
from the port's generator, draws with the table's moments (held within 6
standard errors of the sample moments) and no value beyond 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel import awgn as jawgn
from dl_ofdm_tpu_torch.channel import awgn as tawgn

N_WORDS = 1 << 18          # draws a key; four keys make 1 M


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_table_lookup_of_jax_words_is_jax_normal(seed):
    key = jax.random.PRNGKey(seed)
    shape = (N_WORDS // 512, 256, 2)
    words = np.array(jax.random.bits(key, shape, jnp.uint8))
    want = np.asarray(jax.random.normal(key, shape, jnp.bfloat16))
    got = tawgn.bf16_normal_from_words(torch.from_numpy(words))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits16(got), want.view(np.uint16))


def test_table_has_jax_128_values():
    table = tawgn.bf16_normal_table()
    assert table.dtype == torch.bfloat16 and table.shape == (128,)
    assert table.unique().numel() == 128
    assert torch.all(table[1:] > table[:-1])       # increasing in the bits
    assert float(table[0]) == -2.890625 and float(table[-1]) == 2.515625
    # every value jax draws is one of the table's, and each is drawn
    key = jax.random.PRNGKey(11)
    drawn = np.unique(np.asarray(jax.random.normal(key, (N_WORDS,),
                                                   jnp.bfloat16))
                      .view(np.uint16))
    np.testing.assert_array_equal(drawn, np.sort(_bits16(table)))


def test_table_needs_bf16_arithmetic():
    """The same steps in float32, rounded to bf16 once at the end, give
    another table: what the docstring's "bf16 arithmetic" rules out."""
    lo = tawgn.BF16_NORMAL_LO
    f = torch.arange(128, dtype=torch.float32) / 128
    u = torch.clamp(f * (1 - lo) + lo, min=lo)
    once = (2 ** 0.5 * torch.special.erfinv(u)).to(torch.bfloat16)
    assert not torch.equal(once, tawgn.bf16_normal_table())


def _moments(z: np.ndarray):
    z = z.astype(np.float64)
    m = z.mean()
    v = ((z - m) ** 2).mean()
    return m, v, ((z - m) ** 4).mean() / v ** 2


def test_generator_draws_have_jax_moments():
    n = 1 << 21
    g = torch.Generator().manual_seed(5)
    got = tawgn.bf16_normal((n,), "cpu", g).float().numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (n,),
                                        jnp.bfloat16).astype(jnp.float32))
    table = tawgn.bf16_normal_table().double().numpy()
    tm, tv, tk = _moments(table)       # the draws' exact moments
    for z in (got, want):
        m, v, k = _moments(z)
        assert abs(m - tm) < 6 * np.sqrt(tv / n)
        assert abs(v - tv) < 6 * tv * np.sqrt((tk - 1) / n)
        assert abs(k - tk) < 0.05
        assert np.abs(z).max() <= 2.890625 < 3
    assert abs(tm + 0.0120) < 1e-4 and abs(tv - 0.99417) < 1e-4
    # each of the 128 values about equally often (chi-square, 127 dof)
    counts = np.unique(got, return_counts=True)[1]
    assert counts.size == 128
    chi2 = ((counts - n / 128) ** 2 / (n / 128)).sum()
    assert chi2 < 127 + 6 * np.sqrt(2 * 127)


def test_awgn_channel_draws_through_the_table(rng):
    x = torch.from_numpy(rng.normal(size=(16, 7, 80, 2)).astype(np.float32))
    snr = torch.zeros(16)
    table = set(tawgn.bf16_normal_table().float().tolist())
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        y, _ = tawgn.awgn_channel(x, snr, g)
        outs.append(y)
        g2 = torch.Generator().manual_seed(3)
        unit = tawgn.bf16_normal(x.shape, "cpu", g2).float()
        assert set(unit.unique().tolist()) <= table
        x_norm = x * torch.rsqrt((x ** 2).sum(-1).mean())
        torch.testing.assert_close(y, x_norm + np.sqrt(0.5) * unit,
                                   atol=1e-6, rtol=1e-6)
    assert torch.equal(outs[0], outs[1])
    # a float32 noise_dtype keeps torch's Gaussian draws
    g = torch.Generator().manual_seed(3)
    y32, _ = tawgn.awgn_channel(x, snr, g, noise_dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    torch.testing.assert_close(
        y32, x * torch.rsqrt((x ** 2).sum(-1).mean())
        + np.sqrt(0.5) * torch.randn(x.shape, generator=g),
        atol=1e-6, rtol=1e-6)


def test_awgn_channel_matches_jax_from_the_same_words(rng):
    """`awgn_channel` on the unit noise of JAX's words equals JAX's
    `awgn_channel` with that key; `unit_noise=` is used as given."""
    x = rng.normal(size=(12, 7, 80, 2)).astype(np.float32)
    snr = np.linspace(-5, 25, 12).astype(np.float32)
    key = jax.random.PRNGKey(21)
    y_j, p_j = jawgn.awgn_channel(key, jnp.asarray(x), jnp.asarray(snr))
    words = torch.from_numpy(np.array(jax.random.bits(key, x.shape,
                                                      jnp.uint8)))
    y_t, p_t = tawgn.awgn_channel(
        torch.from_numpy(x), torch.from_numpy(snr),
        unit_noise=tawgn.bf16_normal_from_words(words))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(float(p_t), float(p_j), rtol=1e-5)
