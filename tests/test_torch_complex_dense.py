"""The port's `complex_dense` (plain version, autograd wrapper) and
`ComplexDense` against the JAX package's Pallas `complex_dense`, run as the
JAX tests run it on the CPU (interpret mode).  The CUDA kernel itself is
held against the plain version on the card by `tests/test_torch_cuda.py`
and `chip_smoke.py`."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.ops import complex_ops as jops
from dl_ofdm_tpu.ops import pallas_kernels as jpk
from dl_ofdm_tpu_torch.ops import complex_ops as tops
from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk

SHAPES = [(24, 80, 64), (37, 77, 50), (7, 16, 4)]


def _inputs(rng, m, k, f):
    x = rng.normal(size=(m, k, 2)).astype(np.float32)
    wr = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)
    wi = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)
    return x, wr, wi


@pytest.mark.parametrize("m,k,f", SHAPES)
def test_forward_matches_pallas(m, k, f, rng):
    x, wr, wi = _inputs(rng, m, k, f)
    yr, yi = jpk.complex_dense(jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1]),
                               jnp.asarray(wr), jnp.asarray(wi))
    want = np.stack([np.asarray(yr), np.asarray(yi)], -1)
    args = [torch.from_numpy(a) for a in (x, wr, wi)]
    np.testing.assert_allclose(tpk.complex_dense_ref(*args).numpy(), want,
                               atol=1e-5)
    np.testing.assert_allclose(tpk.complex_dense(*args).numpy(), want,
                               atol=1e-5)


@pytest.mark.parametrize("m,k,f", SHAPES)
def test_vjp_matches_pallas(m, k, f, rng):
    x, wr, wi = _inputs(rng, m, k, f)
    g = rng.normal(size=(m, f, 2)).astype(np.float32)
    _, vjp = jax.vjp(jpk.complex_dense, jnp.asarray(x[..., 0]),
                     jnp.asarray(x[..., 1]), jnp.asarray(wr), jnp.asarray(wi))
    dxr, dxi, dwr, dwi = map(np.asarray, vjp((jnp.asarray(g[..., 0]),
                                              jnp.asarray(g[..., 1]))))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, wr, wi)]
    tpk.complex_dense(*args).backward(torch.from_numpy(g))
    np.testing.assert_allclose(args[0].grad.numpy(),
                               np.stack([dxr, dxi], -1), atol=1e-5)
    np.testing.assert_allclose(args[1].grad.numpy(), dwr, atol=1e-5)
    np.testing.assert_allclose(args[2].grad.numpy(), dwi, atol=1e-5)


def test_leading_axes_pass_through(rng):
    x, wr, wi = _inputs(rng, 3 * 7, 80, 64)
    xt = torch.from_numpy(x).reshape(3, 7, 80, 2)
    y = tpk.complex_dense(xt, torch.from_numpy(wr), torch.from_numpy(wi))
    assert y.shape == (3, 7, 64, 2)
    want = jpk.complex_dense_iq(jnp.asarray(x.reshape(3, 7, 80, 2)),
                                jnp.asarray(wr), jnp.asarray(wi))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5)


def test_kernel_wrapper_takes_only_cuda_tensors(rng):
    """No fallback: the kernel's wrapper refuses a CPU tensor instead of
    computing the plain version, and launches nothing."""
    x, wr, wi = (torch.from_numpy(a) for a in _inputs(rng, 4, 8, 4))
    before = tpk.complex_dense_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpk.complex_dense_kernel(x, wr, wi)
    assert tpk.complex_dense_kernel.launches == before


@pytest.mark.parametrize("recombine", ["true", "reference"])
def test_complex_dense_layer_matches_flax(recombine, rng):
    x = rng.normal(size=(2, 7, 80, 2)).astype(np.float32)
    layer = jops.ComplexDense(64, recombine=recombine)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # non-zero biases, so their signs are checked too
    params = {n: (v if n in ("wr", "wi") else
                  jnp.asarray(rng.normal(size=v.shape).astype(np.float32)))
              for n, v in params.items()}
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    mod = tops.ComplexDense(80, 64, recombine=recombine)
    assert set(dict(mod.named_parameters())) == set(params)
    mod.load_state_dict({n: torch.tensor(np.asarray(v))
                         for n, v in params.items()})
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_complex_dense_layer_init_scale():
    """lecun_normal as flax initializes it: fan-in variance."""
    mod = tops.ComplexDense(80, 64)
    std = float(torch.cat([mod.wr.flatten(), mod.wi.flatten()]).detach().std())
    assert abs(std - (1 / 80) ** 0.5) < 0.1 * (1 / 80) ** 0.5
    flax_w = fnn.initializers.lecun_normal()(jax.random.PRNGKey(0), (80, 64))
    assert abs(float(jnp.std(flax_w)) - (1 / 80) ** 0.5) < 0.1 * (1 / 80) ** 0.5
