"""The port's equalizer-stage op library and equalizer zoo against the JAX
package on the same numpy inputs: `frame_layer_norm`, `ComplexDense`
(vector, streams, no bias), `ComplexConv2d` (every mode, both recombines,
XLA's 'same' padding with even and odd kernels), `ComplexConvTranspose2d`
(strides 1 and 2), `equalize_iq` and its gradient, and `Equalizer` for
every registry id with JAX's init carried over by `params_from_flax`.

Tolerances: float32 on both sides with sums in other orders (XLA's against
PyTorch's convolutions and products), so 1e-5 of the output's scale for a
single layer and 1e-4 through the whole equalizer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.models import equalizers as jeq
from dl_ofdm_tpu.ops import complex_ops as jco
from dl_ofdm_tpu.ops.norms import frame_layer_norm as jfln
from dl_ofdm_tpu_torch.models import equalizers as teq
from dl_ofdm_tpu_torch.ops import complex_ops as tco
from dl_ofdm_tpu_torch.ops.norms import frame_layer_norm as tfln
from dl_ofdm_tpu_torch.train.checkpoint import params_from_flax


def _load(module, jparams):
    """JAX params -> the torch module (strict: every name maps)."""
    module.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                         jparams)),
                           strict=True)
    return module


def _perturbed_init(jmod, x, rng):
    """JAX's init with the zero biases made nonzero, so they are tested."""
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(
            np.float32), params)


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("shape", [(4, 7, 80, 2), (3, 5, 2)])
def test_frame_layer_norm_matches_jax(shape, rng):
    x = (3.0 * rng.normal(size=shape) + 0.5).astype(np.float32)
    _close(tfln(torch.from_numpy(x)), jfln(jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("mode,recombine,use_bias", [
    ("vector", "true", True), ("streams", "true", True),
    ("exact", "true", False), ("exact", "reference", False),
    ("exact", "reference", True)])
def test_complex_dense_modes_match_jax(mode, recombine, use_bias, rng):
    x = rng.normal(size=(3, 5, 12, 2)).astype(np.float32)
    jmod = jco.ComplexDense(9, mode=mode, recombine=recombine,
                            use_bias=use_bias)
    params = _perturbed_init(jmod, x, rng)
    tmod = _load(tco.ComplexDense(12, 9, mode=mode, recombine=recombine,
                                  use_bias=use_bias), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    _close(tmod(torch.from_numpy(x)), want, 1e-5)


CONV_CASES = [("exact", "true"), ("exact", "reference"), ("vector", "true"),
              ("streams", "true")]


@pytest.mark.parametrize("mode,recombine", CONV_CASES)
@pytest.mark.parametrize("hw,kernel,c,f", [
    ((7, 64), (7, 64), 1, 1),      # the arms' block conv: even kernel width
    ((6, 9), (3, 5), 2, 3)])       # odd kernel, channels in and out
def test_complex_conv2d_matches_jax(mode, recombine, hw, kernel, c, f, rng):
    x = rng.normal(size=(2, *hw, c, 2)).astype(np.float32)
    jmod = jco.ComplexConv2d(f, kernel, padding="same", mode=mode,
                             recombine=recombine)
    params = _perturbed_init(jmod, x, rng)
    tmod = _load(tco.ComplexConv2d(c, f, kernel, padding="same", mode=mode,
                                   recombine=recombine), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5)


def test_complex_conv2d_valid_and_squeeze_match_jax(rng):
    x = rng.normal(size=(2, 6, 9, 2)).astype(np.float32)    # one channel
    jmod = jco.ComplexConv2d(1, (2, 4), padding="valid", use_bias=False)
    params = _perturbed_init(jmod, x, rng)
    tmod = _load(tco.ComplexConv2d(1, 1, (2, 4), padding="valid",
                                   use_bias=False), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 5, 6, 2)
    _close(got, want, 1e-5)


def test_same_pads_follow_xla():
    # 63 = 64 - 1 of the (7, 64) kernel: 31 before, 32 after
    assert tco.same_pads(64, 64) == (31, 32)
    assert tco.same_pads(7, 7) == (3, 3)
    assert tco.same_pads(9, 4) == (1, 2)


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
@pytest.mark.parametrize("kernel", [(3, 3), (2, 4)])
def test_complex_conv_transpose2d_matches_jax(strides, kernel, rng):
    x = rng.normal(size=(2, 5, 6, 2, 2)).astype(np.float32)
    jmod = jco.ComplexConvTranspose2d(3, kernel, strides=strides)
    params = _perturbed_init(jmod, x, rng)
    tmod = _load(tco.ComplexConvTranspose2d(2, 3, kernel, strides=strides),
                 params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5)


def test_complex_conv_transpose2d_valid_matches_jax(rng):
    x = rng.normal(size=(2, 4, 5, 2)).astype(np.float32)
    jmod = jco.ComplexConvTranspose2d(1, (3, 2), strides=(2, 3),
                                      padding="valid")
    params = _perturbed_init(jmod, x, rng)
    tmod = _load(tco.ComplexConvTranspose2d(1, 1, (3, 2), strides=(2, 3),
                                            padding="valid"), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("eq_div,stopgrad", [("phase", False), ("zf", False),
                                             ("zf", True)])
def test_equalize_iq_and_its_gradient_match_jax(eq_div, stopgrad, rng):
    y = rng.normal(size=(3, 4, 8, 2)).astype(np.float32)
    h = rng.normal(size=(3, 4, 8, 2)).astype(np.float32)
    w = rng.normal(size=(3, 4, 8, 2)).astype(np.float32)

    def jloss(yv, hv):
        return jnp.sum(jeq.equalize_iq(yv, hv, eq_div, 0.1, stopgrad) * w)

    want = jeq.equalize_iq(jnp.asarray(y), jnp.asarray(h), eq_div, 0.1,
                           stopgrad)
    gy, gh = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y), jnp.asarray(h))
    ty = torch.from_numpy(y).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    got = teq.equalize_iq(ty, th, eq_div, 0.1, stopgrad)
    _close(got, want, 1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    _close(ty.grad, gy, 1e-4)
    _close(th.grad, gh, 1e-4)


# a narrow equalizer: 16 subcarriers, 4 of CP, 3 symbols, 4 pilots
SMALL = dict(nfft=16, cp_len=4, nsymbol=3, pilot_size=4,
             pilot_carriers=(1, 5, 9, 13))


@pytest.mark.parametrize("opt", sorted(jeq.EQUALIZER_REGISTRY))
def test_equalizer_matches_jax_for_every_registry_id(opt, rng):
    spec = jeq.EQUALIZER_REGISTRY[opt]
    assert teq.EQUALIZER_REGISTRY[opt] == teq.EqSpec(
        **{f: getattr(spec, f) for f in spec.__dataclass_fields__})
    x = rng.normal(size=(5, 3, 20, 2)).astype(np.float32)
    jmod = jeq.Equalizer(spec=spec, **SMALL)
    params = _perturbed_init(jmod, x, rng)
    tmod = _load(teq.Equalizer(spec=teq.EQUALIZER_REGISTRY[opt], **SMALL),
                 params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    for name, a, b in zip(("equalized", "snr_db", "chest"), got, want):
        assert tuple(a.shape) == b.shape, name
        _close(a, b, 1e-4)


def test_equalizer_without_cp_matches_jax(rng):
    spec = jeq.EQUALIZER_REGISTRY[0]
    x = rng.normal(size=(4, 3, 20, 2)).astype(np.float32)
    jmod = jeq.Equalizer(spec=spec, keep_cp=False, **SMALL)
    params = _perturbed_init(jmod, x, rng)
    tmod = _load(teq.Equalizer(spec=teq.EQUALIZER_REGISTRY[0], keep_cp=False,
                               **SMALL), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    for a, b in zip(tmod(torch.from_numpy(x)), want):
        _close(a, b, 1e-4)


def test_equalizer_init_is_flax_like():
    """Every Dense kernel lecun-normal at its fan-in, every bias zero."""
    eq = teq.Equalizer(spec=teq.EQUALIZER_REGISTRY[12], nfft=64, cp_len=16,
                       nsymbol=7, pilot_size=16,
                       pilot_carriers=(7, 13, 19, 25, 33, 39, 45, 51))
    eq.reset_parameters(torch.Generator().manual_seed(1))
    for name, v in eq.state_dict().items():
        if name.endswith(("bias", ".br", ".bi", ".b")):
            assert torch.count_nonzero(v) == 0, name
    w = eq.Dense_block0.weight.detach()
    assert abs(float(w.std()) * 896 ** 0.5 - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 * (1 / 896) ** 0.5 / 0.87962566 + 1e-7
