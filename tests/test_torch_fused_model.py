"""The port's fused DCCN gradient (`dl_ofdm_tpu_torch/ops/fused_model.py`)
against the JAX package: its plain version against JAX's
`dccn_fused_grads` (Pallas interpret mode, fuse_norm=True) at nbits 1 with
bfloat16 GEMM inputs and nbits 4 in float32, and against JAX's autodiff of
the flax model (float32) at nbits 1-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.ops import fused_model as jfm
from dl_ofdm_tpu.train import metrics as JM
from dl_ofdm_tpu.train.loop import Trainer as JTrainer
from dl_ofdm_tpu_torch.ops import fused_model as tfm
from dl_ofdm_tpu_torch.train.checkpoint import params_from_flax

S, P, F, D = 7, 80, 64, 320


def _case(nbits, n, seed):
    """Flax params (init plus noise, so no gradient is structurally zero),
    raw planes, an affine and symbol indices, all from numpy."""
    rng = np.random.default_rng(seed)
    jt = JTrainer(JCfg(nbits=nbits), JTc(batch_size=8), channel="AWGN")
    params = jt.init_state(jax.random.PRNGKey(seed)).params
    params = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.normal(
        size=v.shape).astype(np.float32), params)
    planes = [rng.normal(size=(n, S * P)).astype(np.float32)
              for _ in range(4)]
    c = rng.uniform(0.5, 1.5, size=(6, S * P)).astype(np.float32)
    c[2] *= 0.1
    c[5] *= 0.1
    idx = rng.integers(0, 2 ** nbits, size=(n, D)).astype(np.int32)
    return jt, params, planes, c, idx


def _port(nbits, n, params, planes, c, idx, dtype="float32"):
    spec = tfm.ModelSpec(nsymbol=S, sps=P, nfilter=F, frame_size=D,
                         nbits=nbits, matmul_dtype=dtype)
    tparams = params_from_flax(params)
    t = [torch.from_numpy(a) for a in planes]
    return tfm.dccn_fused_grads(spec, n, tparams, *t, torch.from_numpy(c),
                                torch.from_numpy(idx))


def _assert_grads(got, want_flax, rtol, atol, leaf_tol=None):
    """Elementwise rtol/atol, or with `leaf_tol` max |diff| <= leaf_tol *
    max |want| per leaf (bfloat16: one input rounding the other way moves
    an entry by a bf16 ulp of its largest summand)."""
    want = params_from_flax(jax.tree.map(np.asarray, want_flax))
    assert set(got) == set(want) == set(tfm.PARAM_KEYS)
    for k in tfm.PARAM_KEYS:
        assert got[k].shape == want[k].shape, k
        if leaf_tol is None:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)
        else:
            diff = float((got[k] - want[k]).abs().max())
            assert diff <= leaf_tol * float(want[k].abs().max()), k


@pytest.mark.parametrize("nbits,n,dtype", [(1, 12, "bfloat16"),
                                           (4, 9, "float32")])
def test_plain_version_matches_jax_kernel(nbits, n, dtype):
    """Gradients in the state_dict layout, CE and counts against the TPU
    kernel run by the Pallas interpreter, with its GEMM inputs rounded to
    bfloat16 or not, at the head's smallest and largest width."""
    _, params, planes, c, idx = _case(nbits, n, seed=nbits)
    jspec = jfm.ModelSpec(nsymbol=S, sps=P, nfilter=F, frame_size=D,
                          nbits=nbits, block=16, fuse_norm=True,
                          matmul_dtype=dtype)
    jg, jce, jconf = jfm.dccn_fused_grads(
        jspec, n, jax.tree.map(jnp.asarray, params),
        *map(jnp.asarray, planes), jnp.asarray(c), jnp.asarray(idx))
    grads, ce, conf = _port(nbits, n, params, planes, c, idx, dtype)
    if dtype == "float32":
        _assert_grads(grads, jg, rtol=2e-4, atol=1e-7)
    else:
        _assert_grads(grads, jg, None, None, leaf_tol=1e-3)
        # the rounding is there: float32 products miss JAX's bf16 kernel
        g32 = _port(nbits, n, params, planes, c, idx)[0]
        with pytest.raises(AssertionError):
            _assert_grads(g32, jg, None, None, leaf_tol=1e-2)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))


def _oracle(jt, params, planes, c, idx, nbits):
    """jax.grad of the flax model's CE on the normalized planes."""
    n = idx.shape[0]
    xr = planes[0] * c[0] + planes[2] * c[1] - c[2]
    xi = planes[1] * c[3] + planes[3] * c[4] - c[5]
    rx = jnp.asarray(np.stack([xr, xi], -1).reshape(n, S, P, 2))
    shifts = np.arange(nbits - 1, -1, -1)
    bits = jnp.asarray(((idx[..., None] >> shifts) & 1).astype(np.int32))

    def ce_fn(p):
        return JM.cross_entropy(jt.model.apply({"params": p}, rx)[0], bits)

    jparams = jax.tree.map(jnp.asarray, params)
    ce, grads = jax.value_and_grad(ce_fn)(jparams)
    logits = jt.model.apply({"params": jparams}, rx)[0]
    conf = JM.confusion_matrix(bits, JM.bit_predictions(logits))
    return ce, grads, conf


@pytest.mark.parametrize("nbits", [1, 2, 3])
def test_plain_version_matches_jax_autodiff(nbits):
    jt, params, planes, c, idx = _case(nbits, 10, seed=10 + nbits)
    ce_ref, g_ref, conf_ref = _oracle(jt, params, planes, c, idx, nbits)
    grads, ce, conf = _port(nbits, 10, params, planes, c, idx)
    _assert_grads(grads, g_ref, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(float(ce), float(ce_ref), rtol=1e-5)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(conf_ref))


def test_reg_grads_match_jax():
    _, params, _, _, _ = _case(2, 1, seed=5)
    ber = 0.125
    want = jfm.reg_grads(jax.tree.map(jnp.asarray, params),
                         jnp.float32(ber), 1e-4)
    got = tfm.reg_grads(params_from_flax(params), torch.tensor(ber), 1e-4)
    _assert_grads(got, want, rtol=1e-6, atol=0)


def test_spec_validation():
    with pytest.raises(ValueError):
        tfm.ModelSpec(nsymbol=S, sps=P, nfilter=F, frame_size=D, nbits=1,
                      matmul_dtype="float16")
    with pytest.raises(ValueError):
        tfm.ModelSpec(nsymbol=S, sps=P, nfilter=F, frame_size=D, nbits=5)
