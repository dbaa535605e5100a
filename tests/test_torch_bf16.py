"""The port's bf16 receiver (`compute_dtype='bfloat16'`) against the JAX
package's: `complex_dense`'s bf16 mode (plain version) against the Pallas
kernel fed bf16 operands (interpret mode, as the JAX tests run it), its
backward pass against the kernel's VJP through the `astype` casts,
`DCCNReceiver` at nfft 64 and the committed nfft-512 arm, one autograd
training step's gradients, and the trainer's route gate.

Tolerances: where both sides sum the same exact products in float32
(bf16 operands) and only the order differs, 1e-5; a result rounded to
bf16 after such a sum may land one bf16 ulp (at most 2^-7 of the value)
apart, so the backward pass is held to one ulp, and near zero to the
float32 sum's own error (1e-5 of the largest entry).  The DCCN rounds to bf16 after
each Dense layer, so where a sum order flips one rounding the logits
move by a bf16 ulp: they are held to 3e-3 of their largest magnitude,
with at least 99 % of them bit-equal (the float32 model misses both:
6e-3 and none equal); gradients to 1e-2 of each leaf's largest entry
(JAX rounds each of `ComplexDense`'s four products' cotangents, the port
and `_cdense_bwd` their sums; bias gradients sum bf16 values in another
precision), with at least 90 % of all entries bit-equal."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.config import OFDMConfig as JCfg, TrainConfig as JTc
from dl_ofdm_tpu.models.dccn import DCCNReceiver as JRx
from dl_ofdm_tpu.ofdm.plan import build_plan
from dl_ofdm_tpu.ops import pallas_kernels as jpk
from dl_ofdm_tpu.train.loop import Trainer as JTrainer
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver as TRx
from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk
from dl_ofdm_tpu_torch.ops.complex_ops import ComplexDense
from dl_ofdm_tpu_torch.ops.norms import leaky_relu
from dl_ofdm_tpu_torch.train import checkpoint as tckpt
from dl_ofdm_tpu_torch.train.loop import Trainer

BF = jnp.bfloat16
ARM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "runs", "arms", "OFDM_Big512_1mod.npz")


def _inputs(rng, m, k, f):
    x = rng.normal(size=(m, k, 2)).astype(np.float32)
    wr = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)
    wi = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)
    return x, wr, wi


def _jax_cdense_bf16(x, wr, wi):
    """JAX's bf16 Pallas call as `ComplexDense` makes it: f32 values cast
    to bf16, the kernel, its custom VJP, the casts' VJPs."""
    yr, yi = jpk.complex_dense(x[..., 0].astype(BF), x[..., 1].astype(BF),
                               wr.astype(BF), wi.astype(BF))
    return jnp.stack([yr, yi], -1)


@pytest.mark.parametrize("m,k,f", [(24, 80, 64), (37, 77, 50)])
def test_bf16_complex_dense_matches_pallas(m, k, f, rng):
    x, wr, wi = _inputs(rng, m, k, f)
    want = np.asarray(_jax_cdense_bf16(*map(jnp.asarray, (x, wr, wi))))
    args = [torch.from_numpy(a) for a in (x, wr, wi)]
    for got in (tpk.complex_dense_ref(*args, "bfloat16"),
                tpk.complex_dense(*args, "bfloat16")):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # rounding is what the mode adds: float32 operands differ by far more
    assert np.abs(tpk.complex_dense_ref(*args).numpy() - want).max() > 1e-3


@pytest.mark.parametrize("m,k,f", [(24, 80, 64), (37, 77, 50), (9, 1, 3),
                                   (16, 640, 40)])
def test_stacked_weight_times_x_is_the_bf16_mode(m, k, f, rng):
    """The bf16 kernel's one real GEMM: x read as [M, 2K], rounded to
    bf16, times the packed weight (`pack_stacked_weight_ref`, W_s stored
    transposed) is y read as [M, 2F], against the plain version and JAX's
    Pallas `complex_dense` fed bf16 operands (interpret mode), to 1e-5;
    the pitch's padding adds nothing."""
    x, wr, wi = _inputs(rng, m, k, f)
    ws = tpk.pack_stacked_weight_ref(torch.from_numpy(wr),
                                     torch.from_numpy(wi))
    a = tpk.bf16_round(torch.from_numpy(x).reshape(m, 2 * k))
    pad = torch.nn.functional.pad(a, (0, ws.shape[1] - 2 * k), value=1.0)
    for xa, w in ((a, ws[:, :2 * k]), (pad, ws)):
        got = (xa.double() @ w.double().T).float().reshape(m, f, 2)
        want = np.asarray(_jax_cdense_bf16(*map(jnp.asarray, (x, wr, wi))))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(
            got, tpk.complex_dense_ref(*(torch.from_numpy(t_) for t_ in
                                         (x, wr, wi)), "bfloat16"),
            atol=1e-5, rtol=1e-5)


def test_bf16_complex_dense_gradients_match_pallas_vjp(rng):
    x, wr, wi = _inputs(rng, 30, 48, 20)
    g = rng.normal(size=(30, 20, 2)).astype(np.float32)
    _, vjp = jax.vjp(_jax_cdense_bf16, *map(jnp.asarray, (x, wr, wi)))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, wr, wi)]
    tpk.complex_dense(*ts, "bfloat16").backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        got = t.grad.numpy()
        assert got.dtype == np.float32
        # every entry a bf16 value, as JAX's cotangents are
        np.testing.assert_array_equal(got, tpk.bf16_round(t.grad).numpy())
        np.testing.assert_allclose(got, w, rtol=2 ** -7,
                                   atol=1e-5 * np.abs(w).max())


def test_leaky_relu_bf16_rounds_as_jax(rng):
    x = rng.normal(size=4096).astype(np.float32) * 10
    want = np.asarray(jax.nn.leaky_relu(jnp.asarray(x).astype(BF),
                                        negative_slope=0.2).astype(
                                            jnp.float32))
    got = leaky_relu(torch.from_numpy(x).to(torch.bfloat16)).float()
    np.testing.assert_array_equal(got.numpy(), want)


def test_complex_dense_layer_modes_under_bf16(rng):
    """'exact' 'true' and 'reference' round their operands; 'vector' and
    'streams' ignore the flag, as JAX's `ComplexDense` does."""
    x = torch.from_numpy(rng.normal(size=(5, 3, 16, 2)).astype(np.float32))
    for mode, recombine, rounds in (("exact", "true", True),
                                    ("exact", "reference", True),
                                    ("vector", "true", False),
                                    ("streams", "true", False)):
        a = ComplexDense(16, 8, mode=mode, recombine=recombine)
        b = ComplexDense(16, 8, mode=mode, recombine=recombine,
                         compute_dtype="bfloat16")
        b.load_state_dict(a.state_dict())
        with torch.no_grad():
            same = torch.equal(a(x), b(x))
        assert same != rounds, (mode, recombine)


@pytest.mark.parametrize("recombine", ["true", "reference"])
def test_complex_dense_layer_bf16_matches_flax(recombine, rng):
    """`ComplexDense(compute_dtype='bfloat16')` against flax's: the output
    and the gradients of x and of every parameter.  'true' against JAX's
    Pallas path (`use_pallas=True`, interpret mode), which the port's
    kernel replaces: `_cdense_bwd` rounds each gradient's float32 sum to
    bf16.  'reference' against JAX's only path for it, four products on
    operands cast by `astype`, whose VJP rounds each product's cotangent
    to bf16 before the float32 sum."""
    from dl_ofdm_tpu.ops import complex_ops as jops
    x = rng.normal(size=(3, 7, 80, 2)).astype(np.float32)
    layer = jops.ComplexDense(64, recombine=recombine,
                              compute_dtype="bfloat16",
                              use_pallas=recombine == "true")
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {n: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
              * (0 if n in ("wr", "wi") else 1) for n, v in params.items()}
    g = rng.normal(size=(3, 7, 64, 2)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, v: layer.apply({"params": p}, v),
                        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    mod = ComplexDense(80, 64, recombine=recombine, compute_dtype="bfloat16")
    mod.load_state_dict({n: torch.tensor(v) for n, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_()
    got = mod(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for t, w in [(xt.grad, dx)] + [(getattr(mod, n).grad, dp[n])
                                   for n in params]:
        w = np.asarray(w)
        np.testing.assert_allclose(t.numpy(), w, rtol=2 ** -7,
                                   atol=1e-5 * np.abs(w).max())


def _pair(nfft, nfilter, nbits=2):
    plan = build_plan(JCfg(nbits=nbits, nfft=nfft, nfilter=nfilter))
    kw = dict(nbits=nbits, nfft=nfft, cp_len=plan.cp_len, nfilter=nfilter,
              frame_size=plan.frame_size, compute_dtype="bfloat16")
    return JRx(**kw), TRx(nsymbol=7, **kw), plan


def _check_logits(lt, lj):
    lj = np.asarray(lj)
    assert lt.dtype == torch.float32 and lj.dtype == np.float32
    np.testing.assert_allclose(lt.numpy(), lj, atol=3e-3 * np.abs(lj).max())
    assert np.mean(lt.numpy() == lj) >= 0.99


def test_dccn_bf16_matches_flax(rng):
    jrx, trx, plan = _pair(64, 64)
    x = rng.normal(size=(6, 7, plan.samples_per_symbol, 2)).astype(np.float32)
    params = jrx.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.normal(
        size=v.shape).astype(np.float32), params)     # nonzero biases
    trx.load_state_dict(tckpt.params_from_flax(params), strict=True)
    lj, fj = jrx.apply({"params": jax.tree.map(jnp.asarray, params)},
                       jnp.asarray(x))
    with torch.no_grad():
        lt, ft = trx(torch.from_numpy(x))
    assert ft.dtype == torch.float32
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj),
                               atol=1e-5 * np.abs(np.asarray(fj)).max())
    _check_logits(lt, lj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dccn_without_compute_dtype_keeps_its_dtype(dtype, rng):
    """Only the bf16 receiver casts its logits to float32; without
    compute_dtype the model computes in its parameters' dtype (float64
    where a check wants exact sums)."""
    _, trx, plan = _pair(64, 64)
    trx = TRx(nbits=2, nfft=64, cp_len=plan.cp_len, nfilter=64,
              frame_size=plan.frame_size).to(dtype)
    x = torch.from_numpy(rng.normal(size=(2, 7, 80, 2))).to(dtype)
    with torch.no_grad():
        logits, fft_out = trx(x)
    assert logits.dtype == dtype and fft_out.dtype == dtype


def test_big512_arm_logits_match_jax(rng):
    """The committed nfft-512 arm (trained in bf16) on 8 frames."""
    params = tckpt.load_params_npz(ARM)
    jrx, trx, plan = _pair(512, 512, nbits=1)
    assert plan.samples_per_symbol == 640 and plan.frame_size == 2000
    trx.load_state_dict(tckpt.params_from_flax(params), strict=True)
    x = (rng.normal(size=(8, 7, 640, 2)) / np.sqrt(2)).astype(np.float32)
    lj, fj = jrx.apply({"params": jax.tree.map(jnp.asarray, params)},
                       jnp.asarray(x))
    with torch.no_grad():
        lt, ft = trx(torch.from_numpy(x))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj),
                               atol=1e-5 * np.abs(np.asarray(fj)).max())
    _check_logits(lt, lj)
    assert np.mean((lt.numpy()[..., 1] > lt.numpy()[..., 0])
                   == (np.asarray(lj)[..., 1] > np.asarray(lj)[..., 0])) \
        > 0.99


def test_autograd_step_gradients_match_jax(rng):
    """One autograd training step's loss and gradients under bf16 against
    `jax.value_and_grad` of JAX's `_loss_fn` on the same batch."""
    n = 6
    jt = JTrainer(JCfg(nbits=2, compute_dtype="bfloat16"),
                  JTc(batch_size=7 * n, reg_coeff=1e-2), channel="AWGN")
    tt = Trainer(OFDMConfig(nbits=2, compute_dtype="bfloat16"),
                 TrainConfig(batch_size=7 * n, reg_coeff=1e-2),
                 channel="AWGN", device="cpu")
    params = jt.init_state(jax.random.PRNGKey(5)).params
    params = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.normal(
        size=v.shape).astype(np.float32), params)
    bits = rng.integers(0, 2, size=(n, jt.plan.frame_size, 2)).astype(
        np.int32)
    x = rng.normal(size=(n, 7, 80, 2)).astype(np.float32)
    (jl, jaux), jg = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(bits), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in
          tckpt.params_from_flax(params).items()}
    tl, taux = tt._loss_fn(tp, torch.from_numpy(bits), torch.from_numpy(x))
    grads = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    want = tckpt.params_from_flax(jax.tree.map(np.asarray, jg))
    assert grads.keys() == want.keys()
    equal = 0
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w,
                                   atol=1e-2 * np.abs(w).max(), err_msg=k)
        equal += int((grads[k].numpy() == w).sum())
    assert equal >= 0.9 * sum(v.numel() for v in want.values())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_trainer_refuses_fused_route_under_compute_dtype(dtype):
    """JAX's gate (`loop.py:157-163`): only a model without compute_dtype
    takes the fused route; a bf16 trainer takes the autograd route."""
    tt = Trainer(OFDMConfig(nbits=1, compute_dtype=dtype), TrainConfig(),
                 channel="ETU", device="cpu")
    assert tt._fused_synth_spec is not None
    assert tt._fused_model_spec is None and not tt._use_fused_model
    assert tt.model.compute_dtype == dtype
    with pytest.raises(ValueError, match="no fused route"):
        tt.train_step(tt.init_state(torch.Generator().manual_seed(0)),
                      torch.Generator().manual_seed(1),
                      torch.full((tt.batch_frames,), 5.0), fused=True)
    assert Trainer(OFDMConfig(nbits=1), TrainConfig(), channel="ETU",
                   device="cpu")._fused_model_spec is not None
    with pytest.raises(ValueError, match="compute_dtype"):
        OFDMConfig(compute_dtype="float16")
