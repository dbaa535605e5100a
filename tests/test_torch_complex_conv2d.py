"""The one-channel complex convolution of `ops/complex_conv2d.py` on the
CPU: its plain versions (the forward, the input gradient as the flipped
form, the weight and bias gradients) behind `complex_conv2d`'s autograd
function, fed each layer's `tap_weight` / `tap_bias`, against the layer's
`F.conv2d` path and against JAX's conv, values and gradients, for every
one-channel 'same' `ComplexConv2d` that the registry's equalizers and
`SingleGraphEqualizedRx` build; the CPU dispatch of `ComplexConv2d`
unchanged; the launch plans the source checks.  The kernels themselves
run in `tests/test_torch_cuda.py`.

Tolerances: float32 on every side with sums in other orders, so 1e-5 of
each output's scale."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.ops import complex_ops as jco
from dl_ofdm_tpu_torch.config import OFDMConfig
from dl_ofdm_tpu_torch.models import equalizers as teq
from dl_ofdm_tpu_torch.models.receiver import SingleGraphEqualizedRx
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.ops import complex_conv2d as cc
from dl_ofdm_tpu_torch.ops import complex_ops as tco
from dl_ofdm_tpu_torch.ops import cuda_build
from dl_ofdm_tpu_torch.train.checkpoint import params_from_flax

# (map, kernel, mode, recombine, bias): the arms' (7, 64) block conv in
# 'exact' (ids 0, 1, 6, 9-12; `SingleGraphEqualizedRx.RefineConv` at
# nfilter 64) and 'vector' (id 7), id 11's cascade conv (1, pilot_size),
# and an odd kernel on a small map in the modes no registry id builds
CASES = [((7, 64), (7, 64), "exact", "true", True),
         ((7, 64), (7, 64), "vector", "true", True),
         ((1, 16), (1, 16), "exact", "true", True),
         ((5, 12), (3, 5), "exact", "reference", True),
         ((5, 12), (3, 5), "streams", "true", True),
         ((5, 12), (3, 5), "exact", "true", False),
         ((5, 12), (3, 5), "vector", "true", False)]


def _one_channel_convs(module):
    """(kernel, mode, recombine, use_bias) of each one-channel 'same'
    `ComplexConv2d` in `module`."""
    out = set()
    for m in module.modules():
        if isinstance(m, tco.ComplexConv2d) and m.padding == "same":
            w = m.w if m.mode == "vector" else m.wr
            if tuple(w.shape[2:]) == ((2, 2) if m.mode == "vector"
                                      else (1, 1)):
                out.add((m.kernel, m.mode, m.recombine, m.use_bias))
    return out


def test_cases_cover_every_one_channel_conv_the_models_build():
    plan = build_plan(OFDMConfig())
    built = set()
    for opt, spec in teq.EQUALIZER_REGISTRY.items():
        built |= _one_channel_convs(teq.Equalizer(
            nfft=64, cp_len=plan.cp_len, nsymbol=7,
            pilot_size=plan.pilot_size,
            pilot_carriers=tuple(plan.pilot_carriers),
            spec=spec))
    built |= _one_channel_convs(SingleGraphEqualizedRx(
        1, 64, plan.cp_len, 64, plan.frame_size, 7, plan.pilot_size))
    cases = {(k, m, r, b) for hw, k, m, r, b in CASES if hw == k}
    assert plan.pilot_size == 16
    assert built <= cases, built - cases


def _layer(kernel, mode, recombine, use_bias, x, rng):
    """The JAX layer, its params (biases made nonzero) and the torch layer
    loaded with them."""
    jmod = jco.ComplexConv2d(1, kernel, padding="same", mode=mode,
                             recombine=recombine, use_bias=use_bias)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.normal(
        size=v.shape).astype(np.float32), params)
    tmod = tco.ComplexConv2d(1, 1, kernel, padding="same", mode=mode,
                             recombine=recombine, use_bias=use_bias)
    tmod.load_state_dict(params_from_flax(params), strict=True)
    return jmod, params, tmod


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("hw,kernel,mode,recombine,use_bias", CASES)
def test_plain_version_and_gradients_match_conv2d_and_jax(
        hw, kernel, mode, recombine, use_bias, rng):
    """`complex_conv2d` on the CPU (the plain versions) against the layer's
    `F.conv2d` path and JAX's layer: the output, and the gradients of
    <y, g> in the input and in every parameter."""
    x = rng.normal(size=(3, *hw, 1, 2)).astype(np.float32)
    g = rng.normal(size=(3, *hw, 1, 2)).astype(np.float32)
    jmod, params, tmod = _layer(kernel, mode, recombine, use_bias, x, rng)
    want, vjp = jax.vjp(lambda p, v: jmod.apply({"params": p}, v), params,
                        jnp.asarray(x))
    jg_params, jg_x = vjp(jnp.asarray(g))
    jg_params = params_from_flax(jax.tree.map(np.asarray, jg_params))

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        tmod.zero_grad()
        y = fn(xt)
        (y * torch.from_numpy(g)).sum().backward()
        return y.detach(), xt.grad, {k: p.grad.clone()
                                     for k, p in tmod.named_parameters()}

    y, gx, gp = grads(lambda v: cc.complex_conv2d(
        v.reshape(3, *hw, 2), tmod.tap_weight(),
        tmod.tap_bias()).reshape(v.shape))
    y0, gx0, gp0 = grads(tmod)
    assert tuple(y.shape) == want.shape == tuple(y0.shape)
    _close(y, want)
    _close(y, y0)
    _close(gx, jg_x)
    _close(gx, gx0)
    assert sorted(gp) == sorted(jg_params) == sorted(gp0)
    for k in gp:
        _close(gp[k], jg_params[k])
        _close(gp[k], gp0[k])


@pytest.mark.parametrize("flip", [False, True])
def test_plain_passes_are_the_forwards_gradients(flip, rng):
    """The input gradient's flipped form and the weight gradient's plain
    version are autograd's gradients of the plain forward (an odd kernel
    wider than the map, so the taps out of reach count too)."""
    x = torch.from_numpy(rng.normal(size=(2, 4, 6, 2))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(5, 9, 2, 2))).requires_grad_()
    b = torch.from_numpy(rng.normal(size=2)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 4, 6, 2)))
    y = cc.complex_conv2d_ref(x, w, b)
    gx, gw, gb = torch.autograd.grad((y * g).sum(), (x, w, b))
    if flip:
        torch.testing.assert_close(cc.complex_conv2d_ref(g, w, flip=True),
                                   gx)
    else:
        dw, db = cc.complex_conv2d_wgrad_ref(x.detach(), g, 5, 9)
        torch.testing.assert_close(dw, gw)
        torch.testing.assert_close(db, gb)


def test_cpu_dispatch_keeps_the_conv2d_path(rng, monkeypatch):
    """On the CPU `ComplexConv2d` runs `F.conv2d` as before: the kernels'
    autograd function is not called and no launch is counted."""
    def refused(*a, **k):
        raise AssertionError("complex_conv2d called on the CPU")

    monkeypatch.setattr(tco, "complex_conv2d", refused)
    before = cc.complex_conv2d_kernel.launches
    layer = tco.ComplexConv2d(1, 1, (7, 64), padding="same")
    y = layer(torch.from_numpy(rng.normal(size=(2, 7, 64, 1, 2)).astype(
        np.float32)))
    assert tuple(y.shape) == (2, 7, 64, 1, 2)
    assert cc.complex_conv2d_kernel.launches == before


@pytest.mark.parametrize("b,s,k,kh,kw", [(9362, 7, 64, 7, 64),
                                          (1024, 7, 64, 7, 64),
                                          (37, 1, 16, 1, 16),
                                          (9362, 5, 12, 3, 5),
                                          (300, 7, 512, 7, 512),
                                          (5, 7, 1024, 7, 1024)])
def test_launch_plans_fit_and_cover_the_frames(b, s, k, kh, kw):
    """The forward's plan: shared bytes within a block's, three blocks a SM
    at the arms' shape, every frame in a block; the weight gradient's:
    the source's layout bytes, one frame a slot, every tap column in a
    chunk, at most two blocks a SM and at least one frame a block."""
    pt = (kh - 1) // 2
    for p in (cc.fwd_plan(b, s, k, kh, kw, pt),
              cc.fwd_plan(b, s, k, kh, kw, kh - 1 - pt)):
        lo, hi = cc.reach(pt, s, kh)
        assert p.smem == 16 * (hi - lo) * kw + 8 * p.frames * s * (k + kw - 1)
        assert p.smem <= cc.SMEM_MAX
        assert (p.grid - 1) * p.frames < b <= p.grid * p.frames
    w = cc.wgrad_plan(b, s, k, kh, kw, 132)
    assert w.smem <= cc.SMEM_MAX
    assert w.frames * w.chunks == cc.WARPS
    assert -(-kw // 32) <= w.grid_y * w.chunks < -(-kw // 32) + w.chunks
    assert 1 <= w.grid_x <= min(b, 2 * 132)
    assert w.sum_grid * 32 >= kh * kw * 4 + 2
    if (s, k) == (7, 64):
        assert cc.fwd_plan(b, s, k, kh, kw, pt).smem * 3 <= cc.SMEM_MAX
        assert (w.frames, w.chunks, w.grid_y) == (4, 2, 1)


def test_launch_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        cc.fwd_plan(10, 9, 64, 7, 64, 3)
    with pytest.raises(ValueError):
        cc.wgrad_plan(10, 9, 64, 7, 64, 132)
    with pytest.raises(ValueError):
        cc.fwd_plan(10, 7, 4096, 7, 4096, 3)


def test_taps_of_every_mode_are_the_layers_map(rng):
    """`tap_weight` / `tap_bias` give the layer's own (re, im) map: one tap
    applied to a unit input of each plane equals the layer on a one-pixel
    map."""
    for mode, recombine in (("exact", "true"), ("exact", "reference"),
                            ("vector", "true"), ("streams", "true")):
        layer = tco.ComplexConv2d(1, 1, (1, 1), padding="same", mode=mode,
                                  recombine=recombine)
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=p.shape)))
            eye = torch.eye(2).reshape(2, 1, 1, 2)
            want = layer(eye) - layer(torch.zeros(1, 1, 1, 2))
            torch.testing.assert_close(want.reshape(2, 2),
                                       layer.tap_weight()[0, 0])
            torch.testing.assert_close(
                layer(torch.zeros(1, 1, 1, 2)).reshape(2), layer.tap_bias())


def test_constants_match_the_source():
    with open(os.path.join(cuda_build.CSRC_DIR, "complex_conv2d.cu")) as f:
        defines = {k: int(v) for k, v in re.findall(
            r"^#define\s+(\w+)\s+(\d+)\s*$", f.read(), re.M)}
    assert (cc.THREADS, cc.MAX_S, cc.SMEM_MAX) == (
        defines["THREADS"], defines["MAX_S"], defines["SMEM_MAX"])
    assert cuda_build.SOURCES["complex_conv2d"] == "complex_conv2d.cu"
