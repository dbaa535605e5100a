"""Tests of the port that need a CUDA card (marker `cuda`); they skip where
there is none.  This file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: `tests/conftest.py` imports JAX.)"""
import copy
import os

import pytest
import torch

from dl_ofdm_tpu_torch.ops import cuda_build
from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,f", [(1968 * 7, 80, 64), (1001, 77, 50),
                                   (1, 1, 1), (130, 33, 129),
                                   (210000, 64, 64), (511, 64, 64),
                                   (2047, 33, 64), (300, 400, 100),
                                   (77, 385, 70)])
def test_complex_dense_kernel_matches_plain_version(cuda, m, k, f):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, k, 2, device=cuda, generator=g)
    wr = torch.randn(k, f, device=cuda, generator=g) / k ** 0.5
    wi = torch.randn(k, f, device=cuda, generator=g) / k ** 0.5
    before = tpk.complex_dense_kernel.launches
    y = tpk.complex_dense_kernel(x, wr, wi)
    torch.cuda.synchronize()
    assert tpk.complex_dense_kernel.launches == before + 1
    torch.testing.assert_close(y, tpk.complex_dense_ref(x, wr, wi),
                               atol=1e-5, rtol=1e-5)


def test_complex_dense_kernel_rejects_bad_input(cuda):
    x = torch.randn(8, 16, 2, device=cuda)
    w = torch.randn(16, 4, device=cuda)
    with pytest.raises(TypeError):
        tpk.complex_dense_kernel(x.double(), w.double(), w.double())
    with pytest.raises(ValueError):
        tpk.complex_dense_kernel(x.transpose(0, 1), w, w)
    with pytest.raises(ValueError):
        tpk.complex_dense_kernel(x, w[:8], w[:8])


def test_complex_dense_kernel_rejects_misaligned_input(cuda):
    """A contiguous view 8 bytes into its storage: the kernel's bulk copies
    need 16-byte alignment, so its wrapper raises; the autograd op copies
    such a view and goes through the kernel."""
    base = torch.randn(7 * 33 * 2 + 2, device=cuda)
    x = base[2:].view(7, 33, 2)
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    w = torch.randn(33, 64, device=cuda)
    with pytest.raises(ValueError):
        tpk.complex_dense_kernel(x, w, w)
    before = tpk.complex_dense_kernel.launches
    y = tpk.complex_dense(x, w, w)
    torch.cuda.synchronize()
    assert tpk.complex_dense_kernel.launches == before + 1
    torch.testing.assert_close(y, tpk.complex_dense_ref(x, w, w), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("k", [2642, 2643, 5000])
def test_complex_dense_kernel_at_the_largest_k(cuda, k):
    """K = 2,642, the most a ring of three 2-row tiles holds beside the
    weight's 192-row chunk, and past it (K odd and even), where x streams
    in K chunks: each matches the plain version."""
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(37, k, 2, device=cuda, generator=g)
    wr, wi = (torch.randn(k, 70, device=cuda, generator=g) / k ** 0.5
              for _ in range(2))
    before = tpk.complex_dense_kernel.launches
    y = tpk.complex_dense_kernel(x, wr, wi)
    torch.cuda.synchronize()
    assert tpk.complex_dense_kernel.launches == before + 1
    torch.testing.assert_close(y, tpk.complex_dense_ref(x, wr, wi),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,k,f", [(992 * 7, 640, 512), (73 * 7, 640, 512),
                                   (1001, 77, 50), (1, 1, 1), (37, 5000, 70),
                                   (1968 * 7, 80, 64)])
def test_complex_dense_bf16_mode_matches_plain_version(cuda, m, k, f):
    """The bf16 mode (operands rounded to bf16 as the kernel reads them,
    float32 sums) against the plain version on rounded operands, at the
    nfft-512 arm's sweep and training shapes, ragged, streamed (K past
    2,642) and the serving shape; one bf16 launch counted, none of the
    float32 mode's."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn(m, k, 2, device=cuda, generator=g)
    wr, wi = (torch.randn(k, f, device=cuda, generator=g) / k ** 0.5
              for _ in range(2))
    before = (tpk.complex_dense_kernel.launches,
              tpk.complex_dense_kernel.launches_bf16)
    y = tpk.complex_dense_kernel(x, wr, wi, "bfloat16")
    torch.cuda.synchronize()
    assert (tpk.complex_dense_kernel.launches,
            tpk.complex_dense_kernel.launches_bf16) == (before[0],
                                                        before[1] + 1)
    torch.testing.assert_close(
        y, tpk.complex_dense_ref(x, wr, wi, "bfloat16"), atol=1e-5,
        rtol=1e-5)
    if k > 1:
        assert (y - tpk.complex_dense_ref(x, wr, wi)).abs().max() > 1e-4


def test_complex_dense_bf16_autograd_on_card(cuda):
    """The autograd op in the bf16 mode on the card: the kernel's forward,
    gradients rounded to bf16 within one bf16 ulp of float64 products of
    the rounded operands."""
    g = torch.Generator(device=cuda).manual_seed(3)
    m, k, f = 511, 640, 512
    x = torch.randn(m, k, 2, device=cuda, generator=g)
    wr, wi = (torch.randn(k, f, device=cuda, generator=g) / k ** 0.5
              for _ in range(2))
    gy = torch.randn(m, f, 2, device=cuda, generator=g)
    leaves = [t.clone().requires_grad_() for t in (x, wr, wi)]
    n = tpk.complex_dense_kernel.launches_bf16
    tpk.complex_dense(*leaves, "bfloat16").backward(gy)
    assert tpk.complex_dense_kernel.launches_bf16 == n + 1
    xb, rb, ib = (tpk.bf16_round(t).double() for t in (x, wr, wi))
    gd = gy.double()
    want = (torch.stack([gd[..., 0] @ rb.T + gd[..., 1] @ ib.T,
                         -gd[..., 0] @ ib.T + gd[..., 1] @ rb.T], -1),
            xb[..., 0].T @ gd[..., 0] + xb[..., 1].T @ gd[..., 1],
            xb[..., 0].T @ gd[..., 1] - xb[..., 1].T @ gd[..., 0])
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, tpk.bf16_round(t.grad))
        # one bf16 ulp (2^-7 of the value at most); near zero the float32
        # sum's own error, 1e-5 of the largest entry
        torch.testing.assert_close(t.grad, w.float(), rtol=2 ** -7,
                                   atol=1e-5 * float(w.abs().max()))


def test_dccn_bf16_on_card_matches_cpu(cuda):
    """`DCCNReceiver(compute_dtype='bfloat16')` on the card (the kernel's
    bf16 mode, bf16 cuBLAS Dense layers) against the same model on the
    CPU: the same bf16 roundings in other sum orders, so logits within a
    few bf16 ulps (1e-2 of their largest magnitude) and 99.9 % of the bit
    decisions equal."""
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
    torch.manual_seed(0)
    rx = DCCNReceiver(nbits=2, nfft=64, cp_len=16, nfilter=64,
                      frame_size=320, compute_dtype="bfloat16")
    x = torch.randn(64, 7, 80, 2)
    with torch.no_grad():
        want, fw = rx(x)
        n = tpk.complex_dense_kernel.launches_bf16
        got, fg = rx.to(cuda)(x.to(cuda))
        torch.cuda.synchronize()
    assert tpk.complex_dense_kernel.launches_bf16 == n + 1
    torch.testing.assert_close(fg.cpu(), fw, atol=1e-5, rtol=1e-5)
    got = got.cpu()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-2 * float(want.abs().max()))
    agree = ((got[..., 1] > got[..., 0]) == (want[..., 1] > want[..., 0]))
    assert agree.float().mean() >= 0.999


@pytest.mark.parametrize("name", sorted(cuda_build.SOURCES))
def test_library_is_built_under_build_dir(cuda, name):
    cuda_build.load(name)
    path = cuda_build.library_path(name)
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.isfile(path)


def _synth_spec(channel, nbits, mobile=False, **cfg):
    """The spec a `Trainer` builds (its fused gate), Doppler rows included
    where `mobile`."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.loop import Trainer
    return Trainer(OFDMConfig(nbits=nbits, **cfg), TrainConfig(),
                   channel=channel, mobile=mobile,
                   device="cpu")._fused_synth_spec


@pytest.mark.parametrize("channel,nbits,n,mobile,want_h,cfg", [
    ("ETU", 1, 37, False, False, {}), ("AWGN", 4, 5, False, False, {}),
    ("mixAll", 2, 33, False, False, {}), ("mixAll", 2, 33, False, True, {}),
    ("AWGN", 1, 9, False, True, {}),
    ("mixRayleigh", 1, 50, True, False, {}),
    ("mixRayleigh", 1, 50, True, True, {}),
    ("ETU", 4, 19, True, False, {}), ("ETU", 4, 19, True, True, {}),
    ("mixAll", 2, 41, True, False, {}), ("mixAll", 2, 41, True, True, {}),
    ("ETU", 1, 21, False, False, {"nfft": 128}),
    ("mixRayleigh", 2, 21, True, True, {"nfft": 128, "longcp": False})])
def test_fused_synth_kernel_matches_plain_version(cuda, channel, nbits, n,
                                                  mobile, want_h, cfg):
    """Same Philox words: indices equal, planes and h to 1e-4 (log, sincos
    and cos differ by a few ulp between the kernel and torch), sums to
    1e-5."""
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    spec = _synth_spec(channel, nbits, mobile, **cfg)
    assert spec.mobile == mobile
    seeds = torch.tensor([123, 2**32 - 5], dtype=torch.int64, device=cuda)
    std = tfs.noise_std(torch.linspace(0, 20, n, device=cuda))
    before = tfs.fused_synthesize_kernel.launches
    got = tfs.fused_synthesize_kernel(spec, seeds, std, want_h=want_h)
    want = tfs.fused_synthesize_ref(spec, n, std, seeds=seeds, want_h=want_h)
    torch.cuda.synchronize()
    assert tfs.fused_synthesize_kernel.launches == before + 1
    plan = tfs.synth_launch_plan(spec, n, cuda.index or 0)
    assert got[5].shape == (plan.grid, 10, spec.length)
    assert len(got) == len(want) == 6 + want_h
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:5] + got[6:], want[1:5] + want[6:]):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    torch.testing.assert_close(got[5].sum(0), want[5][0], atol=1e-3,
                               rtol=1e-5)


@pytest.mark.parametrize("n", [37, 9362])
def test_fused_synth_kernel_gives_the_same_bits_twice(cuda, n):
    """Each block walks a fixed set of row groups and sums them in a fixed
    order: two calls on the same seeds give identical outputs, partial
    sums included (mixRayleigh mobile with want_h: every branch)."""
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    spec = _synth_spec("mixRayleigh", 2, True)
    seeds = torch.tensor([9, 2**31 + 7], dtype=torch.int64, device=cuda)
    std = tfs.noise_std(torch.linspace(-5, 25, n, device=cuda))
    got = [tfs.fused_synthesize_kernel(spec, seeds, std, want_h=True)
           for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*got):
        assert torch.equal(a, b)


def _model_case(cuda, nbits, n, sps, d, seed, nfilter=64):
    """Receiver parameters (init plus noise), raw planes, an affine and
    symbol indices at n frames of 7 symbols of `sps` samples."""
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
    S = 7
    nfft = 64 if sps <= 80 else 128
    g = torch.Generator(device=cuda).manual_seed(seed)
    rx = DCCNReceiver(nbits=nbits, nfft=nfft, cp_len=sps - nfft,
                      nfilter=nfilter, frame_size=d).to(cuda)
    rx.reset_parameters(g)
    params = {k: v.detach() + 0.05 * torch.randn(v.shape, device=cuda,
                                                  generator=g)
              for k, v in rx.state_dict().items()}
    planes = [torch.randn(n, S * sps, device=cuda, generator=g)
              for _ in range(4)]
    c = 0.5 + torch.rand(6, S * sps, device=cuda, generator=g)
    idx = torch.randint(0, 2 ** nbits, (n, d), device=cuda, generator=g,
                        dtype=torch.int32)
    return params, planes, c, idx


@pytest.mark.parametrize("nbits,dtype,n,sps,d,nfilter", [
    (1, "float32", 50, 80, 320, 64), (4, "float32", 50, 80, 320, 64),
    (1, "bfloat16", 50, 80, 320, 64), (3, "bfloat16", 50, 80, 320, 64),
    (2, "bfloat16", 1, 80, 320, 64), (4, "bfloat16", 1001, 80, 320, 64),
    (2, "bfloat16", 1001, 137, 640, 64), (4, "bfloat16", 1, 137, 640, 64),
    (2, "bfloat16", 1001, 80, 320, 30), (1, "bfloat16", 77, 137, 322, 33),
    (3, "float32", 77, 137, 322, 33)])
def test_fused_model_kernel_matches_plain_version(cuda, nbits, dtype, n, sps,
                                                  d, nfilter):
    """bf16 on the tensor cores, float32 on the FMA units; sps 137 (nfft
    128 without the long CP) pads the bf16 input's rows to 280, nfilter
    30 and 33 each symbol's 2F columns to 64 and 72, and D 322 de's 644
    columns to 648."""
    from dl_ofdm_tpu_torch.ops import fused_model as tfm
    params, planes, c, idx = _model_case(cuda, nbits, n, sps, d, nbits,
                                         nfilter)
    spec = tfm.ModelSpec(nsymbol=7, sps=sps, nfilter=nfilter, frame_size=d,
                         nbits=nbits, matmul_dtype=dtype)
    before = tfm.dccn_fused_grads_kernel.launches
    gk, cek, confk, ek = tfm.dccn_fused_grads_kernel(
        spec, n, params, *planes, c, idx, return_e=True)
    ep = tfm.dccn_forward_ref(spec, params, *planes, c)[2]
    # the plain backward from the kernel's forward output, so that both
    # take the same slope at every leaky kink
    gp, cep, confp = tfm.dccn_fused_grads_ref(spec, n, params, *planes, c,
                                              idx, e=ek)
    torch.cuda.synchronize()
    assert tfm.dccn_fused_grads_kernel.launches == before + 1
    tol = 1e-4 if dtype == "float32" else 1e-3
    assert float((ek - ep).abs().max()) <= tol * float(ep.abs().max())
    for k in tfm.PARAM_KEYS:
        assert gk[k].shape == params[k].shape, k
        scale = float(gp[k].abs().max())
        assert float((gk[k] - gp[k]).abs().max()) <= tol * scale, k
    torch.testing.assert_close(cek, cep, rtol=1e-5, atol=0)
    assert torch.equal(confk, confp)


def test_fused_model_kernel_is_deterministic(cuda):
    """Split-K partials summed in a fixed order: two calls of the bf16
    kernel on the same inputs give bit-identical gradients and CE."""
    from dl_ofdm_tpu_torch.ops import fused_model as tfm
    params, planes, c, idx = _model_case(cuda, 1, 9362, 80, 320, 7)
    spec = tfm.ModelSpec(nsymbol=7, sps=80, nfilter=64, frame_size=320,
                         nbits=1, matmul_dtype="bfloat16")
    g1, ce1, conf1 = tfm.dccn_fused_grads_kernel(spec, 9362, params, *planes,
                                                 c, idx)
    g2, ce2, conf2 = tfm.dccn_fused_grads_kernel(spec, 9362, params, *planes,
                                                 c, idx)
    torch.cuda.synchronize()
    assert all(torch.equal(g1[k], g2[k]) for k in tfm.PARAM_KEYS)
    assert torch.equal(ce1, ce2) and torch.equal(conf1, conf2)


@pytest.mark.parametrize("a_mn,b_mn", [(False, False), (False, True),
                                       (True, False), (True, True)])
@pytest.mark.parametrize("m,n,k,splits", [(200, 136, 296, 1),
                                          (640, 896, 2000, 3), (8, 8, 8, 1)])
def test_tensor_core_gemm_layouts(cuda, a_mn, b_mn, m, n, k, splits):
    """Each operand layout of the wgmma GEMM (K- or MN-major A and B, TMA
    boxes and shared-memory descriptors alike) against a float64 product
    of the same bf16 values; ragged tiles on every edge."""
    from dl_ofdm_tpu_torch.ops import fused_model as tfm
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn(m, k, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(n, k, device=cuda, generator=g).to(torch.bfloat16)
    got = tfm.tensor_core_gemm_check(
        a.T.contiguous() if a_mn else a, b.T.contiguous() if b_mn else b,
        a_mn, b_mn, splits).sum(0)
    torch.cuda.synchronize()
    want = (a.double() @ b.double().T).float()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * k ** 0.5 * scale


@pytest.mark.parametrize("nfilter", [64, 30])
def test_train_step_fused_on_card(cuda, nfilter):
    """Both kernels in one step, bf16 GEMMs by default; nfilter 30 (2F no
    multiple of 8) takes the same route on padded pitches."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import fused_model as tfm
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(OFDMConfig(nbits=1, nfilter=nfilter),
                 TrainConfig(batch_size=700), channel="ETU")
    assert tr._fused_model_spec.matmul_dtype == "bfloat16"
    assert tr._use_fused_model
    g = torch.Generator(device=cuda).manual_seed(0)
    state = tr.init_state(g)
    snr = torch.full((tr.batch_frames,), 5.0, device=cuda)
    n_s, n_m = (tfs.fused_synthesize_kernel.launches,
                tfm.dccn_fused_grads_kernel.launches)
    state, aux = tr.train_step(state, g, snr)
    torch.cuda.synchronize()
    assert tfs.fused_synthesize_kernel.launches == n_s + 1
    assert tfm.dccn_fused_grads_kernel.launches == n_m + 1
    assert state.step == 1 and torch.isfinite(aux["loss"])
    assert int(aux["conf"].sum()) == tr.batch_frames * 320


@pytest.mark.parametrize("counts", [None, [[300, 20], [35, 285]]])
@pytest.mark.parametrize("name", ["nfft64", "nfft512"])
def test_fused_adam_kernel_matches_plain_version(cuda, name, counts):
    """One launch over a DCCN's leaves (`chip_smoke.adam_leaf_set`: at
    nfft 64 with the fused model kernel's strided gradients; the nfft-512
    receiver's 29.3 M values) against `fused_adam_ref` on the same
    tensors: parameters, moments and gradients bit-identical, the loss
    scalars within 1e-6; two launches give the same bits; the inputs are
    not written."""
    from chip_smoke import adam_leaf_set
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
    from dl_ofdm_tpu_torch.ops import fused_adam as fa
    rx = (DCCNReceiver(1, 512, 128, 512, 2000, compute_dtype="bfloat16")
          if name == "nfft512" else DCCNReceiver(1, 64, 16, 64, 320))
    keys, ws, gs, mus, nus = adam_leaf_set(rx, cuda)
    args = [[d[k] for k in keys] for d in (ws, gs, mus, nus)]
    before = [t.clone() for a in args for t in a]
    conf = None if counts is None else torch.tensor(counts, device=cuda)
    ce = torch.tensor([0.61], device=cuda)
    hp = fa.AdamHyper(0.9, 0.999, 1e-8, 1e-3 * 0.98 ** 3, 1501)
    lay = fa.AdamLayout.of({}, keys, *args)
    assert lay is not None
    n0 = fa.fused_adam_kernel.launches
    outs = [fa.fused_adam_kernel(lay, *args, hp, conf, ce, 1e-4, True)
            for _ in range(2)]
    want = fa.fused_adam_ref(keys, *args, hp, conf, ce[0], 1e-4, True)
    torch.cuda.synchronize()
    assert fa.fused_adam_kernel.launches == n0 + 2
    for got in outs:
        for field in ("params", "mu", "nu", "grads"):
            for k, a, b in zip(keys, getattr(got, field),
                               getattr(want, field)):
                assert torch.equal(a, b), (field, k)
        assert (got.scalars is None) == (counts is None)
        if counts is not None:
            for k, v in want.scalars.items():
                torch.testing.assert_close(got.scalars[k], v, rtol=1e-6,
                                           atol=0, msg=k)
    for field in ("params", "mu", "nu", "grads"):
        for a, b in zip(getattr(outs[0], field), getattr(outs[1], field)):
            assert torch.equal(a, b)
    if counts is not None:
        for k in fa.SCALARS:
            assert torch.equal(outs[0].scalars[k], outs[1].scalars[k]), k
    assert all(torch.equal(t, b) for t, b in zip(
        (t for a in args for t in a), before))


def test_fused_steps_with_the_kernel_equal_the_foreach_path(cuda,
                                                             monkeypatch):
    """20 fused steps at 1,024 frames from one init and one seed: the
    parameters and both moments after each step bit-identical between the
    kernel and the L2 term with `Adam.update` (a second trainer whose
    optimizer's `_kernel_leaves` the test turns off)."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import fused_adam as fa
    from dl_ofdm_tpu_torch.train.loop import Adam, Trainer
    tk, tf = (Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=7 * 1024),
                      channel="ETU") for _ in range(2))
    monkeypatch.setattr(tf.optimizer, "_kernel_leaves",
                        lambda *a, **k: None)
    assert tk._use_fused_model and tk.batch_frames == 1024
    init = tk.init_state(torch.Generator(device=cuda).manual_seed(0))
    snr = torch.full((1024,), 5.0, device=cuda)
    gens = [torch.Generator(device=cuda).manual_seed(9) for _ in range(2)]
    (sk, sf) = (init, init)
    n0, f0 = fa.fused_adam_kernel.launches, Adam.foreach_steps
    for i in range(20):
        sk, ak = tk.train_step(sk, gens[0], snr)
        sf, af = tf.train_step(sf, gens[1], snr)
        for k in init.params:
            assert torch.equal(sk.params[k], sf.params[k]), (i, k)
            for m in ("mu", "nu"):
                assert torch.equal(sk.opt_state[m][k],
                                   sf.opt_state[m][k]), (i, m, k)
        for k in ("ce", "ber", "log_ber", "loss", "total_loss"):
            torch.testing.assert_close(ak[k], af[k], rtol=1e-6, atol=0,
                                       msg=k)
    torch.cuda.synchronize()
    assert fa.fused_adam_kernel.launches == n0 + 20
    assert Adam.foreach_steps == f0 + 20


def test_fused_adam_copies_other_layouts_to_the_kernels(cuda):
    """A moment laid out transposed and a 3-D gradient view on a card:
    `Adam.step` copies them to the kernel's layout and launches it (no
    step on the foreach path), with the bits of the contiguous leaves;
    the step's loss scalars are a 5-value tensor apart from its state."""
    from dl_ofdm_tpu_torch.config import TrainConfig
    from dl_ofdm_tpu_torch.ops import fused_adam as fa
    from dl_ofdm_tpu_torch.train.loop import Adam
    g = torch.Generator(device=cuda).manual_seed(4)
    shapes = {"Dense_a.weight": (6, 5), "Dense_a.bias": (6,),
              "fft_like.wr": (2, 3, 4)}
    params = {k: torch.randn(s, device=cuda, generator=g)
              for k, s in shapes.items()}
    grads = {k: torch.randn(s, device=cuda, generator=g)
             for k, s in shapes.items()}
    opt = Adam(TrainConfig())
    state = opt.init(params)
    state["mu"] = {k: 0.1 * torch.randn(s, device=cuda, generator=g)
                   for k, s in shapes.items()}
    odd_state = {**state, "mu": {**state["mu"], "Dense_a.weight":
                                 state["mu"]["Dense_a.weight"].T
                                 .contiguous().T}}
    odd_grads = {**grads, "fft_like.wr":
                 grads["fft_like.wr"].permute(2, 0, 1).contiguous()
                 .permute(1, 2, 0)}
    assert not odd_state["mu"]["Dense_a.weight"].is_contiguous()
    assert fa.AdamLayout.of({}, list(grads), *[
        [d[k] for k in grads] for d in (params, odd_grads,
                                        odd_state["mu"], state["nu"])]) \
        is None
    conf = torch.tensor([[30, 2], [3, 25]], device=cuda)
    ce = torch.tensor([0.5], device=cuda)
    n0, f0 = fa.fused_adam_kernel.launches, Adam.foreach_steps
    outs = [opt.step(params, gd, st, conf, ce, 0.5)
            for gd, st in ((grads, state), (odd_grads, odd_state))]
    torch.cuda.synchronize()
    assert fa.fused_adam_kernel.launches == n0 + 2
    assert Adam.foreach_steps == f0
    (p0, s0, sc0, _), (p1, s1, sc1, _) = outs
    for k in shapes:
        assert torch.equal(p0[k], p1[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(s0[m][k], s1[m][k]), (m, k)
    for k in fa.SCALARS:
        assert torch.equal(sc0[k], sc1[k]), k
        assert sc1[k].untyped_storage().nbytes() == 4 * len(fa.SCALARS)


def test_fit_keeping_total_losses_holds_no_step_state(cuda):
    """`fit(best_metric="total")` keeps each step's `total_loss` until its
    epoch ends (197 fused steps, one launch each, at the default batch).
    Those are the kernel's 20-byte scalars: 40 steps whose total losses
    are kept, as `fit` keeps them, leave the memory in use within two
    states (parameters and moments) of where it was."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import fused_adam as fa
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(OFDMConfig(nbits=1), TrainConfig(best_metric="total"),
                 channel="ETU")
    assert tr._use_fused_model and tr.batch_frames == 73
    n0 = fa.fused_adam_kernel.launches
    tr.fit(max_epochs=1, log_fn=lambda m: None, grow_batch=False)
    torch.cuda.synchronize()
    assert fa.fused_adam_kernel.launches - n0 == 14400 // 73
    gen = torch.Generator(device=cuda).manual_seed(2)
    state = tr.init_state(gen)
    snr = torch.full((73,), 5.0, device=cuda)
    for _ in range(3):
        state, aux = tr.train_step(state, gen, snr)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    losses = []
    for _ in range(40):
        state, aux = tr.train_step(state, gen, snr)
        losses.append(aux["total_loss"])
    torch.cuda.synchronize()
    state_bytes = 4 * 3 * sum(p.numel() for p in state.params.values())
    grown = torch.cuda.memory_allocated() - before
    assert grown <= 2 * state_bytes, (grown, state_bytes)
    assert torch.isfinite(torch.stack(losses)).all()


@pytest.mark.parametrize("route", ["fused", "autograd", "dp2"])
def test_fused_adam_kernel_takes_every_step(cuda, route):
    """The kernel's launches equal the steps and no step takes the foreach
    path: the fused route, the autograd route, a one-process dp-2 mesh."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import fused_adam as fa
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
    from dl_ofdm_tpu_torch.train.loop import Adam, Trainer
    card = torch.device("cuda", 0)
    mesh = make_mesh([card, card], dp=2) if route == "dp2" else None
    tr = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=7 * 64),
                 channel="AWGN", mesh=mesh)
    g = torch.Generator(device=cuda).manual_seed(0)
    state = tr.init_state(g)
    snr = torch.full((tr.batch_frames,), 5.0, device=cuda)
    n0, f0 = fa.fused_adam_kernel.launches, Adam.foreach_steps
    for _ in range(3):
        state, aux = tr.train_step(
            state, g, snr, **({} if mesh else {"fused": route == "fused"}))
    torch.cuda.synchronize()
    assert fa.fused_adam_kernel.launches == n0 + 3
    assert Adam.foreach_steps == f0
    assert state.step == 3 and torch.isfinite(aux["loss"])


@pytest.mark.parametrize("longcp", [True, False])
def test_train_step_fused_at_nfft_128(cuda, longcp):
    """Frames of 1,120 and 959 samples (sps 160 and 137) take the fused
    route on the card, as the gate admits them."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(OFDMConfig(nbits=1, nfft=128, longcp=longcp),
                 TrainConfig(batch_size=7 * 40), channel="mixRayleigh")
    assert tr._use_fused_model
    g = torch.Generator(device=cuda).manual_seed(0)
    state = tr.init_state(g)
    snr = torch.full((tr.batch_frames,), 5.0, device=cuda)
    n_s = tfs.fused_synthesize_kernel.launches
    for _ in range(2):
        state, aux = tr.train_step(state, g, snr)
    torch.cuda.synchronize()
    assert tfs.fused_synthesize_kernel.launches == n_s + 2
    assert state.step == 2 and torch.isfinite(aux["loss"])
    assert int(aux["conf"].sum()) == tr.batch_frames * tr.plan.frame_size


def test_train_step_fused_mobile_on_card(cuda):
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=7 * 120),
                 channel="mixRayleigh", mobile=True)
    assert tr._use_fused_model and tr._fused_synth_spec.mobile
    g = torch.Generator(device=cuda).manual_seed(0)
    state = tr.init_state(g)
    snr = torch.full((tr.batch_frames,), 5.0, device=cuda)
    n_s = tfs.fused_synthesize_kernel.launches
    state, aux = tr.train_step(state, g, snr)
    torch.cuda.synchronize()
    assert tfs.fused_synthesize_kernel.launches == n_s + 1
    assert torch.isfinite(aux["loss"])


def test_philox_probe_kernel_matches_plain_version(cuda):
    from dl_ofdm_tpu_torch.ops import prng_probe as pp
    seeds = torch.tensor(pp.SEEDS, dtype=torch.int64, device=cuda)
    before = pp.probe_words_kernel.launches
    got = pp.probe_words_kernel(seeds, 3, 5, 36)
    torch.cuda.synchronize()
    assert pp.probe_words_kernel.launches == before + 1
    want = pp.probe_words_ref(seeds, 3, 5, 36)
    assert torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want)
    q = pp.main()
    assert q["device"] == torch.cuda.get_device_name(0)


@pytest.mark.parametrize("b,l,f", [(30000, 560, 13), (73, 560, 9),
                                   (5, 1120, 1), (9, 40, 300),
                                   (37, 561, 13), (1001, 560, 40),
                                   (3, 5000, 13)])
def test_fir_shift_accum_kernel_matches_plain_version(cuda, b, l, f):
    """Same float32 operations in the same order (no contracted
    multiply-adds): bit-equal, at the sweep's shape, odd rows (La = L + F
    - 1 odd: rows start anywhere), taps past one register chunk, B not a
    multiple of the rows a unit takes, and rows cut into chunks."""
    g = torch.Generator(device=cuda).manual_seed(b)
    xar, xai = (torch.randn(b, l + f - 1, device=cuda, generator=g)
                for _ in range(2))
    hr, hi = (torch.randn(b, f, device=cuda, generator=g) for _ in range(2))
    before = tpk.fir_shift_accum_kernel.launches
    yr, yi = tpk.fir_shift_accum_kernel(xar, xai, hr, hi, l)
    wr, wi = tpk.fir_shift_accum_ref(xar, xai, hr, hi, l)
    torch.cuda.synchronize()
    assert tpk.fir_shift_accum_kernel.launches == before + 1
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


def test_fir_shift_accum_kernel_rejects_bad_input(cuda):
    x = torch.randn(4, 22, device=cuda)
    h = torch.randn(4, 3, device=cuda)
    with pytest.raises(TypeError):
        tpk.fir_shift_accum_kernel(x.double(), x.double(), h.double(),
                                   h.double(), 20)
    with pytest.raises(ValueError):
        tpk.fir_shift_accum_kernel(x, x, h, h, 21)
    with pytest.raises(ValueError):
        tpk.fir_shift_accum_kernel(x, x, h.requires_grad_(), h, 20)


@pytest.mark.parametrize("channel", ["ETU", "mixRayleigh"])
def test_fir_same_iq_on_card_launches_the_kernel(cuda, channel):
    import numpy as np
    from dl_ofdm_tpu_torch.channel import fir
    from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
    ch = RayleighChannel(channel)
    b = 41
    offsets = ch._offset_np[ch._frame_profiles(b)]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(b, 560, 2, device=cuda, generator=g)
    h = torch.randn(b, ch.max_fir, 2, device=cuda, generator=g)
    before = tpk.fir_shift_accum_kernel.launches
    y = fir.fir_same_iq(x, h, offsets)
    torch.cuda.synchronize()
    assert tpk.fir_shift_accum_kernel.launches == before + 1
    want = fir.fir_same_iq(x.cpu(), h.cpu(), np.asarray(offsets))
    scale = float(want.abs().max())
    assert float((y.cpu() - want).abs().max()) <= 1e-6 * scale


def test_equalizer_step_on_card(cuda):
    """One curriculum step of the equalizer stage (opt 12, mixRayleigh):
    the static FIR through its kernel, the equalizer's complex dense
    layers through theirs, the receiver frozen."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    torch.backends.cudnn.allow_tf32 = False
    tr = EqualizerTrainer(OFDMConfig(nbits=2), TrainConfig(
        snr=10.0, batch_size=512, opt=12), channel="mixRayleigh")
    g = torch.Generator(device=cuda).manual_seed(0)
    state = tr.init_state(g)
    rx0 = {k: v.clone() for k, v in state.params.items()
           if k.startswith("receiver.")}
    n_fir = tpk.fir_shift_accum_kernel.launches
    n_cd = tpk.complex_dense_kernel.launches
    state, aux = tr.train_step_curriculum(state, g)
    torch.cuda.synchronize()
    assert tpk.fir_shift_accum_kernel.launches == n_fir + 1
    # ToFreq, CorrT, ToTime and the receiver's fft_like
    assert tpk.complex_dense_kernel.launches == n_cd + 4
    assert state.step == 1
    assert all(torch.isfinite(aux[k]) for k in ("loss", "chan_mse",
                                                "snr_mse"))
    for k, v in rx0.items():
        assert torch.equal(state.params[k], v), k
    assert set(state.opt_state["mu"]) == {
        k for k in state.params if k.startswith("Equalizer.")}


CONV_MODES = [("exact", "true"), ("exact", "reference"), ("vector", "true"),
              ("streams", "true")]


def _conv_layer(cuda, kernel, mode, recombine, seed):
    from dl_ofdm_tpu_torch.ops.complex_ops import ComplexConv2d
    layer = ComplexConv2d(1, 1, kernel, padding="same", mode=mode,
                          recombine=recombine).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.05 * torch.randn(p.shape, device=cuda, generator=g))
    return layer, g


@pytest.mark.parametrize("mode,recombine", CONV_MODES)
@pytest.mark.parametrize("b,hw,kernel", [(37, (7, 64), (7, 64)),
                                         (9362, (7, 64), (7, 64)),
                                         (37, (1, 16), (1, 16)),
                                         (73, (5, 12), (3, 5))])
def test_complex_conv2d_kernels_match_plain_version(cuda, b, hw, kernel,
                                                    mode, recombine):
    """The layer on the card (the kernels: forward, input gradient, weight
    and bias gradients) against the plain versions in float64 on the card,
    each error relative to the largest value (float32 sums of up to ~250
    products an output, ~4,000 a lane in the weight gradient); one launch
    each for the forward and the input gradient, two for the weight
    gradient."""
    from dl_ofdm_tpu_torch.ops import complex_conv2d as cc
    layer, g = _conv_layer(cuda, kernel, mode, recombine, b)
    x = torch.randn(b, *hw, 1, 2, device=cuda, generator=g)
    gy = torch.randn(b, *hw, 1, 2, device=cuda, generator=g)
    x.requires_grad_()
    k = cc.complex_conv2d_kernel
    n0 = (k.launches_fwd, k.launches_dgrad, k.launches_wgrad)
    y = layer(x)
    y.backward(gy)
    torch.cuda.synchronize()
    assert (k.launches_fwd - n0[0], k.launches_dgrad - n0[1],
            k.launches_wgrad - n0[2]) == (1, 1, 2)
    params = dict(layer.named_parameters())
    layer64 = copy.deepcopy(layer).double()
    p64 = dict(layer64.named_parameters())
    taps, bias = layer64.tap_weight(), layer64.tap_bias()
    x64 = x.detach().double().reshape(b, *hw, 2)
    g64 = gy.double().reshape(b, *hw, 2)
    want_y = cc.complex_conv2d_ref(x64, taps.detach(), None if bias is None
                                   else bias.detach())
    want_dx = cc.complex_conv2d_ref(g64, taps.detach(), flip=True)
    dw, db = cc.complex_conv2d_wgrad_ref(x64, g64, *kernel)
    outs = [taps] + ([bias] if bias is not None else [])
    grads = [dw] + ([db] if bias is not None else [])
    want_p = dict(zip(p64, torch.autograd.grad(outs, list(p64.values()),
                                               grads)))

    def rel(got, want):
        return float((got.double() - want).abs().max()
                     / want.abs().max().clamp_min(1e-30))

    assert rel(y.reshape(want_y.shape), want_y) <= 1e-5
    assert rel(x.grad.reshape(want_dx.shape), want_dx) <= 1e-5
    for n, p in params.items():
        assert rel(p.grad, want_p[n]) <= 1e-4, n


def test_complex_conv2d_backward_repeats_bit_for_bit(cuda):
    """Two backward passes at 9,362 frames: the same dx, dW and db bits
    (no float atomics; each block's frames and the blocks' sum in fixed
    orders)."""
    from dl_ofdm_tpu_torch.ops import complex_conv2d as cc
    layer, g = _conv_layer(cuda, (7, 64), "exact", "true", 5)
    w, bias = layer.tap_weight().detach(), layer.tap_bias().detach()
    x = torch.randn(9362, 7, 64, 2, device=cuda, generator=g)
    gy = torch.randn(9362, 7, 64, 2, device=cuda, generator=g)
    runs = [(cc.complex_conv2d_kernel(gy, w, flip=True),
             *cc.complex_conv2d_wgrad_kernel(x, gy, 7, 64))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0][2].shape == (2,)
    y = [cc.complex_conv2d_kernel(x, w, bias) for _ in range(2)]
    assert torch.equal(*y)


def test_complex_conv2d_kernels_reject_bad_input(cuda):
    from dl_ofdm_tpu_torch.ops import complex_conv2d as cc
    x = torch.randn(4, 7, 64, 2, device=cuda)
    w = torch.randn(7, 64, 2, 2, device=cuda)
    with pytest.raises(TypeError):
        cc.complex_conv2d_kernel(x.double(), w.double())
    with pytest.raises(ValueError):             # more rows than MAX_S
        cc.complex_conv2d_kernel(torch.randn(4, 9, 64, 2, device=cuda), w)
    with pytest.raises(ValueError):             # not contiguous
        cc.complex_conv2d_kernel(x.transpose(1, 2), w)
    with pytest.raises(ValueError):             # not IQ-last
        cc.complex_conv2d_kernel(x[..., :1].contiguous(), w)
    with pytest.raises(ValueError):             # taps not [kh, kw, 2, 2]
        cc.complex_conv2d_kernel(x, w[..., :1].contiguous())
    with pytest.raises(ValueError):             # taps on the CPU
        cc.complex_conv2d_kernel(x, w.cpu())
    with pytest.raises(ValueError):             # too wide for shared memory
        cc.complex_conv2d_kernel(torch.randn(2, 7, 4096, 2, device=cuda),
                                 torch.randn(7, 4096, 2, 2, device=cuda))
    with pytest.raises(ValueError):             # maps of two shapes
        cc.complex_conv2d_wgrad_kernel(x, x[:2].contiguous(), 7, 64)
    with pytest.raises(TypeError):              # the layer in float64
        from dl_ofdm_tpu_torch.ops.complex_ops import ComplexConv2d
        ComplexConv2d(1, 1, (7, 64)).to(cuda).double()(x.double())


def test_equalizer_step_launches_the_block_conv_kernels(cuda):
    """One curriculum step of the opt-12 equalizer on the card: its block
    conv's forward, input gradient and weight gradient through the kernels
    (4 launches), none through cuDNN's convolutions."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import complex_conv2d as cc
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    tr = EqualizerTrainer(OFDMConfig(nbits=1), TrainConfig(
        snr=10.0, batch_size=7 * 73, opt=12), channel="mixRayleigh")
    g = torch.Generator(device=cuda).manual_seed(0)
    state = tr.init_state(g)
    k = cc.complex_conv2d_kernel
    n0 = (k.launches, k.launches_fwd, k.launches_dgrad, k.launches_wgrad)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, aux = tr.train_step_curriculum(state, g)
        torch.cuda.synchronize()
    assert (k.launches - n0[0], k.launches_fwd - n0[1],
            k.launches_dgrad - n0[2], k.launches_wgrad - n0[3]) == (
                4, 1, 1, 2)
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if any(
        c in n for c in ("wgrad2d", "dgrad2d", "regular_fft", "gemmk1"))]
    assert any("complex_conv2d_wgrad_kernel" in n for n in names), names


def _ring_slices(devs, b, hl, hr, l, seed):
    """Each rank's shard [b, l, 2] on its device and its strided boundary
    slices: the last hl samples and the first hr."""
    g = torch.Generator().manual_seed(seed)
    shards = [torch.randn(b, l, 2, generator=g).to(d) for d in devs]
    return ([x[:, -hl:, :] for x in shards], [x[:, :hr, :] for x in shards])


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_ring_exchange_kernel_matches_plain_version(cuda, p):
    """P virtual ranks on one card, one launch of the copy template a call
    (P = 1: a rank receives its own slices): the receive buffers bit-equal
    to the plain version's, on aligned (16-byte) and unaligned slices,
    twice."""
    from dl_ofdm_tpu_torch.parallel import halo
    before = halo.ring_exchange_kernel.launches
    calls = 0
    for hl, hr, l in ((6, 6, 560), (3, 1, 37), (12, 8, 4096)):
        lt, rh = _ring_slices([cuda] * p, 64, hl, hr, l, p + l)
        for _ in range(2):
            got = halo.ring_exchange(lt, rh)
            calls += 1
            want = halo.ring_exchange_ref(lt, rh)
            torch.cuda.synchronize()
            for a, b in zip(got[0] + got[1], want[0] + want[1]):
                assert torch.equal(a, b)
    assert halo.ring_exchange_kernel.launches == before + calls


@pytest.mark.parametrize("p,off", [(4, 6), (8, 0)])
def test_halo_fir_dma_on_card_matches_fir_same_iq(cuda, p, off):
    """The halo FIR on P virtual ranks of one card, both exchanges: one ring
    launch ('dma') and one FIR launch a rank; bit-equal to `fir_same_iq`
    of the whole block."""
    import numpy as np
    from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
    from dl_ofdm_tpu_torch.parallel import halo
    g = torch.Generator(device=cuda).manual_seed(p)
    x = torch.randn(64, p * 560, 2, device=cuda, generator=g)
    h = torch.randn(64, 13, 2, device=cuda, generator=g)
    whole = fir_same_iq(x, h, np.full(64, off))
    for exchange in ("ppermute", "dma"):
        rings = halo.ring_exchange_kernel.launches
        firs = tpk.fir_shift_accum_kernel.launches
        out = halo.halo_fir_same_iq(list(torch.chunk(x, p, dim=1)), h, off,
                                    [cuda] * p, exchange=exchange)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(out, dim=1), whole), exchange
        assert halo.ring_exchange_kernel.launches - rings == (
            exchange == "dma")
        assert tpk.fir_shift_accum_kernel.launches - firs == p


def test_ring_exchange_across_cards(cuda):
    """One rank a card with peer access, one launch a card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("the cross-card ring needs two or more CUDA devices; "
                    f"this machine has {n}")
    from dl_ofdm_tpu_torch.parallel import halo
    devs = [torch.device("cuda", i) for i in range(n)]
    for i in range(n):
        for j in (i - 1, i + 1):
            if j % n != i and not halo.enable_peer_access(i, j % n):
                pytest.skip(f"cuda:{i} cannot reach cuda:{j % n}")
    lt, rh = _ring_slices(devs, 64, 6, 6, 560, 0)
    before = halo.ring_exchange_kernel.launches
    got = halo.ring_exchange(lt, rh)
    want = halo.ring_exchange_ref(lt, rh)
    for d in devs:
        torch.cuda.synchronize(d)
    assert halo.ring_exchange_kernel.launches == before + n
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.device == b.device and torch.equal(a, b)


def _sync_all(devs):
    for d in set(devs):
        torch.cuda.synchronize(d)


def _assert_ring_equal(got, want):
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_ring_exchange_graph_replays_with_new_inputs(cuda, p):
    """The ring captured once in a CUDA graph (P virtual ranks of one card,
    the copy template) and replayed 100 times, new shard contents copied
    in before each replay and nothing reset: every replay bit-equal to
    the plain version of those contents; the capture is one launch."""
    from dl_ofdm_tpu_torch.parallel import halo
    g = torch.Generator(device=cuda).manual_seed(p)
    shards = [torch.randn(64, 560, 2, device=cuda, generator=g)
              for _ in range(p)]
    lt = [x[:, -6:, :] for x in shards]
    rh = [x[:, :6, :] for x in shards]
    halo.ring_exchange_kernel(lt, rh)       # warm-up: build and load
    torch.cuda.synchronize()
    before = halo.ring_exchange_kernel.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = halo.ring_exchange_kernel(lt, rh)
    assert halo.ring_exchange_kernel.launches == before + 1
    for _ in range(100):
        for x in shards:
            x.normal_(generator=g)
        graph.replay()
        _assert_ring_equal(got, halo.ring_exchange_ref(lt, rh))


@pytest.mark.parametrize("p,off", [(4, 6), (8, 0)])
def test_halo_fir_dma_graph_matches_fir_same_iq(cuda, p, off):
    """`halo_fir_same_iq(exchange='dma')` on P virtual ranks captured in a
    CUDA graph as it stands, replayed with new blocks and kernels: each
    replay bit-equal to `fir_same_iq` of the whole block."""
    import numpy as np
    from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
    from dl_ofdm_tpu_torch.parallel import halo
    g = torch.Generator(device=cuda).manual_seed(10 + p)
    x = torch.randn(64, p * 560, 2, device=cuda, generator=g)
    h = torch.randn(64, 13, 2, device=cuda, generator=g)
    shards = list(torch.chunk(x, p, dim=1))
    halo.halo_fir_same_iq(shards, h, off, [cuda] * p, exchange="dma")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = halo.halo_fir_same_iq(shards, h, off, [cuda] * p,
                                    exchange="dma")
    for _ in range(5):
        x.normal_(generator=g)
        h.normal_(generator=g)
        graph.replay()
        assert torch.equal(torch.cat(out, dim=1),
                           fir_same_iq(x, h, np.full(64, off)))


def test_ring_exchange_across_cards_in_graphs_and_back_to_back(cuda):
    """One rank a card (the handshake template): 20 eager calls issued
    back to back with new inputs and no host sync, each bit-equal to the
    plain version; then one graph a card holding that card's part, all
    replayed together 100 times with new inputs, each replay bit-equal."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("the cross-card ring needs two or more CUDA devices; "
                    f"this machine has {n}")
    from dl_ofdm_tpu_torch.parallel import halo
    devs = [torch.device("cuda", i) for i in range(n)]
    for i in range(n):
        for j in (i - 1, i + 1):
            if j % n != i and not halo.enable_peer_access(i, j % n):
                pytest.skip(f"cuda:{i} cannot reach cuda:{j % n}")
    gens = [torch.Generator(device=d).manual_seed(i)
            for i, d in enumerate(devs)]
    shards = [torch.randn(64, 560, 2, device=d, generator=g)
              for d, g in zip(devs, gens)]
    lt = [x[:, -6:, :] for x in shards]
    rh = [x[:, :6, :] for x in shards]

    def refill():
        for x, g in zip(shards, gens):
            x.normal_(generator=g)

    before = halo.ring_exchange_kernel.launches
    runs = []
    for _ in range(20):
        refill()
        runs.append((halo.ring_exchange(lt, rh),
                     halo.ring_exchange_ref(lt, rh)))
    _sync_all(devs)
    assert halo.ring_exchange_kernel.launches == before + 20 * n
    for got, want in runs:
        _assert_ring_equal(got, want)
    recv = halo.ring_buffers(lt, rh)
    graphs = []
    for d in devs:
        with torch.cuda.device(d):
            # a capture stream of this card (torch's default one lives on
            # the card that first captured)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(d)):
                halo.ring_exchange_kernel(lt, rh, out=recv, device=d)
            graphs.append(graph)
    for _ in range(100):
        refill()
        for d, graph in zip(devs, graphs):
            with torch.cuda.device(d):
                graph.replay()
        want = halo.ring_exchange_ref(lt, rh)
        _sync_all(devs)
        _assert_ring_equal(recv, want)


@pytest.mark.parametrize("m,k,f", [(6944, 640, 512), (511, 640, 512),
                                   (3584, 640, 512), (1001, 77, 50),
                                   (370, 5000, 64)])
def test_complex_dense_bf16_tensor_core_kernel(cuda, m, k, f):
    """The bf16 mode's pack and tensor-core GEMM (csrc/complex_dense_bf16.cu)
    at the nfft-512 shapes, ragged with odd K (x by cp.async) and K =
    5,000: the packed weight bit-equal to `pack_stacked_weight_ref`, y
    within 1e-5 of the plain version, a second call on the same inputs
    bit-equal, one pack and one GEMM launch counted a call and none of the
    float32 mode's."""
    g = torch.Generator(device=cuda).manual_seed(k + f)
    x = torch.randn(m, k, 2, device=cuda, generator=g)
    wr, wi = (torch.randn(k, f, device=cuda, generator=g) / k ** 0.5
              for _ in range(2))
    ws = tpk.pack_stacked_weight_kernel(wr, wi)
    assert torch.equal(ws.view(torch.int16),
                       tpk.pack_stacked_weight_ref(wr, wi).view(torch.int16))
    k_, p_ = tpk.complex_dense_kernel, tpk.pack_stacked_weight_kernel
    before = (k_.launches, k_.launches_bf16, p_.launches)
    y = k_(x, wr, wi, "bfloat16")
    y2 = k_(x, wr, wi, "bfloat16")
    torch.cuda.synchronize()
    assert (k_.launches, k_.launches_bf16, p_.launches) == (
        before[0], before[1] + 2, before[2] + 2)
    assert torch.equal(y, y2)
    torch.testing.assert_close(
        y, tpk.complex_dense_ref(x, wr, wi, "bfloat16"), atol=1e-5,
        rtol=1e-5)


def _baseline_draws(link, b: int, seed: int) -> dict:
    """One batch's draws of `MatlabLink` on EVA (static), made on the CPU."""
    g = torch.Generator().manual_seed(seed)
    plan = link.plan
    return {"sym_idx": torch.randint(0, link.m, (b, plan.frame_size),
                                     generator=g),
            "z": torch.randn(b, link.profile.n_taps, 2, generator=g) / 2**0.5,
            "unit_noise": torch.randn(b, plan.nsymbol,
                                      plan.samples_per_symbol, 2,
                                      generator=g)}


@pytest.mark.parametrize("eq_idx", [1, 5, 10])
def test_baseline_run_point_on_card_matches_cpu(cuda, eq_idx):
    """`run_point` on the card against the CPU on the same draws: one
    `fir_shift_accum` launch a batch (and one for id 10's ensemble), bit
    errors within 1 per 10,000 bits (id 5: within 5, the first
    symbol's ill-conditioned solve; see tests/test_torch_baselines.py)."""
    from dl_ofdm_tpu_torch.baselines import classical_rx as crx
    from dl_ofdm_tpu_torch.baselines.matlab_link import MatlabLink
    from dl_ofdm_tpu_torch.config import OFDMConfig
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    plan = build_plan(OFDMConfig())
    n, batch = 1024, 512
    draws = [_baseline_draws(MatlabLink(plan, 2, "EVA"), batch, i)
             for i in range(3)]
    draws = draws if eq_idx == 10 else draws[1:]
    out = {}
    for dev in ("cpu", cuda):
        link = MatlabLink(plan, 2, "EVA", device=dev)
        ctx = crx.get_context(plan, "EVA", dev)
        torch.cuda.synchronize()
        before = tpk.fir_shift_accum_kernel.launches
        moved = ({k: v.to(dev) for k, v in d.items()} for d in draws)
        out[str(dev)] = crx.run_point(link, ctx, eq_idx, None, 20.0, n,
                                      batch=batch, draws=moved)
        torch.cuda.synchronize()
        launches = tpk.fir_shift_accum_kernel.launches - before
        assert launches == (0 if dev == "cpu" else len(draws))
    bits = n * plan.frame_size
    per = 5 if eq_idx == 5 else 1
    (ber_c, ser_c), (ber_g, ser_g) = out["cpu"], out[str(cuda)]
    assert abs(ber_c - ber_g) * bits <= max(1, per * bits / 10000)
    assert abs(ser_c - ser_g) * bits <= max(1, per * bits / 10000)


@pytest.mark.parametrize("b,n", [(2000, 16), (7, 64)])
def test_solve_iq_on_card_matches_cpu(cuda, b, n):
    from dl_ofdm_tpu_torch.ops import cfloat
    g = torch.Generator().manual_seed(n)
    a = torch.randn(b, n, n, 2, generator=g)
    a[..., 0] += n * torch.eye(n)
    rhs = torch.randn(b, n, 2, generator=g)
    want = cfloat.solve_iq(a, rhs)
    got = cfloat.solve_iq(a.to(cuda), rhs.to(cuda))
    torch.cuda.synchronize()
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("fn,chan,rate", [
    ("rayleigh_channel_legacy", "ETU", 0.96e6),
    ("rayleigh_channel_batch_coherent", "ETU", 1e7)])
def test_legacy_channel_fir_on_card_bit_equal_to_plain(cuda, fn, chan, rate):
    """One `fir_shift_accum` launch a legacy channel call (6 and 51 taps),
    its FIR bit-equal to the kernel's plain version on the same planes."""
    import numpy as np
    import torch.nn.functional as F
    from dl_ofdm_tpu_torch.channel import fir, legacy
    g = torch.Generator(device=cuda).manual_seed(24)
    b, l_out = 3000, 560
    x = torch.randn(b, 7, 80, 2, device=cuda, generator=g)
    coeff = torch.from_numpy(legacy.legacy_tap_coeff(chan, rate, l_out)).to(
        cuda)
    f = coeff.shape[0]
    before = tpk.fir_shift_accum_kernel.launches
    if fn == "rayleigh_channel_legacy":
        taps = torch.randn(b, f, 2, device=cuda, generator=g)
        y = legacy.rayleigh_channel_legacy(x, 64, chan, rate,
                                           unit_taps=taps)[0]
        h, off = taps / 2 ** 0.5 * coeff[None, :, None], (f - 1) // 2
    else:
        taps = torch.randn(f, 2, device=cuda, generator=g)
        y = legacy.rayleigh_channel_batch_coherent(
            x, torch.full((b,), 10.0, device=cuda), chan, rate,
            unit_taps=taps, unit_noise=torch.zeros(b, l_out, 2,
                                                   device=cuda))[0]
        h = torch.flip(taps / 2 ** 0.5 * coeff[:, None], (0,))[None].expand(
            b, f, 2)
        off = f - 1 - (f - 1) // 2
    torch.cuda.synchronize()
    assert tpk.fir_shift_accum_kernel.launches == before + 1
    flat = x.reshape(b, l_out, 2)
    xa = [fir._prealign_plane(F.pad(flat[..., i], (f - 1, f - 1)),
                              np.full((b,), off), l_out + f - 1).contiguous()
          for i in (0, 1)]
    wr, wi = tpk.fir_shift_accum_ref(*xa, h[..., 0].contiguous(),
                                     h[..., 1].contiguous(), l_out)
    assert torch.equal(y.reshape(b, l_out, 2), torch.stack([wr, wi], -1))


def test_tensor_parallel_gradients_on_card(cuda):
    """nfft 256 on dp 2 x tp 2 virtual ranks of the card: the mesh step's
    gradients (split leaves gathered) against the single-device ones on
    the same batch, rtol 2e-4, atol 1e-6 (`tests/test_parallel.py:312`);
    `fft_like` runs the float32 kernel once a rank."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from dl_ofdm_tpu_torch.train.loop import Trainer
    cfg = OFDMConfig(nbits=1, nfft=256, nfilter=256)
    tc = TrainConfig(snr=5.0, batch_size=112, msg_length=224)
    tr = Trainer(cfg, tc, channel="ETU", mesh=make_mesh([cuda] * 4, dp=2,
                                                        tp=2))
    single = Trainer(cfg, tc, channel="ETU", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(25)
    state = tr.init_state(g)
    b = tr.batch_frames
    bits, rx, _, _, _ = single.synthesize(b, torch.full((b,), 5.0,
                                                        device=cuda), g)
    before = tpk.complex_dense_kernel.launches
    tb, tx = shard_batch(tr.mesh, (bits, rx))
    _, aux = tr._mesh_step(state, tb, tx, [{}] * 2,
                           torch.tensor(0.0, device=cuda), return_grads=True)
    torch.cuda.synchronize()
    assert tpk.complex_dense_kernel.launches == before + 4
    got = tr._gathered(aux["grads"])
    train = {k: v.clone().requires_grad_() for k, v in state.params.items()}
    loss, _ = single._loss_fn(train, bits, rx)
    want = dict(zip(train, torch.autograd.grad(loss, list(train.values()))))
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=2e-4, atol=1e-6, msg=k)


def test_ring_exchange_across_processes_through_ipc(cuda, tmp_path):
    """The ring's IPC route (`ring_ipc_alloc` / `ring_ipc_open`,
    `ring_exchange_across`): two processes on one card, two ranks each,
    every exchange bit-equal to the plain version over the whole ring at
    two shapes (the epochs advance over repeated calls), and the halo FIR
    bit-equal to `fir_same_iq`; one launch a process a call."""
    import socket
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_dist_worker as W
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(W.ipc_ring_worker,
                                args=(2, port, str(tmp_path)), nprocs=2,
                                join=True)
    for r in range(2):
        out = torch.load(tmp_path / f"rank{r}.pt")
        assert out["equal"] == [True] * 5, out
        assert out["launches"] == 5
