"""Tests of the port that need a CUDA card (marker `cuda`); they skip where
there is none.  This file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: `tests/conftest.py` imports JAX.)"""
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
                                   (1, 1, 1), (130, 33, 129)])
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


@pytest.mark.parametrize("name", sorted(cuda_build.SOURCES))
def test_library_is_built_under_build_dir(cuda, name):
    cuda_build.load(name)
    path = cuda_build.library_path(name)
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.isfile(path)


def _synth_spec(channel, nbits):
    from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
    from dl_ofdm_tpu_torch.config import OFDMConfig
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    from dl_ofdm_tpu_torch.ops.fused_synth import build_synth_spec
    plan = build_plan(OFDMConfig(nbits=nbits))
    ch = RayleighChannel(channel=channel, nfft=64,
                         sample_rate=plan.sample_rate)
    return build_synth_spec(plan, [None if ch._passthrough[i] else p
                                   for i, p in enumerate(ch.profiles)], nbits)


@pytest.mark.parametrize("channel,nbits,n", [("ETU", 1, 37), ("AWGN", 4, 5),
                                             ("mixAll", 2, 33)])
def test_fused_synth_kernel_matches_plain_version(cuda, channel, nbits, n):
    """Same Philox words: indices equal, planes to 1e-4 (log and sincos
    differ by a few ulp between the kernel and torch), sums to 1e-5."""
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    spec = _synth_spec(channel, nbits)
    seeds = torch.tensor([123, 2**32 - 5], dtype=torch.int64, device=cuda)
    std = tfs.noise_std(torch.linspace(0, 20, n, device=cuda))
    before = tfs.fused_synthesize_kernel.launches
    got = tfs.fused_synthesize_kernel(spec, seeds, std)
    want = tfs.fused_synthesize_ref(spec, n, std, seeds=seeds)
    torch.cuda.synchronize()
    assert tfs.fused_synthesize_kernel.launches == before + 1
    assert got[5].shape == (-(-n // tfs.ROWS_PER_CTA), 10, spec.length)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:5], want[1:5]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    torch.testing.assert_close(got[5].sum(0), want[5][0], atol=1e-3,
                               rtol=1e-5)


@pytest.mark.parametrize("nbits,dtype", [(1, "float32"), (4, "float32"),
                                         (1, "bfloat16"), (3, "bfloat16")])
def test_fused_model_kernel_matches_plain_version(cuda, nbits, dtype):
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
    from dl_ofdm_tpu_torch.ops import fused_model as tfm
    n, S, P = 50, 7, 80
    g = torch.Generator(device=cuda).manual_seed(nbits)
    rx = DCCNReceiver(nbits=nbits, nfft=64, cp_len=16, nfilter=64,
                      frame_size=320).to(cuda)
    rx.reset_parameters(g)
    params = {k: v.detach() + 0.05 * torch.randn(v.shape, device=cuda,
                                                  generator=g)
              for k, v in rx.state_dict().items()}
    planes = [torch.randn(n, S * P, device=cuda, generator=g)
              for _ in range(4)]
    c = 0.5 + torch.rand(6, S * P, device=cuda, generator=g)
    idx = torch.randint(0, 2 ** nbits, (n, 320), device=cuda, generator=g,
                        dtype=torch.int32)
    spec = tfm.ModelSpec(nsymbol=S, sps=P, nfilter=64, frame_size=320,
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


def test_train_step_fused_on_card(cuda):
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import fused_model as tfm
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=700),
                 channel="ETU")
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
