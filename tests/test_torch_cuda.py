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


def test_library_is_built_under_build_dir(cuda):
    cuda_build.load("complex_dense")
    path = cuda_build.library_path("complex_dense")
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.isfile(path)
