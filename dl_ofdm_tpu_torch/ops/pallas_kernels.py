"""The hand-written Hopper kernels that replace the JAX package's Pallas
kernels, each beside its plain PyTorch version.

Port of `dl_ofdm_tpu/ops/pallas_kernels.py` (the module keeps its name so
its counterpart is easy to find).  This slice ports `complex_dense`, the
learned-DFT complex matmul y = x @ (wr + i wi) of the DCCN's `fft_like`
layer:

  * `complex_dense_kernel` launches the CUDA kernel
    (`csrc/complex_dense.cu`, built by `ops/cuda_build.py`) on a CUDA
    tensor and counts its launches in `complex_dense_kernel.launches`;
  * `complex_dense_ref` is the plain version: four `torch.matmul`s and the
    recombination;
  * `complex_dense` is the differentiable op (`ComplexDenseFn`): the kernel
    for CUDA tensors, the plain version for CPU tensors, and the backward
    pass of `_cdense_bwd` (`pallas_kernels.py:108-119`) as plain matmuls,
    as in JAX.

There is no fallback: a CUDA tensor goes through the kernel, and a failed
build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dl_ofdm_tpu_torch.ops import cuda_build


def complex_dense_ref(x_iq: torch.Tensor, wr: torch.Tensor,
                      wi: torch.Tensor) -> torch.Tensor:
    """[..., K, 2] x ([K, F], [K, F]) -> [..., F, 2], plain PyTorch."""
    xr, xi = x_iq[..., 0], x_iq[..., 1]
    yr = torch.matmul(xr, wr) - torch.matmul(xi, wi)
    yi = torch.matmul(xr, wi) + torch.matmul(xi, wr)
    return torch.stack([yr, yi], dim=-1)


@functools.cache
def _complex_dense_fn():
    fn = cuda_build.load("complex_dense").complex_dense_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def complex_dense_kernel(x_iq: torch.Tensor, wr: torch.Tensor,
                         wi: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x [M, K, 2], wr/wi [K, F] -> y [M, F, 2], all
    contiguous float32 on one CUDA device.  Raises on anything else."""
    if not (x_iq.is_cuda and wr.device == x_iq.device
            and wi.device == x_iq.device):
        raise ValueError("complex_dense_kernel: x, wr and wi must be on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in (x_iq, wr, wi)):
        raise TypeError("complex_dense_kernel takes float32 tensors")
    if x_iq.dim() != 3 or x_iq.shape[2] != 2 or wr.dim() != 2 \
            or wr.shape != wi.shape or wr.shape[0] != x_iq.shape[1]:
        raise ValueError(
            f"complex_dense_kernel: shapes x {tuple(x_iq.shape)}, wr "
            f"{tuple(wr.shape)}, wi {tuple(wi.shape)}; want [M, K, 2], "
            "[K, F], [K, F]")
    if not (x_iq.is_contiguous() and wr.is_contiguous()
            and wi.is_contiguous()) or x_iq.data_ptr() % 8:
        raise ValueError("complex_dense_kernel takes contiguous tensors "
                         "(x aligned to its IQ pairs)")
    m, k, _ = x_iq.shape
    f = wr.shape[1]
    if max(m, k, f) >= 2**31:
        raise ValueError("complex_dense_kernel: sizes overflow int32")
    y = torch.empty(m, f, 2, device=x_iq.device, dtype=torch.float32)
    if m == 0 or f == 0:    # an empty grid is an invalid launch
        return y
    with torch.cuda.device(x_iq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _complex_dense_fn()(x_iq.data_ptr(), wr.data_ptr(),
                                  wi.data_ptr(), y.data_ptr(), m, k, f,
                                  stream)
    if err != 0:
        raise RuntimeError(f"complex_dense kernel launch failed: CUDA error "
                           f"{err}")
    complex_dense_kernel.launches += 1
    return y


complex_dense_kernel.launches = 0


class ComplexDenseFn(torch.autograd.Function):
    """y = x @ (wr + i wi) on [M, K, 2]; the backward pass is `_cdense_bwd`
    (`dl_ofdm_tpu/ops/pallas_kernels.py:108-119`), four real-pair products."""

    @staticmethod
    def forward(ctx, x_iq, wr, wi):
        ctx.save_for_backward(x_iq, wr, wi)
        if x_iq.device.type == "cpu":
            return complex_dense_ref(x_iq, wr, wi)
        return complex_dense_kernel(x_iq, wr, wi)

    @staticmethod
    def backward(ctx, g):
        x_iq, wr, wi = ctx.saved_tensors
        xr, xi = x_iq[..., 0], x_iq[..., 1]
        gr, gi = g[..., 0], g[..., 1]
        dx = torch.stack([gr @ wr.T + gi @ wi.T, -gr @ wi.T + gi @ wr.T],
                         dim=-1)
        dwr = xr.T @ gr + xi.T @ gi
        dwi = xr.T @ gi - xi.T @ gr
        return dx, dwr, dwi


def complex_dense(x_iq: torch.Tensor, wr: torch.Tensor,
                  wi: torch.Tensor) -> torch.Tensor:
    """[..., K, 2] x ([K, F], [K, F]) -> [..., F, 2], differentiable: the
    counterpart of JAX's `complex_dense_iq`."""
    lead = x_iq.shape[:-2]
    k = x_iq.shape[-2]
    y = ComplexDenseFn.apply(x_iq.reshape(-1, k, 2).contiguous(), wr, wi)
    return y.reshape(*lead, wr.shape[1], 2)
