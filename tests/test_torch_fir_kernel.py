"""The port's `fir_shift_accum` against the JAX package's Pallas kernel (in
interpret mode on the CPU, as `tests/test_models.py` runs it) and against
`np.convolve`, and `fir_same_iq` on the CPU against JAX.  The CUDA kernel
itself is held against the plain version in `tests/test_torch_cuda.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel import fir as jfir
from dl_ofdm_tpu.ops.pallas_kernels import fir_shift_accum as jfir_accum
from dl_ofdm_tpu_torch.channel import fir as tfir
from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk


def _inputs(rng, b, l, f):
    xa = rng.normal(size=(b, l + f - 1, 2)).astype(np.float32)
    h = rng.normal(size=(b, f, 2)).astype(np.float32)
    return xa, h


@pytest.mark.parametrize("b,l,f", [(6, 97, 13), (3, 40, 1), (70, 33, 5)])
def test_fir_shift_accum_ref_matches_pallas_and_convolve(b, l, f, rng):
    xa, h = _inputs(rng, b, l, f)
    got = torch.stack(tpk.fir_shift_accum(
        *(torch.from_numpy(np.ascontiguousarray(a[..., i]))
          for a in (xa, h) for i in (0, 1)), l), dim=-1).numpy()
    want = np.asarray(jfir_accum(jnp.asarray(xa), jnp.asarray(h), l))
    assert got.shape == (b, l, 2)
    # the same float32 operations in the same order: equal to rounding
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    xc = xa[..., 0] + 1j * xa[..., 1]
    hc = h[..., 0] + 1j * h[..., 1]
    conv = np.stack([np.convolve(xc[i], hc[i], mode="valid")
                     for i in range(b)])
    # float32 against numpy's float64 sums over up to 13 taps
    np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], conv,
                               rtol=1e-4, atol=1e-4)


def test_fir_shift_accum_planes_take_the_plain_version_on_the_cpu(rng):
    xa, h = _inputs(rng, 4, 50, 7)
    before = tpk.fir_shift_accum_kernel.launches
    yr, yi = tpk.fir_shift_accum(
        *(torch.from_numpy(np.ascontiguousarray(a[..., i]))
          for a in (xa, h) for i in (0, 1)), 50)
    assert tpk.fir_shift_accum_kernel.launches == before
    want = tpk.fir_shift_accum_ref(
        *(torch.from_numpy(np.ascontiguousarray(a[..., i]))
          for a in (xa, h) for i in (0, 1)), 50)
    assert torch.equal(yr, want[0]) and torch.equal(yi, want[1])


def test_fir_shift_accum_kernel_refuses_cpu_tensors():
    t = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.fir_shift_accum_kernel(t, t, torch.zeros(2, 3),
                                   torch.zeros(2, 3), 8)


@pytest.mark.parametrize("offsets", [
    np.full(8, 6, np.int32),                              # ETU: one offset
    np.asarray([0, 6, 4, 3, 0, 6, 4, 3], np.int32)])      # mixRayleigh
def test_fir_same_iq_on_the_cpu_matches_jax(offsets, rng):
    """The sweep's frame length (560) with 13 taps; the mixed offsets are
    the four profiles of mixRayleigh with zero-padded short kernels."""
    x = rng.normal(size=(8, 560, 2)).astype(np.float32)
    h = rng.normal(size=(8, 13, 2)).astype(np.float32)
    for i, off in enumerate(offsets):
        h[i, 2 * off + 1:] = 0.0
    want = np.asarray(jfir.fir_same_iq(jnp.asarray(x), jnp.asarray(h),
                                       offsets))
    got = tfir.fir_same_iq(torch.from_numpy(x), torch.from_numpy(h),
                           offsets).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# the sweep's and the curriculum's shapes, odd rows, long taps, rows cut
# into chunks, a frame of nfft 128
FIR_PLAN_SHAPES = [(30000, 560, 13), (73, 560, 9), (5, 1120, 1),
                   (9, 40, 300), (37, 561, 13), (1001, 560, 40),
                   (3, 5000, 13), (2340, 1120, 13), (1, 1, 1)]


@pytest.mark.parametrize("b,l,f", FIR_PLAN_SHAPES)
def test_fir_plan_fits_a_block_and_fills_the_card(b, l, f):
    """The CUDA kernel's launch plan: its units hold every row and output
    once, a block's threads cover its rows' 8-output groups in whole warps
    within 384, the double-buffered rows fit shared memory (two blocks a
    SM where more than one row is staged), the skewed row pitch holds a
    row and is 9 G mod 32, and the grid is as large as the card holds or
    the units there are."""
    plan = tpk.fir_plan(b, l, f)
    assert plan.tile == min(l, tpk.FIR_TILE_MAX)
    assert plan.tile == l or plan.tile % 8 == 0
    g = -(-plan.tile // 8)
    assert plan.threads % 32 == 0
    assert plan.rows * g <= plan.threads <= tpk.FIR_THREADS_MAX
    assert plan.threads - plan.rows * g < 32
    chunks = -(-l // plan.tile)
    assert plan.units == -(-b // plan.rows) * chunks
    width = 8 + 8 * g + f - 1
    assert plan.row_stride >= width + (width - 1) // 8
    assert (plan.row_stride - 9 * g) % 32 == 0
    assert plan.smem_bytes == 4 * tpk.FIR_NBUF * (
        2 * plan.rows * plan.row_stride + 2 * plan.rows * f)
    assert plan.smem_bytes <= 232448
    if plan.rows > 1:           # two blocks, each with 1 KB reserved
        assert 2 * (plan.smem_bytes + 1024) <= 233472
    assert plan.grid == min(plan.units, 132 * 2)
