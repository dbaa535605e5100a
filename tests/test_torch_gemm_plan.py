"""The launch plans of the port's two GEMM kernels, in the plain Python that
the wrappers hand to the card (`dl_ofdm_tpu_torch/ops/fused_model.py`
`model_plan`, `dl_ofdm_tpu_torch/ops/pallas_kernels.py`
`complex_dense_plan` and `complex_dense_bf16_plan`): split-K counts, the
bf16 buffers' padded row pitches that the TMA tensor maps take, and the
persistent `complex_dense` kernels' tiles and grids.  The kernels themselves run only on the
card (`tests/test_torch_cuda.py`)."""
import functools
import os
import re

import pytest

from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.ops import fused_model as tfm
from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk
from dl_ofdm_tpu_torch.train.loop import Trainer

# nfft 64 (sps 80), nfft 128 with the long CP (sps 160) and without (137)
CONFIGS = [{}, {"nfft": 128}, {"nfft": 128, "longcp": False}]
FRAMES = [1, 50, 1001, 2340, 9362, 18724, 37449]   # bench.py's four, edges


@functools.cache
def _spec(cfg_items: tuple, dtype: str = "bfloat16") -> tfm.ModelSpec:
    """The fused model spec `Trainer`'s gate builds for this configuration."""
    tr = Trainer(OFDMConfig(nbits=1, **dict(cfg_items)),
                 TrainConfig(fused_model_matmul_dtype=dtype),
                 channel="ETU", device="cpu")
    assert tr._fused_model_spec is not None
    return tr._fused_model_spec


@pytest.mark.parametrize("b", FRAMES)
@pytest.mark.parametrize("cfg", CONFIGS, ids=["nfft64", "nfft128", "sps137"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_k_ranges_cover_each_row_once(cfg, b, dtype):
    """GEMM 4 sums over frames, GEMM 6 over symbol rows: on the tensor
    cores the splits' runs of `ktps` whole 64-deep k tiles reach every k
    tile and none is empty; on the FMA units a split sums about a thousand
    rows or more."""
    spec = _spec(tuple(cfg.items()), dtype)
    plan = tfm.model_plan(spec, b)
    assert plan.route == ("tensor_core" if dtype == "bfloat16" else "simt")
    for splits, ktps, rows in ((plan.splits_we, plan.ktps_we, b),
                               (plan.splits_w, plan.ktps_w,
                                b * spec.nsymbol)):
        assert splits >= 1
        if plan.route == "tensor_core":
            ktiles = -(-rows // tfm.TC_BK)
            assert (splits - 1) * ktps < ktiles <= splits * ktps
        else:
            assert ktps == 0 and (splits - 1) * 1024 < rows


@pytest.mark.parametrize("b", [2340, 9362, 18724, 37449])
def test_split_k_fills_the_card(b):
    """At bench.py's batch sizes the split GEMMs' output tiles times their
    splits give the 132 SMs at least one block each."""
    spec = _spec(())
    plan = tfm.model_plan(spec, b)
    e2, x2w = 2 * spec.frame_size, spec.nsymbol * 2 * spec.nfilter
    tiles4 = -(-e2 // 128) * -(-x2w // 128)
    tiles6 = -(-2 * spec.sps // 128) * -(-2 * spec.nfilter // 128)
    assert tiles4 * plan.splits_we >= 132
    assert tiles6 * plan.splits_w >= 132


@pytest.mark.parametrize("b", FRAMES)
@pytest.mark.parametrize("cfg", CONFIGS, ids=["nfft64", "nfft128", "sps137"])
def test_bf16_row_pitches_are_16_byte_multiples(cfg, b):
    """Every bf16 GEMM input's row pitch, as its TMA tensor map takes it,
    is a multiple of 16 bytes and holds its row; sps 137 pads the
    normalized input's 274 values to 280."""
    spec = _spec(tuple(cfg.items()))
    plan = tfm.model_plan(spec, b)
    _check_pitches(spec, plan, b)
    assert plan.ldx == (280 if spec.sps == 137 else 2 * spec.sps)
    assert plan.ldf == 2 * spec.nfilter


def _check_pitches(spec, plan, b):
    """The bf16 buffers: each row on a pitch of whole 16 bytes that holds
    it, every run of 2F values (x2 and dX2 also read as [B*S, ldf] rows)
    on the pitch ldf."""
    S, P, F, D = spec.nsymbol, spec.sps, spec.nfilter, spec.frame_size
    shapes = plan.bf16_shapes
    assert shapes == {"xb": (b * S, plan.ldx), "wexpb": (2 * P, plan.ldf),
                      "web": (2 * D, S * plan.ldf), "x2b": (b, S * plan.ldf),
                      "deb": (b, plan.ldd), "dx2b": (b, S * plan.ldf)}
    assert 0 <= plan.ldx - 2 * P < 8 and 0 <= plan.ldd - 2 * D < 8
    assert 0 <= plan.ldf - 2 * F < 8
    pitches = [c for _, c in shapes.values()] + [plan.ldf]
    assert all(2 * c % 16 == 0 for c in pitches)


@pytest.mark.parametrize("nfilter,d", [(30, 320), (33, 320), (1, 7),
                                       (50, 99), (64, 320)])
def test_bf16_route_pads_any_nfilter(nfilter, d):
    """Any width takes the bf16 route: 2F and 2D that are no multiple of 8
    get padded pitches, and GEMM 4's splits count the padded columns'
    tiles."""
    spec = tfm.ModelSpec(nsymbol=7, sps=80, nfilter=nfilter, frame_size=d,
                         nbits=1, matmul_dtype="bfloat16")
    for b in (1, 10, 9362):
        plan = tfm.model_plan(spec, b)
        assert plan.route == "tensor_core"
        _check_pitches(spec, plan, b)
        assert (plan.splits_we, plan.ktps_we) == tfm._tc_split(
            2 * d, 7 * plan.ldf, b)


CD_SHAPES = [(13776, 80, 64), (210000, 64, 64), (65534, 80, 64),
             (1001, 77, 50), (2047, 33, 64), (1, 1, 1), (130, 33, 129),
             (100, 640, 512)]


@pytest.mark.parametrize("m,k,f", CD_SHAPES)
def test_complex_dense_plan_fits_the_card(m, k, f):
    """The persistent grid: its row tiles hold every row once, its blocks
    are no more than the card holds or the items there are, a block keeps
    one feature tile where the grid allows, and the ring and the weight fit
    a block's shared memory."""
    plan = tpk.complex_dense_plan(m, k, f)
    rt = plan.rows_per_tile
    assert rt in (2, 4, 8, 16, 32)
    assert (plan.row_tiles - 1) * rt < m <= plan.row_tiles * rt
    assert plan.f_tiles == -(-f // 64)
    items = plan.row_tiles * plan.f_tiles
    assert 0 < plan.grid <= min(132 * 2, items)
    if plan.grid >= plan.f_tiles:
        assert plan.grid % plan.f_tiles == 0
    assert plan.stage_elems >= rt * k and plan.stage_elems % 2 == 0
    assert plan.smem_bytes == (tpk.CD_BAR_BYTES + 8 * plan.k_chunk * 64
                               + 8 * 3 * plan.stage_elems)
    assert plan.smem_bytes <= tpk.CD_SMEM_BUDGET


@pytest.mark.parametrize("m,k,f", CD_SHAPES)
def test_complex_dense_tiles_suit_bulk_copies(m, k, f):
    """A row tile starts on a 16-byte boundary and, but for the last
    tile's final IQ pair when rows x K is odd, is a multiple of 16 bytes:
    what the bulk copy takes, the rest by an ordinary load."""
    plan = tpk.complex_dense_plan(m, k, f)
    rt = plan.rows_per_tile
    for r in range(plan.row_tiles):
        rows = min(rt, m - r * rt)
        assert (r * rt * k * 8) % 16 == 0
        assert (rows * k * 8) % 16 in ((0,) if r < plan.row_tiles - 1
                                       else (0, 8))
    assert plan.k_chunk == min(k, tpk.CD_KC_MAX)


@pytest.mark.parametrize("k", [2642, 2643, 5000])
def test_complex_dense_plan_marks_k_past_the_ring(k):
    """Past K = 2,642 no ring of three 2-row tiles fits beside the
    weight: the plan says so (`streamed`) and streams 32-row tiles in K
    chunks through one [32, 192] buffer.  Every K has a plan whose shared
    memory fits a block (227 KB), and its tiles hold every row once."""
    plan = tpk.complex_dense_plan(100, k, 64)
    assert plan.streamed == (k > 2642)
    assert plan.k_chunk == tpk.CD_KC_MAX < k
    stages = 1 if plan.streamed else 3
    assert plan.smem_bytes == (tpk.CD_BAR_BYTES + 8 * plan.k_chunk * 64
                               + 8 * stages * plan.stage_elems)
    assert plan.smem_bytes <= tpk.CD_SMEM_BUDGET <= 232448
    rt = plan.rows_per_tile
    if plan.streamed:
        assert rt == 32 and plan.stage_elems == rt * plan.k_chunk
    else:
        assert rt == 2 and plan.stage_elems >= rt * k
    assert (plan.row_tiles - 1) * rt < 100 <= plan.row_tiles * rt


# complex_dense's bf16 mode (csrc/complex_dense_bf16.cu): the nfft-512
# sweep's and training step's shapes, 3,584 rows, ragged and odd K, K past
# 5,000
CDB_SHAPES = [(6944, 640, 512), (511, 640, 512), (3584, 640, 512),
              (1001, 77, 50), (370, 5000, 64), (1, 1, 1), (129, 2, 65)]
CDB_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dl_ofdm_tpu_torch", "csrc",
    "complex_dense_bf16.cu")


def _block_tiles(plan, block: int):
    """The (rows, columns) ranges of y [M, 2F] that block `block` computes,
    as csrc/complex_dense_bf16.cu's `gemm` walks its tiles (unclipped: the
    kernel's stores stop at M and 2F)."""
    out = []
    for t in range(block, plan.tiles, plan.grid):
        m0, n0 = t // plan.n_tiles * tpk.CDB_BM, t % plan.n_tiles * tpk.CDB_BN
        out.append((range(m0, m0 + tpk.CDB_BM), range(n0, n0 + tpk.CDB_BN)))
    return out


@pytest.mark.parametrize("m,k,f", CDB_SHAPES)
def test_complex_dense_bf16_plan_covers_each_output_once(m, k, f):
    """The persistent blocks' tiles, walked as the kernel walks them, hold
    every row of y [M, 2F] and every column exactly once; no more blocks
    than SMs or tiles; x by TMA exactly when K is even (a row pitch of 8K
    bytes, a multiple of 16), the packed weight's pitch 16-byte whole."""
    plan = tpk.complex_dense_bf16_plan(m, k, f)
    assert 0 < plan.grid <= min(132, plan.tiles)
    assert plan.tiles == plan.m_tiles * plan.n_tiles
    assert plan.k_tiles * tpk.CDB_BK >= 2 * k > (plan.k_tiles - 1) * tpk.CDB_BK
    assert plan.tma_x == (k % 2 == 0) == (8 * k % 16 == 0)
    assert plan.ldk >= 2 * k and plan.ldk % 8 == 0 and plan.ldk - 2 * k < 8
    seen = {}
    for b in range(plan.grid):
        tiles = _block_tiles(plan, b)
        assert tiles, f"block {b} has no tile"
        for rows, cols in tiles:
            assert (len(rows), len(cols)) == (tpk.CDB_BM, tpk.CDB_BN)
            assert (rows.start, cols.start) not in seen
            seen[rows.start, cols.start] = b
    cover_r = sorted({r for r, _ in seen})
    cover_c = sorted({c for _, c in seen})
    assert cover_r == list(range(0, m, tpk.CDB_BM))
    assert cover_c == list(range(0, 2 * f, tpk.CDB_BN))
    assert len(seen) == plan.tiles == len(cover_r) * len(cover_c)


def test_complex_dense_bf16_plan_mirrors_the_source():
    """The plan's tile, depth, stages and shared bytes are the source's
    constants, and the shared bytes fit a Hopper block (232,448)."""
    src = open(CDB_SOURCE).read()
    const = {n: int(v) for n, v in re.findall(r"\b(BM|BN|BK|ST) = (\d+)",
                                               src)}
    assert const == {"BM": tpk.CDB_BM, "BN": tpk.CDB_BN, "BK": tpk.CDB_BK,
                     "ST": tpk.CDB_STAGES}
    stage = tpk.CDB_BM * tpk.CDB_BK * 4 + tpk.CDB_BN * tpk.CDB_BK * 2
    assert tpk.CDB_SMEM == tpk.CDB_STAGES * stage + 1024 + 64
    assert tpk.CDB_SMEM <= 232448
    plan = tpk.complex_dense_bf16_plan(6944, 640, 512)
    assert (plan.m_tiles, plan.n_tiles, plan.grid) == (55, 8, 132)


@pytest.mark.parametrize("k", [1, 2, 3, 77, 640, 5000])
def test_packed_weight_pitch_and_layout(k):
    """`pack_stacked_weight_ref`: [2F, stacked_pitch(K)] bf16, zeros past
    2K, each 2 x 2 block of (wr, -wi; wi, wr) rounded to bf16."""
    import torch
    g = torch.Generator().manual_seed(k)
    wr, wi = torch.randn(k, 3, generator=g), torch.randn(k, 3, generator=g)
    ws = tpk.pack_stacked_weight_ref(wr, wi)
    assert ws.dtype == torch.bfloat16
    assert ws.shape == (6, tpk.stacked_pitch(k))
    assert tpk.stacked_pitch(k) == -(-2 * k // 8) * 8
    assert torch.all(ws[:, 2 * k:] == 0)
    rb, ib = wr.to(torch.bfloat16), wi.to(torch.bfloat16)
    for kk in range(k):
        for ff in range(3):
            blk = ws[2 * ff:2 * ff + 2, 2 * kk:2 * kk + 2]
            want = torch.stack([torch.stack([rb[kk, ff], -ib[kk, ff]]),
                                torch.stack([ib[kk, ff], rb[kk, ff]])])
            assert torch.equal(blk, want)
