"""The DCCN receiver's forward pass, loss and backward pass in one kernel.

Port of `dl_ofdm_tpu/ops/fused_model.py` (the TPU kernel `_kernel`,
`pallas_call` at `fused_model.py:417`) in its training form,
`fuse_norm=True`: the inputs are the raw planes of the fused synthesize
kernel with the per-position affine that normalizes them.

  x [B, S, P, 2] -> fft_like (complex dense P -> F) -> flatten
    -> Dense_extract (2D) -> per-position Dense_conv1x1 (C = 2^nbits)
    -> leaky(0.2) -> concat IQ -> Dense_llr (2 nbits) -> leaky -> logits

Loss: the mean 2-class CE over every bit in its sigmoid form, ce =
y softplus(-t) + (1 - y) softplus(t), dt = sigmoid(t) - y, t = l1 - l0.
The L2 term's gradient is added by the caller (`reg_grads`).

  * `dccn_fused_grads_kernel` launches the CUDA kernels of
    `csrc/fused_model.cu` and counts its calls: with bfloat16 GEMM inputs
    its GEMMs run on the tensor cores, with float32 on the FMA units;
    `model_plan` is its launch plan (split counts, the bf16 buffers'
    padded pitches) in plain Python;
  * `dccn_fused_grads_ref` is the plain version: the same math, layouts
    and bfloat16 rounding in explicit torch operations;
  * `dccn_fused_grads` runs the kernel for CUDA tensors and the plain
    version for CPU tensors.

Parameters and gradients are `DCCNReceiver.state_dict()` dictionaries.
Inside, the flattened fft output keeps flax's interleaved layout
(s*F + f)*2 + iq and the extract output d*2 + iq, so the weights need no
permutation (the TPU kernel's `_perms` are a Mosaic layout matter).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from dl_ofdm_tpu_torch.ops import cuda_build

PARAM_KEYS = ("fft_like.wr", "fft_like.wi", "fft_like.br", "fft_like.bi",
              "Dense_extract.weight", "Dense_extract.bias",
              "Dense_conv1x1.weight", "Dense_conv1x1.bias",
              "Dense_llr.weight", "Dense_llr.bias")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Shapes and GEMM input type of the fused DCCN gradient."""
    nsymbol: int          # S
    sps: int              # P = samples per symbol (K + CP)
    nfilter: int          # F
    frame_size: int       # D
    nbits: int            # n; C = 2**n conv1x1 channels
    matmul_dtype: str = "float32"   # 'float32' | 'bfloat16' GEMM inputs,
                                    # float32 sums either way

    def __post_init__(self):
        if self.matmul_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"matmul_dtype {self.matmul_dtype!r}")
        if not 1 <= self.nbits <= 4:
            raise ValueError("nbits must be in 1..4")


def _leaky(x):
    return torch.where(x >= 0, x, 0.2 * x)


def _dleaky(pre):
    return torch.where(pre >= 0, 1.0, 0.2)


def _softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def normalize_planes(spec: ModelSpec, yr, yi, nr, ni, cvec):
    """The receiver input from raw planes: [B*S, 2P] rows (real samples of
    a symbol, then its imaginary samples)."""
    b = yr.shape[0]
    xr = yr * cvec[0] + nr * cvec[1] - cvec[2]
    xi = yi * cvec[3] + ni * cvec[4] - cvec[5]
    shape = (b * spec.nsymbol, spec.sps)
    return torch.cat([xr.reshape(shape), xi.reshape(shape)], dim=1)


def _expanded_weight(wr, wi):
    """fft_like as a real [2P, 2F] matrix, columns interleaved f*2 + iq."""
    top = torch.stack([wr, wi], -1).reshape(wr.shape[0], -1)
    bottom = torch.stack([-wi, wr], -1).reshape(wr.shape[0], -1)
    return torch.cat([top, bottom], 0)


def _fold_expanded(g, p):
    """[2P, 2F] gradient of the expanded weight -> (dwr, dwi) [P, F]."""
    return (g[:p, 0::2] + g[p:, 1::2], g[:p, 1::2] - g[p:, 0::2])


def _confusion(n11, sy, sp, total):
    n10, n01 = sy - n11, sp - n11
    return torch.stack([torch.stack([total - n11 - n10 - n01, n01]),
                        torch.stack([n10, n11])]).to(torch.int64)


def _matmul(spec: ModelSpec):
    """The GEMM of the given input type: bfloat16 rounds both inputs
    (nearest even), float32 sums either way."""
    if spec.matmul_dtype == "bfloat16":
        def rnd(t):
            return t.to(torch.bfloat16).to(torch.float32)
    else:
        def rnd(t):
            return t
    return lambda a, b: torch.matmul(rnd(a), rnd(b))


def dccn_forward_ref(spec: ModelSpec, params: dict, yr, yi, nr, ni, cvec):
    """The plain version's forward GEMMs: (x [B*S, 2P] normalized input,
    x2 [B, S*2F] fft_like output, e [B, 2D] Dense_extract output)."""
    mm = _matmul(spec)
    fb = torch.stack([params["fft_like.br"], params["fft_like.bi"]], -1)
    x = normalize_planes(spec, yr, yi, nr, ni, cvec)
    x2 = mm(x, _expanded_weight(params["fft_like.wr"],
                                params["fft_like.wi"])) + fb.reshape(-1)
    x2 = x2.reshape(yr.shape[0], -1)
    e = mm(x2, params["Dense_extract.weight"].T) \
        + params["Dense_extract.bias"]
    return x, x2, e


def dccn_fused_grads_ref(spec: ModelSpec, n_frames: int, params: dict,
                         yr, yi, nr, ni, cvec, idx, e=None):
    """The plain version: (grads, ce_mean, conf) with `grads` keyed as
    `PARAM_KEYS`, `conf` the int64 2x2 bit confusion matrix [true, pred].

    `yr, yi, nr, ni` [B, S*P] raw planes, `cvec` [6, S*P] the affine,
    `idx` [B, D] int32 symbol indices (bits MSB first).  `e` [B, 2D], when
    given, replaces the Dense_extract output (the kernel's, so that both
    take the same side of every leaky kink when they are compared)."""
    S, P, D, n = spec.nsymbol, spec.sps, spec.frame_size, spec.nbits
    mm = _matmul(spec)
    b = n_frames
    we = params["Dense_extract.weight"]
    wc, bc = params["Dense_conv1x1.weight"].T, params["Dense_conv1x1.bias"]
    wl, bl = params["Dense_llr.weight"].T, params["Dense_llr.bias"]
    c_n = wc.shape[1]

    # forward; the head's sums in the kernel's order, one rounding each
    x, x2, e_own = dccn_forward_ref(spec, params, yr, yi, nr, ni, cvec)
    e = e_own if e is None else e
    er, ei = e[:, 0::2], e[:, 1::2]                        # [B, D]
    pre_h = er[..., None] * wc[0] + ei[..., None] * wc[1] + bc  # [B, D, C]
    chans = torch.cat([_leaky(pre_h), er[..., None], ei[..., None]], -1)
    pre_l = bl + chans[..., 0, None] * wl[0]               # [B, D, 2n]
    for c in range(1, c_n + 2):
        pre_l = pre_l + chans[..., c, None] * wl[c]
    lg = _leaky(pre_l)
    t = lg[..., 1::2] - lg[..., 0::2]                      # [B, D, n]
    shifts = torch.arange(n - 1, -1, -1, device=idx.device)
    bit = ((idx[..., None].to(torch.int64) >> shifts) & 1).to(torch.float32)
    ce = bit * _softplus(-t) + (1.0 - bit) * _softplus(t)
    pred = (t > 0).to(torch.float32)
    g1 = (torch.sigmoid(t) - bit) * (1.0 / (n_frames * D * n))
    dpre = torch.stack([-g1 * _dleaky(pre_l[..., 0::2]),
                        g1 * _dleaky(pre_l[..., 1::2])], -1).reshape(
        pre_l.shape)

    # backward: llr, conv1x1
    dwl = torch.einsum("bdc,bdj->cj", chans, dpre)
    dbl = dpre.sum((0, 1))
    dch = dpre @ wl.T                                      # [B, D, C+2]
    dh = dch[..., :c_n] * _dleaky(pre_h)
    dwc = torch.stack([(er[..., None] * dh).sum((0, 1)),
                       (ei[..., None] * dh).sum((0, 1))])
    dbc = dh.sum((0, 1))
    der = dch[..., c_n] + dh @ wc[0]
    dei = dch[..., c_n + 1] + dh @ wc[1]
    de = torch.stack([der, dei], -1).reshape(b, -1)        # [B, 2D]

    # backward: Dense_extract, fft_like
    dwe = mm(de.T, x2)                                     # [2D, S*2F]
    dbe = de.sum(0)
    dx2 = mm(de, we).reshape(b * S, -1)                    # [B*S, 2F]
    dwr, dwi = _fold_expanded(mm(x.T, dx2), P)
    dfb = dx2.sum(0)

    grads = {"fft_like.wr": dwr, "fft_like.wi": dwi,
             "fft_like.br": dfb[0::2], "fft_like.bi": dfb[1::2],
             "Dense_extract.weight": dwe, "Dense_extract.bias": dbe,
             "Dense_conv1x1.weight": dwc.T, "Dense_conv1x1.bias": dbc,
             "Dense_llr.weight": dwl.T, "Dense_llr.bias": dbl}
    ce_mean = ce.sum() / (n_frames * D * n)
    n11 = (bit * pred).sum().to(torch.int64)
    conf = _confusion(n11, bit.sum().to(torch.int64),
                      pred.sum().to(torch.int64), n_frames * D * n)
    return grads, ce_mean, conf


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class _ModelArgs(ctypes.Structure):
    """`ModelArgs` of csrc/fused_model.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "yr", "yi", "nr", "ni", "cvec", "idx", "wr", "wi", "br", "bi", "we",
        "be", "wc", "bc", "wl", "bl", "fb", "hp", "x2", "e", "de", "dx2",
        "part_we", "part_w", "part_be", "part_fb", "hpart", "cpart", "dwe",
        "dwr", "dwi", "dbe", "dfb", "dhead", "ce", "conf", "xb", "wexpb",
        "web", "x2b", "deb", "dx2b")] + [
        (n, ctypes.c_int) for n in (
            "B", "S", "P", "F", "D", "nbits", "splits_we", "splits_w",
            "splits_be", "splits_fb", "head_blocks", "round_bf16", "ldx",
            "ldd", "ldf", "ktps_we", "ktps_w")]


def _carve(n_per_part: dict, **like) -> dict:
    """One allocation cut into named flat views of the given sizes, each
    on a 256-byte boundary, as vector loads and TMA want."""
    step = 256 // like["dtype"].itemsize
    offsets, total = {}, 0
    for name, n in n_per_part.items():
        offsets[name] = total
        total += -(-n // step) * step
    buf = torch.empty(max(total, 1), **like)
    return {name: buf[o:o + n_per_part[name]] for name, o in offsets.items()}


@functools.cache
def _model_fn():
    fn = cuda_build.load("fused_model").dccn_fused_grads_f32
    fn.argtypes = [ctypes.POINTER(_ModelArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


HEAD_ELEMS_PER_BLOCK = 256 * 8     # HEAD_THREADS * HEAD_ITEMS in the .cu,
                                   # which checks that the blocks cover B*D
# the bf16 route's tensor-core GEMM (csrc/fused_model.cu): 128 x 128 output
# tiles, k tiles of 64; split-K GEMMs aim at two blocks for each of the
# card's 132 SMs with at least 2 k tiles a split
TC_TILE, TC_BK = 128, 64
TC_TARGET_BLOCKS = 2 * 132
TC_MIN_KTILES = 2


def _splits(rows: int, chunk: int, most: int) -> int:
    """Blocks over a reduced dimension of `rows`: about `chunk` rows each,
    at most `most` (each writes a partial that a second pass sums)."""
    return max(1, min(most, -(-rows // chunk)))


def _pad8(n: int) -> int:
    """A row of n bf16 values padded to a multiple of 8 (16 bytes), the
    row pitch a TMA tensor map takes."""
    return -(-n // 8) * 8


def _tc_split(m: int, n: int, k: int) -> tuple[int, int]:
    """(splits, k tiles a split) of a split-K tensor-core GEMM: enough
    splits that the output tiles times the splits fill the card, none
    empty, each summing a run of whole k tiles."""
    tiles = -(-m // TC_TILE) * -(-n // TC_TILE)
    ktiles = -(-k // TC_BK)
    want = max(1, min(-(-TC_TARGET_BLOCKS // tiles),
                      -(-ktiles // TC_MIN_KTILES)))
    ktps = -(-ktiles // want)
    return -(-ktiles // ktps), ktps


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    """What the wrapper allocates and passes for one call: the GEMM route,
    split counts, and on the bf16 route the GEMM inputs' shapes and padded
    row pitches (in elements; TMA takes whole 16 bytes)."""
    route: str                  # 'tensor_core' (bf16) or 'simt' (float32)
    splits_we: int              # GEMM 4 (dWe), over frames
    splits_w: int               # GEMM 6 (dWexp), over symbol rows
    ktps_we: int                # k tiles of 64 a split (tensor-core route)
    ktps_w: int
    splits_be: int              # column sums of de and dX2
    splits_fb: int
    head_blocks: int
    ldx: int = 0                # bf16 affine(y, n): [B*S, ldx]
    ldd: int = 0                # bf16 de: [B, ldd]
    ldf: int = 0                # each run of 2F bf16 values (a symbol of
                                # x2 or dX2, a row of Wexp or of We's)
    bf16_shapes: dict = dataclasses.field(default_factory=dict)


def model_plan(spec: ModelSpec, b: int) -> ModelPlan:
    """The launch plan of `dccn_fused_grads_kernel` for `b` frames."""
    S, P, F, D = spec.nsymbol, spec.sps, spec.nfilter, spec.frame_size
    bs, e2, x2w = b * S, 2 * D, S * 2 * F
    common = dict(splits_be=_splits(b, 128, 1024),
                  splits_fb=_splits(bs, 128, 1024),
                  head_blocks=-(-b * D // HEAD_ELEMS_PER_BLOCK))
    if spec.matmul_dtype == "float32":
        # ~1-2K frames (or symbol rows) a block; column sums: a thread sums
        # ~128-256 rows, so enough blocks are in flight
        return ModelPlan("simt", _splits(b, 1024, 32), _splits(bs, 2048, 32),
                         0, 0, **common)
    ldx, ldd, ldf = _pad8(2 * P), _pad8(e2), _pad8(2 * F)
    # GEMM 4 computes dWe on the padded S*ldf columns (the padding's are
    # dropped by its epilogue)
    sp_we, ktps_we = _tc_split(e2, S * ldf, b)
    sp_w, ktps_w = _tc_split(2 * P, 2 * F, bs)
    shapes = {"xb": (bs, ldx), "wexpb": (2 * P, ldf), "web": (e2, S * ldf),
              "x2b": (b, S * ldf), "deb": (b, ldd), "dx2b": (b, S * ldf)}
    return ModelPlan("tensor_core", sp_we, sp_w, ktps_we, ktps_w, ldx=ldx,
                     ldd=ldd, ldf=ldf, bf16_shapes=shapes, **common)


def dccn_fused_grads_kernel(spec: ModelSpec, n_frames: int, params: dict,
                            yr, yi, nr, ni, cvec, idx,
                            return_e: bool = False):
    """Launch the CUDA kernels: contiguous float32 planes [B, S*P], cvec
    [6, S*P], int32 idx [B, D] and float32 parameters, all on one CUDA
    device.  Returns what `dccn_fused_grads_ref` returns, and with
    `return_e=True` also the Dense_extract output e [B, 2D]."""
    S, P, F, D, n = (spec.nsymbol, spec.sps, spec.nfilter, spec.frame_size,
                     spec.nbits)
    L, b = S * P, n_frames
    planes = (yr, yi, nr, ni)
    dev = yr.device
    tensors = planes + (cvec, idx) + tuple(params[k] for k in PARAM_KEYS)
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("dccn_fused_grads_kernel: every input must be on "
                         "one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors if t is not idx) \
            or idx.dtype != torch.int32:
        raise TypeError("dccn_fused_grads_kernel takes float32 planes and "
                        "parameters and int32 idx")
    if any(t.shape != (b, L) for t in planes) or cvec.shape != (6, L) \
            or idx.shape != (b, D) \
            or params["fft_like.wr"].shape != (P, F) \
            or params["Dense_extract.weight"].shape != (2 * D, S * 2 * F):
        raise ValueError(f"dccn_fused_grads_kernel: shapes do not match "
                         f"{spec} at {b} frames")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dccn_fused_grads_kernel takes contiguous tensors")
    if b == 0 or b * max(L, 2 * D, S * 2 * F) >= 2**31:
        raise ValueError("dccn_fused_grads_kernel: B must be > 0 and the "
                         "planes fit int32 indexing")
    f32 = dict(device=dev, dtype=torch.float32)
    c_n, j_n = 2 ** n, 2 * n
    h = 3 * c_n + (c_n + 2) * j_n + j_n       # packed head parameters
    e2, x2w, bs = 2 * D, S * 2 * F, b * S
    plan = model_plan(spec, b)
    tc = plan.route == "tensor_core"
    ws = _carve({"fb": 2 * F, "hp": h, "x2": 0 if tc else b * x2w,
                 "e": b * e2, "de": b * e2, "dx2": b * x2w,
                 "part_we": plan.splits_we * e2 * x2w,
                 "part_w": plan.splits_w * 4 * P * F,
                 "part_be": plan.splits_be * e2,
                 "part_fb": plan.splits_fb * 2 * F,
                 "hpart": plan.head_blocks * (h + 1)}, **f32)
    out = _carve({"dwe": e2 * x2w, "dwr": P * F, "dwi": P * F, "dbe": e2,
                  "dfb": 2 * F, "dhead": h + 1, "ce": 1}, **f32)
    cpart = torch.empty(plan.head_blocks, 3, device=dev, dtype=torch.int32)
    conf = torch.empty(2, 2, device=dev, dtype=torch.int64)
    # bf16 GEMM inputs; the kernel zeroes the padding that a GEMM sums
    # over (x's, x2's and the weights'), the rest is never read
    bf = _carve({k: r * c for k, (r, c) in plan.bf16_shapes.items()},
                device=dev, dtype=torch.bfloat16) if tc else {}
    ptrs = [t.data_ptr() for t in (
        yr, yi, nr, ni, cvec, idx, *(params[k] for k in PARAM_KEYS))]
    ptrs += [ws[k].data_ptr() for k in ws]
    ptrs.append(cpart.data_ptr())
    ptrs += [out[k].data_ptr() for k in out]
    ptrs.append(conf.data_ptr())
    ptrs += [bf[k].data_ptr() for k in bf] if tc else [0] * 6
    args = _ModelArgs(*ptrs, b, S, P, F, D, n, plan.splits_we,
                      plan.splits_w, plan.splits_be, plan.splits_fb,
                      plan.head_blocks, int(tc), plan.ldx, plan.ldd,
                      plan.ldf, plan.ktps_we, plan.ktps_w)
    with torch.cuda.device(dev):
        err = _model_fn()(ctypes.byref(args),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_model kernel launch failed: CUDA error "
                           f"{err}")
    dccn_fused_grads_kernel.launches += 1
    dhead, dfb = out["dhead"], out["dfb"]
    o_bc, o_wl = 2 * c_n, 3 * c_n
    o_bl = o_wl + (c_n + 2) * j_n
    grads = {"fft_like.wr": out["dwr"].view(P, F),
             "fft_like.wi": out["dwi"].view(P, F),
             "fft_like.br": dfb[0::2], "fft_like.bi": dfb[1::2],
             "Dense_extract.weight": out["dwe"].view(e2, x2w),
             "Dense_extract.bias": out["dbe"],
             "Dense_conv1x1.weight": dhead[:o_bc].view(2, c_n).T,
             "Dense_conv1x1.bias": dhead[o_bc:o_wl],
             "Dense_llr.weight": dhead[o_wl:o_bl].view(c_n + 2, j_n).T,
             "Dense_llr.bias": dhead[o_bl:h]}
    res = (grads, out["ce"][0], conf)
    return res + (ws["e"].view(b, e2),) if return_e else res


dccn_fused_grads_kernel.launches = 0


def tensor_core_gemm_check(a, b, a_mn: bool, b_mn: bool, splits: int = 1):
    """One launch of the bf16 route's tensor-core GEMM on contiguous bf16
    CUDA operands, for holding each operand layout against a reference:
    A [M, K] (or [K, M] with `a_mn`), B [N, K] (or [K, N] with `b_mn`);
    returns the float32 split partials [splits, M, N] over runs of whole
    k tiles.  Rows must be a multiple of 8 elements long."""
    m, k = (a.shape[1], a.shape[0]) if a_mn else a.shape
    n = b.shape[1] if b_mn else b.shape[0]
    if not (a.is_cuda and b.device == a.device and a.is_contiguous()
            and b.is_contiguous() and a.dtype == b.dtype == torch.bfloat16):
        raise ValueError("tensor_core_gemm_check takes contiguous bf16 "
                         "operands on one CUDA device")
    ktiles = -(-k // TC_BK)
    ktps = -(-ktiles // splits)
    c = torch.empty(-(-ktiles // ktps), m, n, device=a.device,
                    dtype=torch.float32)
    fn = cuda_build.load("fused_model").tc_gemm_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                 int(a_mn), int(b_mn), c.shape[0], ktps,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tensor-core GEMM launch failed: CUDA error "
                           f"{err}")
    return c


def dccn_fused_grads(spec: ModelSpec, n_frames: int, params: dict,
                     yr, yi, nr, ni, cvec, idx):
    """CE gradients and metrics of the DCCN receiver on raw synth planes
    (`fused_model.py:322`, fuse_norm=True): (grads keyed as the parameters'
    `state_dict`, mean CE, int64 2x2 confusion).  The kernel for CUDA
    tensors, the plain version for CPU tensors; the L2 term is not in it."""
    fn = dccn_fused_grads_ref if yr.device.type == "cpu" \
        else dccn_fused_grads_kernel
    return fn(spec, n_frames, params, yr, yi, nr, ni, cvec, idx)


def reg_grads(params: dict, ber: torch.Tensor, reg_coeff: float,
              scale: float = 0.01) -> dict:
    """The L2 term of the training gradient, d/dw of stop_grad(ber) *
    reg_coeff * sum(scale * ||w||^2) over the `Dense` entries
    (`fused_model.py:450-463`); zero for the others."""
    factor = ber.detach() * (reg_coeff * 2.0 * scale)
    dense = [k for k in params if "Dense" in k]
    out = {k: torch.zeros_like(v) for k, v in params.items()
           if k not in dense}
    out.update(zip(dense, torch._foreach_mul([params[k] for k in dense],
                                             factor)))
    return {k: out[k] for k in params}
