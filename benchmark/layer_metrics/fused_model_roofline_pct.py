"""`ops/fused_model.py` -> `csrc/fused_model.cu`: the least time of the
DCCN's forward, loss and backward on the steps' frames (`work.model_work`
at the bf16 tensor-core and HBM peaks) over the traced device time of the
source's kernels."""
from benchmark import work
from benchmark.trace import kernel_matcher

KERNELS = ("gemm_kernel", "tc_gemm_kernel", "head_kernel", "head_finish",
           "reduce_splits", "colsum_splits", "reduce_fold", "pack_params",
           "affine_bf16", "weights_bf16")


def read(run):
    t, n = run.trace.kernel_time_s(kernel_matcher(KERNELS))
    if not n or not run.steps:
        return None
    o = run.ofdm
    sh = run.synth
    b, f = work.model_work(sh.nsymbol, sh.sps, o["nfilter"], sh.frame_size,
                           o["nbits"], run.frames_per_step, run.n_params)
    bound = work.bound_of(b, f, flop_rate=work.BF16_FLOPS)[0]
    return 100.0 * run.steps * bound / t
