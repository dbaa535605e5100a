"""`ops/fused_synth.py` -> `csrc/fused_synth.cu`: the least time of the
frames it synthesized (`work.synth_work`, `work.bound_of` at the float32
and HBM peaks) over its kernel's traced device time."""
from benchmark import work
from benchmark.trace import kernel_matcher

KERNELS = ("fused_synth_kernel",)


def read(run):
    t, n = run.trace.kernel_time_s(kernel_matcher(KERNELS))
    if not n or not run.steps:
        return None
    b, f, i, s = work.synth_work(run.synth, run.frames_per_step)
    bound = work.bound_of(b, f, int_ops=i, sfu_ops=s)[0]
    return 100.0 * run.steps * bound / t
