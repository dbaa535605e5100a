"""`ops/pallas_kernels.py` -> `csrc/complex_dense_bf16.cu`: the least time
of `fft_like` at the call's shape (`work.cdense_work`, bf16 tensor-core
and HBM peaks) over the traced device time of its pack and GEMM kernels."""
from benchmark import work
from benchmark.trace import kernel_matcher

KERNELS = ("pack_ws", "gemm")


def read(run):
    t, n = run.trace.kernel_time_s(kernel_matcher(KERNELS))
    if not n or not run.calls:
        return None
    o = run.ofdm
    b, f = work.cdense_work(run.frames_per_call * o["nsymbol"], run.sps,
                            o["nfilter"])
    bound = work.bound_of(b, f, flop_rate=work.BF16_FLOPS)[0]
    return 100.0 * run.calls * bound / t
