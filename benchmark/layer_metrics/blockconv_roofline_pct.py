"""`ops/complex_ops.py` `ComplexConv2d` -> `csrc/complex_conv2d.cu`: the
least time of the window's block convolution at the float32 FMA peak
(`work.F32_FLOPS`) over the traced device time of its kernels (forward and
input gradient, weight gradient, the partials' sum).

Work: the (S, K) = (nsymbol, nfft) kernel's taps inside the 'same' window
of the S x K map (`work_eq.same_taps`), 8 FLOP a complex tap, three passes
(forward, input gradient, weight gradient) for every frame trained in the
window.  The run does not expose the frames of its `eval_step`s, whose
forward is in the kernels' time and not in the work: the share reads low
by their part (1,024 of 3 x 9,362 + 1,024 frame passes an epoch in
`eq12.train_mix_9k`), never too high.  A program without these kernels
reads None."""
from benchmark import work, work_eq
from benchmark.trace import kernel_matcher

KERNELS = ("complex_conv2d_fwd_kernel", "complex_conv2d_wgrad_kernel",
           "complex_conv2d_wgrad_sum_kernel")


def read(run):
    t, n = run.trace.kernel_time_s(kernel_matcher(KERNELS))
    if not n or not run.frames:
        return None
    s, k = run.ofdm["nsymbol"], run.ofdm["nfft"]
    flops = 8 * work_eq.same_taps(s, s) * work_eq.same_taps(k, k)
    return 100.0 * 3 * flops * run.frames / work.F32_FLOPS / t
