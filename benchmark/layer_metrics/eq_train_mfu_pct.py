"""The whole equalizer training step's share of the card's bf16 peak: 3 x
the equalizer's forward model FLOPs (`work_eq.eq12_forward_flops`) plus 2
x the frozen DCCN receiver's (`work.dccn_forward_flops`: its input
gradients, no weight gradients), for every frame trained in the traced
window, over the window's seconds x 989 TFLOP/s."""
from benchmark import work, work_eq


def read(run):
    if not run.steps:
        return None
    o = run.ofdm
    eq = work_eq.eq12_forward_flops(o["nsymbol"], o["nfft"], run.cp,
                                    run.pilots)
    rx = work.dccn_forward_flops(o["nsymbol"], o["nfft"] + run.cp,
                                 o["nfilter"], run.frame_size, o["nbits"])
    return 100.0 * (3 * eq + 2 * rx) * run.frames / (
        run.trace.window_s * run.chips * work.BF16_FLOPS)
