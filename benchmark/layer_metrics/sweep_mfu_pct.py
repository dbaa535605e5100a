"""The whole sweep call's share of the card's bf16 peak: the DCCN forward's
model FLOPs of every frame evaluated in the traced window over the
window's seconds x 989 TFLOP/s."""
from benchmark import work


def read(run):
    if not run.calls:
        return None
    o = run.ofdm
    fwd = work.dccn_forward_flops(o["nsymbol"], run.sps, o["nfilter"],
                                  run.frame_size, o["nbits"])
    return 100.0 * fwd * run.frames / (run.trace.window_s * run.chips
                                       * work.BF16_FLOPS)
