"""The whole training step's share of the cards' bf16 peak: 3 x the DCCN
forward's model FLOPs of every frame trained in the traced window over
the window's seconds x the cards x 989 TFLOP/s."""
from benchmark import work


def read(run):
    if not run.steps:
        return None
    o = run.ofdm
    fwd = work.dccn_forward_flops(o["nsymbol"], run.synth.sps, o["nfilter"],
                                  run.synth.frame_size, o["nbits"])
    return 100.0 * 3 * fwd * run.frames / (
        run.trace.window_s * run.chips * work.BF16_FLOPS)
