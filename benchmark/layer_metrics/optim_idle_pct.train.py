"""The card's idle time while the host was in the optimizer (`ofdm.optim.*`:
BER from the counts, the L2 term and its gradient, Adam and the parameter
update), as a share of the traced train window: the gaps between the
card's operations inside the layer's spans, each moment charged to the
innermost `ofdm.` span (`benchmark/spans.py`).  None where the program
records no spans."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, "optim", "steps")
