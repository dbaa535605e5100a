"""The card's idle time while the host was in the model (`ofdm.model.*`: the
DCCN forward with its CE and counts, each `torch.autograd.grad`, the fused
DCCN gradient kernel), as a share of the traced train window: the gaps
between the card's operations inside the layer's spans, each moment
charged to the innermost `ofdm.` span (`benchmark/spans.py`).  None where
the program records no spans."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, "model", "steps")
