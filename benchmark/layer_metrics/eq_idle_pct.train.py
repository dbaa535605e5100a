"""The card's idle time while the host was in the equalizer (`ofdm.eq.*`:
its front, channel estimate and equalization, `models/equalizers.py`), as
a share of the traced train window: the gaps between the card's
operations inside the layer's spans, each moment charged to the innermost
`ofdm.` span (`benchmark/spans.py`).  None where the program records no
spans."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, "eq", "steps")
