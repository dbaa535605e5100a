"""The card's idle time while the host was in the model
(`ofdm.model.forward`: the DCCN forward and `eval_batch`'s error and CE
sums), as a share of the traced sweep window: the gaps between the card's
operations inside the layer's spans, each moment charged to the innermost
`ofdm.` span (`benchmark/spans.py`).  None where the program records no
spans."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, "model", "calls")
