"""Kernel launches a training step issued by the optimizer (`ofdm.optim.*`:
BER from the counts, the L2 term and its gradient, Adam and the parameter
update): the host's launch API events (`cudaLaunch*`, `cuLaunch*`,
`cudaGraphLaunch`) inside the layer's spans over the steps
(`benchmark/spans.py`).  None where the program records no spans."""
from benchmark import spans


def read(run):
    return spans.launches_per(run, "optim", "steps")
