"""Kernel launches a training step issued by the equalizer (`ofdm.eq.*`:
its forward in the step and in the epoch's eval): the host's launch API
events (`cudaLaunch*`, `cuLaunch*`, `cudaGraphLaunch`) inside the layer's
spans over the steps (`benchmark/spans.py`).  None where the program
records no spans."""
from benchmark import spans


def read(run):
    return spans.launches_per(run, "eq", "steps")
