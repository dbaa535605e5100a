"""Kernel launches an `eval_batch` call issued by the data plane
(`ofdm.data.*`: `Trainer.synthesize`'s TX, channel, AWGN and
normalization): the host's launch API events (`cudaLaunch*`, `cuLaunch*`,
`cudaGraphLaunch`) inside the layer's spans over the calls
(`benchmark/spans.py`).  None where the program records no spans."""
from benchmark import spans


def read(run):
    return spans.launches_per(run, "data", "calls")
