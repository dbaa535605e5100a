"""`parallel/mesh.py`, `parallel/distributed.py`: the NCCL kernels' device
time on rank 0's card in the traced window, a step."""
NCCL = "nccl"


def read(run):
    ks = [k for k in run.trace.kernels if NCCL in k[0].lower()]
    if not ks or not run.steps:
        return None
    return sum(e - s for _, s, e in ks) * 1e-6 / run.steps
