"""Kernel launches an `eval_batch` call: every kernel of the traced window
over the calls."""


def read(run):
    if not run.calls or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.calls
