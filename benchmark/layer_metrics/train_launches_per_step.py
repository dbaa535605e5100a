"""Kernel launches a training step: every kernel of the traced window on the
card read (the steps', the epochs' eval and host reads') over the steps."""


def read(run):
    if not run.steps or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.steps
