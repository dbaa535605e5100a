"""The card's idle share of the traced training window: 1 - the union of
its operations' intervals over the window."""


def read(run):
    if not run.trace.device_ops or not run.steps:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
