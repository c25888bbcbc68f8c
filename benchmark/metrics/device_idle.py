"""The share of the traced phase's window, on the device's clock, in which
no device operation ran."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
