"""Device operations launched in the traced phase (build, solve and
readback) per GN iteration of its solves."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    return run.trace.n_ops / sum(a.iters for a in run.traced)
