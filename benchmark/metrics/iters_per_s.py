"""GN iterations of every solve of the window over the window: from its
start to the end of its last solve, graph builds and readbacks inside."""


def read(run):
    return sum(a.iters for a in run.solves) / run.window_s
