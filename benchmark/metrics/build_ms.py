"""Mean host time of the graph build (upload and triangulation), ending in
a synchronise, over the window's solves."""


def read(run):
    return sum(a.t_build - a.t0 for a in run.solves) * 1e3 / len(run.solves)
