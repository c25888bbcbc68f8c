"""Mean CG iterations per GN outer step over the window's solves, from
the ``cg_iters`` stat the packed path returns; nothing where the path has
no CG."""


def read(run):
    its = [x for a in run.solves if a.cg_iters is not None for x in a.cg_iters]
    return float(sum(its) / len(its)) if its else None
