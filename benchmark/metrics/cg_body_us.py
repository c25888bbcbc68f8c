"""The host's time per CG body over the window's solves: the self time of
the program's span "solve_packed/step/pcg" (its duration less its polls)
over the CG bodies it ran (the counter "cg.bodies"); nothing where the
program keeps no spans."""

from benchmark.harness import program_spans

PATH = "solve_packed/step/pcg"


def read(run):
    roots = [r for r in program_spans.window_roots(run, "solve_packed") or ()
             if r.counters.get("cg.bodies")]
    if not roots:
        return None
    return (program_spans.total_ns(roots, PATH, which=2)
            / program_spans.counted(roots, "cg.bodies") / 1e3)
