"""Mean host ms of the windowed path's preparation per solve of the
window: the landmark relabelling and the window planning, the program's
spans "solve_packed/pack/reorder" and "solve_packed/pack/plan_windows",
over the window's "solve_packed" roots that relabelled; nothing where
none did or the program keeps no spans."""

from benchmark.harness import program_spans

REORDER = "solve_packed/pack/reorder"
PLAN = "solve_packed/pack/plan_windows"


def read(run):
    roots = [r for r in program_spans.window_roots(run, "solve_packed") or ()
             if REORDER in r.paths]
    if not roots:
        return None
    return (program_spans.total_ns(roots, REORDER)
            + program_spans.total_ns(roots, PLAN)) / len(roots) / 1e6
