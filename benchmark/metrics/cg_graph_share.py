"""The share of the window's CG bodies that ran as CUDA graph replays: the
program's counter "cg.graph_bodies" over "cg.bodies" across the window's
"solve_packed" roots.  0.0 where the program counts no replayed body (a
program that launches every body from the host); nothing where it keeps
no spans."""

from benchmark.harness import program_spans


def read(run):
    roots = [r for r in program_spans.window_roots(run, "solve_packed") or ()
             if r.counters.get("cg.bodies")]
    if not roots:
        return None
    return (program_spans.counted(roots, "cg.graph_bodies")
            / program_spans.counted(roots, "cg.bodies"))
