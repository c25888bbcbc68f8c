"""The share of the window's CG bodies that ran as the fused block-Jacobi
body (one hand-written kernel call a body): the program's counter
"cg.fused_bodies" over "cg.bodies" across the window's "solve_packed"
roots.  Nothing where the program counts no fused body at all (a program
without the fused body, or without spans)."""

from benchmark.harness import program_spans


def read(run):
    roots = [r for r in program_spans.window_roots(run, "solve_packed") or ()
             if r.counters.get("cg.bodies")]
    if not any("cg.fused_bodies" in r.counters for r in roots):
        return None
    return (program_spans.counted(roots, "cg.fused_bodies")
            / program_spans.counted(roots, "cg.bodies"))
