"""The share of the window's CG bodies that ran as the fused block-Jacobi
body over a system with loop-closure rows: the program's counter
"cg.loop_fused_bodies" over "cg.bodies" across the window's
"solve_packed" roots.  Nothing where the program keeps no such counter (a
program whose fused body has no loop rows, or without spans)."""

from benchmark.harness import program_spans


def read(run):
    roots = [r for r in program_spans.window_roots(run, "solve_packed") or ()
             if r.counters.get("cg.bodies")]
    if not any("cg.loop_fused_bodies" in r.counters for r in roots):
        return None
    return (program_spans.counted(roots, "cg.loop_fused_bodies")
            / program_spans.counted(roots, "cg.bodies"))
