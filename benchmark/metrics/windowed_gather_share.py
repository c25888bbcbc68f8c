"""The share of the window's packed slot-grid gathers that went through
the windowed kernel: the program's counter "gather.windowed" over
"gather.windowed" + "gather.plain" across the window's "solve_packed"
roots.  0.0 where the window planner refused every grid; nothing where
the program keeps no such counters."""

from benchmark.harness import program_spans


def read(run):
    roots = [r for r in program_spans.window_roots(run, "solve_packed") or ()
             if "gather.windowed" in r.counters or "gather.plain" in r.counters]
    windowed = program_spans.counted(roots, "gather.windowed")
    total = windowed + program_spans.counted(roots, "gather.plain")
    return windowed / total if total else None
