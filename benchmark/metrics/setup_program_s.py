"""The program's own share of set-up, in s: its import (the root span
"import") and every root span that ended before the window's first solve
began (the warm solves' builds and solves, the CUDA context's creation
inside the first).  A run of ``benchmark/run.py`` is one process, so
every such root is its set-up's.  Nothing where the program keeps no
spans, or where the ring no longer holds the import (it lets its oldest
roots go first)."""

from benchmark.harness import program_spans


def read(run):
    spans = program_spans.ring()
    if spans is None or not run.solves:
        return None
    lo, _ = program_spans.bounds_ns(run)
    roots = [r for r in spans.records() if r.end_ns < lo]
    if not any(r.name == "import" for r in roots):
        return None
    return sum(r.end_ns - r.start_ns for r in roots) / 1e9
