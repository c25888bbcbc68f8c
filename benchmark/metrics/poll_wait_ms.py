"""Host ms blocked in the CG loop's polls (the program's span
"solve_packed/step/pcg/poll") per GN outer step (the counter "gn.outers")
over the window's solves.  The polls timed are held to the polls the CG
loop counted (the counter "cg.polls"): where the two differ, a poll went
untimed or was timed twice, and the reading is nothing, as it is where
the program keeps no spans."""

from benchmark.harness import program_spans

PATH = "solve_packed/step/pcg/poll"


def read(run):
    roots = [r for r in program_spans.window_roots(run, "solve_packed") or ()
             if r.counters.get("gn.outers")]
    if not roots:
        return None
    timed = sum(r.paths.get(PATH, (0, 0, 0))[0] for r in roots)
    if timed != program_spans.counted(roots, "cg.polls"):
        return None
    return program_spans.total_ns(roots, PATH) / program_spans.counted(roots, "gn.outers") / 1e6
