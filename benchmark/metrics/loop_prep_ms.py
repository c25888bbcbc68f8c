"""Mean host ms per solve of the window that the packing spends listing the
loop closures per pose: the program's span "solve_packed/pack/loops" over
the window's "solve_packed" roots that hold it; nothing where none does
(no loop closure, a program that lists none, or no spans)."""

from benchmark.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, "solve_packed", "solve_packed/pack/loops")
