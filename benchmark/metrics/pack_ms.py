"""Mean host ms of the packing (edges to the host, ``pack_edges``, the
grids to the device), the program's span "solve_packed/pack", per solve of
the window; nothing where the program keeps no spans."""

from benchmark.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, "solve_packed", "solve_packed/pack")
