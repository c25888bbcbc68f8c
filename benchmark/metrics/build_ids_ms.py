"""Mean host ms of the graph build's id maps and index arrays, the
program's span "build/ids", per solve of the window; nothing where the
program keeps no spans."""

from benchmark.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, "build", "build/ids")
