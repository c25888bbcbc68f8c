"""What the program's own spans say of the window: the metric readers that
read ``boslam_torch.utils.spans`` share these.

The program keeps a bounded ring of its closed root spans in memory
(``spans.records()``), each with the summed time of every span path under
it and the counters charged to it, on ``time.perf_counter_ns``: the clock
of the harness's ``Answer`` stamps.  A program without that module gives
no reading.
"""

from __future__ import annotations


def ring():
    """The program's span module, or None where it has none."""
    try:
        from boslam_torch.utils import spans
    except ImportError:
        return None
    return spans


def bounds_ns(run) -> tuple:
    """The window on the host clock in ns: its first solve's start to its
    last solve's end."""
    return int(run.solves[0].t0 * 1e9), int(run.solves[-1].t_end * 1e9)


def window_roots(run, name: str) -> list | None:
    """The ring's roots called ``name`` that started in the window (those
    the ring still holds), or None where the program keeps no spans."""
    spans = ring()
    if spans is None or not run.solves:
        return None
    lo, hi = bounds_ns(run)
    return [r for r in spans.records() if r.name == name and lo <= r.start_ns <= hi]


def total_ns(roots: list, path: str, which: int = 1) -> int:
    """The summed total (``which`` 1) or self (2) ns of ``path`` over
    ``roots``."""
    return sum(r.paths.get(path, (0, 0, 0))[which] for r in roots)


def counted(roots: list, name: str) -> int:
    return sum(r.counters.get(name, 0) for r in roots)


def mean_ms(run, root: str, path: str) -> float | None:
    """The mean host ms of ``path`` per window root ``root`` that holds it,
    or None where none does."""
    roots = [r for r in window_roots(run, root) or () if path in r.paths]
    if not roots:
        return None
    return total_ns(roots, path) / len(roots) / 1e6
