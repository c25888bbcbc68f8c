"""The counters of what a CUDA graph's replay repeats.

Each hand-written kernel's wrapper counts the launches it made in
attributes of its own (``windowed_take.launches``;
``fused_gn_step.band_launches``, those of ``.launches`` on the band
route), and the packed solver's gather its calls by route
(``schur_packed.gather_counts``, on every device), registered here by
``counter``, so that a caller can read and charge them all at once: a
CUDA graph's capture launches nothing, and each replay launches what the
captured calls did.
"""

from __future__ import annotations

_COUNTERS = []  # (function, attribute), in the order registered


def counter(fn, *names: str):
    """Give ``fn`` the counters ``names``, each 0, and register them."""
    for name in names:
        setattr(fn, name, 0)
        _COUNTERS.append((fn, name))
    return fn


def read() -> tuple:
    """Every registered counter's value, in the order registered."""
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def add(counts) -> None:
    """Add ``counts`` (a ``read()`` or differences of two) to the counters."""
    for (fn, name), n in zip(_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)
