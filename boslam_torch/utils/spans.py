"""Host spans and counters of the port: the program's one tracing API.

``span(name)`` times a phase on the host clock (``time.perf_counter_ns``,
the clock of ``time.perf_counter``); spans nest, on a stack of their own
in each thread.  A span opened with no span open is a root: it gets an
id that every span under it carries, and when it closes one ``Record`` of
it is appended to a bounded in-memory ring, ``records()``.  A record sums
each span path under the root (``"solve_packed/step/pcg/poll"``: names from
the root down) as (count, total ns, self ns), self being the duration less
what the span's children cover, and holds the counters charged to the
root by ``count(name, n)`` while it was open.  A count made with no span
open is not kept.  The ring holds the newest ``RING`` roots; ``dropped()``
counts those it let go.

While ``annotated()`` is in force (the profiler entry points of
``utils/profiling`` switch it on) every span also opens
``torch.profiler.record_function(ANNOTATION + path)``, which puts the
phase on the profiler's timeline beside the device operations it
launched.  A bare profiler session sees no span of the program.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

# the prefix of the program's ranges on the profiler's timeline
ANNOTATION = "boslam_torch::"
# roots the ring keeps
RING = 4096


class Record(NamedTuple):
    """One closed root: ``paths`` {path: (count, total ns, self ns)} of the
    spans under it, itself included; ``counters`` {name: n}."""
    name: str
    id: int
    start_ns: int
    end_ns: int
    paths: dict
    counters: dict


class _Root:
    __slots__ = ("id", "paths", "counters")

    def __init__(self, rid: int):
        self.id = rid
        self.paths = {}
        self.counters = {}


_ids = itertools.count(1)
_ring = collections.deque(maxlen=RING)
_lock = threading.Lock()
_dropped = 0
_annotate = 0
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class span:
    """A timed phase; use as ``with span("pack"):``.  After it closes it
    holds ``name``, ``path``, ``start_ns``, ``end_ns``, ``parent`` (the
    enclosing span, or None for a root) and ``root_id``.  ``start_ns``
    backdates the start (the package's import root, opened after its first
    line ran)."""

    __slots__ = ("name", "path", "start_ns", "end_ns", "parent", "root_id", "_root", "_child_ns",
                 "_rf")

    def __init__(self, name: str, start_ns: int | None = None):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None

    def __enter__(self):
        st = _stack()
        if st:
            self.parent = st[-1]
            self.path = f"{self.parent.path}/{self.name}"
            self._root = self.parent._root
        else:
            self.parent = None
            self.path = self.name
            self._root = _Root(next(_ids))
        self.root_id = self._root.id
        self._child_ns = 0
        self._rf = None
        if _annotate:
            from torch.profiler import record_function

            self._rf = record_function(ANNOTATION + self.path)
            self._rf.__enter__()
        st.append(self)
        if self.start_ns is None:
            self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = t = time.perf_counter_ns()
        st = _stack()
        st.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        dur = t - self.start_ns
        paths = self._root.paths
        c, tot, own = paths.get(self.path, (0, 0, 0))
        paths[self.path] = (c + 1, tot + dur, own + dur - self._child_ns)
        if st:
            st[-1]._child_ns += dur
        else:
            _close(Record(self.name, self.root_id, self.start_ns, t, paths,
                          self._root.counters))
        return False


def _close(rec: Record) -> None:
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(rec)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span's root
    (nothing is kept when no span is open)."""
    st = _stack()
    if st:
        ctr = st[-1]._root.counters
        ctr[name] = ctr.get(name, 0) + int(n)


def records() -> list:
    """The ring, oldest root first."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """``spans.dropped``: the roots the ring has let go."""
    return _dropped


@contextlib.contextmanager
def annotated():
    """Inside the block, spans also open ``record_function`` ranges."""
    global _annotate
    _annotate += 1
    try:
        yield
    finally:
        _annotate -= 1
