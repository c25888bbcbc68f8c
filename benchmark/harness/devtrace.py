"""The device trace of a traced phase, reduced in memory.

A frozen copy of the project's correlation-window reader
(``utils/profiling._profile_once``, ``_device_ops`` and
``_launched_by_call``): ``torch.cuda._sleep`` marks are launched right
before the traced call (``START_MARKS`` of them: a session can lose the
device records of its first kernels) and one right after it; the call's
device operations are those whose CUPTI correlation id lies after the first
runtime call made in the host window and before the end mark's, and the
window runs, on the device's clock, from the first mark recorded to the
end mark's end.  ``benchmark/tests`` holds the copied functions equal to
the project's on the same events.

On top of it, ``reduce`` attributes each device operation to the harness
span (``record_function`` range on the host) in which the host launched
it: the runtime call with the operation's correlation id lies in that
span.  An idle gap on the device is named by the span that launched the
operation ending it, and by that operation.
"""

from __future__ import annotations

import bisect
import os
import re
import sys
import time
from typing import Callable, NamedTuple

import torch

WINDOW = "benchmark::traced_phase"
SPAN_PREFIX = "benchmark::"
_RUNTIME = re.compile(r"cu(da)?[A-Z]")
MARK = "spin_kernel"
START_MARKS = 512
SESSIONS = 3


def profile_once(fn: Callable, cuda: bool):
    """(events, wall s) of one profiled call of ``fn``, bracketed by the
    marks on the card."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # Kineto tears CUPTI down after each session unless told not to
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for _ in range(START_MARKS if cuda else 0):
                torch.cuda._sleep(0)
            fn()
            if cuda:
                torch.cuda._sleep(0)
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return list(prof.events()), wall


def _device_ops(events, cuda: bool):
    """The device's operations among ``events``, each (event, plane, time
    us), and the host window (start, end) in us, or None where the session
    did not record it.  On the card, every CUDA event but the window's own
    annotation; on the CPU, the operators' self times on the host threads."""
    cpu = torch.autograd.DeviceType.CPU
    window = next(((e.time_range.start, e.time_range.end) for e in events
                   if e.name == WINDOW and e.device_type == cpu), None)
    if cuda:
        ops = [(e, f"cuda:{e.device_index} stream {e.device_resource_id}",
                e.time_range.elapsed_us()) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name != WINDOW]
    else:
        ops = [(e, f"cpu thread {e.thread}", e.self_cpu_time_total) for e in events
               if e.device_type == cpu and not e.is_async and e.name != WINDOW]
    return ops, window


def _launched_by_call(ops, events, window, cuda: bool):
    """(the first and last mark recorded, which of ``ops`` the call
    launched), or None where the session lacks what decides it.  On the
    card the call's operations are those whose correlation id lies after
    the first runtime call made in the host window and before the end
    mark's; a start mark and the end mark must be recorded.  On the CPU
    the call's are those that start in the window."""
    lo, hi = window
    if not cuda:
        return [], [lo <= e.time_range.start <= hi for e, _, _ in ops]
    cpu = torch.autograd.DeviceType.CPU
    first = min((e.id for e in events if e.device_type == cpu and _RUNTIME.match(e.name)
                 and lo <= e.time_range.start <= hi), default=None)
    marks = sorted((e for e, _, _ in ops if MARK in e.name and first is not None
                    and e.id >= first), key=lambda e: e.id)
    if len(marks) < 2:
        return None
    end = marks[-1].id
    return [marks[0], marks[-1]], [first <= e.id < end and MARK not in e.name
                                   for e, _, _ in ops]


class Trace(NamedTuple):
    """A traced phase on the device's clock (on the CPU: the host's).

    ``busy_s``: the summed time of the phase's device operations;
    ``window_s``: start mark to end mark; ``n_ops``: their count;
    ``by_span``: {span: (busy s, ops)} by the harness span that launched
    them; ``device_ops``: [[name, s]] the ten that took most time;
    ``idle_gaps``: [[name, s]] the ten longest gaps; ``sessions``: the
    profiler sessions taken."""

    busy_s: float
    window_s: float
    n_ops: int
    by_span: dict
    device_ops: list
    idle_gaps: list
    sessions: int
    wall_s: float


def _span_of(events, cuda: bool):
    """correlation id -> the innermost harness span whose host range holds
    the runtime call with that id (on the CPU: event id -> span)."""
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted(((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):])
                    for e in events if e.device_type == cpu and e.name.startswith(SPAN_PREFIX)
                    and e.name != WINDOW), key=lambda s: s[0])
    starts = [s[0] for s in spans]

    def find(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            lo, hi, name = spans[i]
            if lo <= t <= hi:
                return name
            i -= 1
        return "outside spans"

    if not cuda:
        return lambda e: find(e.time_range.start)
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == cpu and _RUNTIME.match(e.name)}
    return lambda e: find(launch[e.id]) if e.id in launch else "unmatched"


def reduce(events, cuda: bool, sessions: int, wall_s: float):
    """The Trace of one session's events, or None where the session holds
    no operation of the call (or, on the card, no start or end mark)."""
    ops, window = _device_ops(events, cuda)
    if window is None:
        return None
    split = _launched_by_call(ops, events, window, cuda)
    if split is None or not any(split[1]):
        return None
    marks, own = split
    # (on the CPU the harness's own spans are operators too)
    mine = sorted((o for o, m in zip(ops, own) if m and not o[0].name.startswith(SPAN_PREFIX)),
                  key=lambda o: o[0].time_range.start)
    span = _span_of(events, cuda)
    by_span, by_name = {}, {}
    for e, _, us in mine:
        s = span(e)
        busy, n = by_span.get(s, (0.0, 0))
        by_span[s] = (busy + us / 1e6, n + 1)
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e6
    if marks:
        lo, hi = marks[0].time_range.start, marks[1].time_range.end
    else:
        lo, hi = window
    gaps, t = [], lo
    for e, _, _ in mine:
        if e.time_range.start > t:
            gaps.append([f"{span(e)} > {e.name[:48]}", (e.time_range.start - t) / 1e6])
        t = max(t, e.time_range.end)
    if hi > t:
        gaps.append(["end of phase", (hi - t) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Trace(busy_s=sum(us for _, _, us in mine) / 1e6, window_s=(hi - lo) / 1e6,
                 n_ops=len(mine), by_span=by_span,
                 device_ops=[[k[:80], v] for k, v in top],
                 idle_gaps=sorted(gaps, key=lambda g: -g[1])[:10],
                 sessions=sessions, wall_s=wall_s)


def trace(fn: Callable, cuda: bool) -> Trace:
    """Run ``fn`` under the profiler and reduce its session; a session
    that records nothing of the call is taken again (running ``fn`` once
    more), ``SESSIONS`` times in all, after which this raises: an empty
    trace is no measurement."""
    for attempt in range(1, SESSIONS + 1):
        events, wall = profile_once(fn, cuda)
        tr = reduce(events, cuda, attempt, wall)
        if tr is not None:
            return tr
        print(f"trace: session {attempt} of {SESSIONS} recorded no device operation of the "
              f"phase ({len(events)} events)", file=sys.stderr)
    raise RuntimeError(f"trace: {SESSIONS} profiler sessions recorded no device operation")
