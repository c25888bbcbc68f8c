"""Profiling and timing helpers (port of ``boslam/utils/profiling.py``):
``torch.profiler`` traces, timers bracketed by waits for the card, and a
rough operation count of the dense GN step.

The per-kernel readers (``device_time_by_kernel``, ``profile_path``,
``launches_per_call``) and ``time_ms`` serve ``chip_smoke.py`` and the
port's tools.  Their waits for the card are made inside
``device.host_sync``, so they run inside a solve phase held under CUDA
sync-debug mode "error".
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from boslam_torch.device import host_sync, resolve_device

TRACE_FILE = "boslam_torch_trace.json"
# the port's kernels, by the names the profiler gives them
PORT_KERNELS = ("chol_solve_kernel", "band_solve_kernel", "schur_w_kernel", "schur_s_kernel",
                "schur_rhs_kernel", "schur_dl_kernel", "gn_edge_kernel", "gn_assemble_kernel",
                "gn_finish_kernel", "windowed_take_kernel")
# profiler sessions taken before an empty one counts as a failure: on the
# H100 a session can come back with no device event at all (once in 20
# sessions; short sessions after long ones; a one-operator session)
SESSIONS = 3
# the profiled call's range on the host's side of the profiler's timeline
WINDOW = "boslam_torch::profiled_call"
# CUDA API events (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...):
# their correlation ids number the API calls in the order they are made,
# and a device operation carries its launch's
_RUNTIME = re.compile(r"cu(da)?[A-Z]")
# the kernel of ``torch.cuda._sleep``, which marks the call's start and end
# on the card (``_profile_once``); nothing else in the port runs it
MARK = "spin_kernel"
# marks launched before the call: on the H100 a session after a process's
# first can lose the device records of its first kernels (their launch
# events stay), up to 94 of them late in chip_smoke.py's long process, all
# of a short session's (and at times its last ones, the end mark among
# them: the session is then taken again; tools/port_trace_probe.py counts
# them).  The marks take the leading loss, and the earliest that survives
# marks the call's start on the device
START_MARKS = 512


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace,
    ``log_dir/boslam_torch_trace.json`` (chrome://tracing or Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def timeit(fn: Callable, *args, repeats: int = 5, warmup: int = 1, device=None) -> dict:
    """Wall time of ``fn(*args)``, each call ended by a wait for the card on
    a CUDA ``device`` (the default; pass device="cpu" on the CPU)."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn(*args)
        sync()
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times), "times": times}


def gn_step_flops(n_poses: int, n_landmarks: int, n_bearing: int, n_odom: int) -> int:
    """Rough operation count of one dense-path GN step: the Cholesky
    factorization (N^3/3) dominates at reference size, the edge math at
    large size (the JAX package's formula)."""
    N = 3 * n_poses + 2 * n_landmarks
    edge = n_bearing * 120 + n_odom * 700  # residual + Jacobian + outer products
    chol = N**3 // 3 + 2 * N**2
    return edge + chol


def sync(dev: torch.device) -> None:
    """Wait for the card (a CUDA ``dev``), the sync-debug mode lifted."""
    if dev.type == "cuda":
        with host_sync(dev):
            torch.cuda.synchronize(dev)


class DeviceTrace(NamedTuple):
    """One profiled call.  ``kernels``: {name: (ms, launches)} of the
    device's operations that the call launched; ``busy_ms`` their summed
    time; ``span_ms`` first start to last end; ``n_ops`` their count;
    ``wall_ms`` the host clock around the call and its wait for the card;
    ``planes`` where they ran (CUDA streams, or CPU threads on the CPU);
    ``n_host_threads`` the host threads that recorded operators (0 on the
    CPU, whose threads are the planes); ``window_ms`` the call on the clock
    its operations are read on: on the card from the start of the mark
    launched before it to the end of the one launched after it, on the CPU
    the ``record_function`` range; ``host_window_ms`` that range, the call
    and its wait for the card on the host's side of the profiler's
    timeline; ``n_ops_outside`` the session's device operations that the
    call did not launch, left out of all the above; ``timeline`` where they
    lie (``_timeline``); ``sessions`` the profiler sessions taken, 1 unless
    a session recorded no device operation of the call."""
    kernels: dict
    busy_ms: float
    span_ms: float
    n_ops: int
    wall_ms: float
    planes: list
    n_host_threads: int
    window_ms: float
    host_window_ms: float
    n_ops_outside: int
    timeline: dict
    sessions: int


def _profile_once(fn: Callable, dev: torch.device):
    """(events, wall ms) of one profiled call of ``fn``.  ``fn()`` and the
    wait for the card after it run inside a ``record_function`` range named
    ``WINDOW``; on the card ``MARK`` kernels are launched right before
    ``fn()`` (``START_MARKS``) and right after it (one): the call's
    launches lie between theirs in correlation order, and their device
    times bound the call on the device's clock.  ``fn`` runs under the
    caller's sync-debug mode; the profiler and the wait for the card run
    with it lifted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # Kineto tears CUPTI down after each session unless told not to; PyTorch
    # turns that off itself in a process with CUDA graphs, which chip_smoke.py
    # captures.  On the H100 a session after a graph was built on the card
    # came back empty with the teardown on and recorded with it off (one
    # fresh process each); it does not stop the empty sessions of a long one.
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    mode = torch.cuda.get_sync_debug_mode() if cuda else 0
    sync(dev)
    with host_sync(dev), profile(activities=acts) as prof:
        if cuda:
            torch.cuda.set_sync_debug_mode(mode)
        try:
            t0 = time.perf_counter()
            with record_function(WINDOW):
                for _ in range(START_MARKS if cuda else 0):
                    torch.cuda._sleep(0)
                fn()
                if cuda:
                    torch.cuda._sleep(0)
                sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    return list(prof.events()), wall_ms


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
    the first API call made in the host window (the first start mark's
    launch, whose device record may be lost) and before the end mark's;
    the host's clock only places that first call, the order is CUPTI's.
    A start mark and the end mark must be recorded.  On the
    CPU, where operators are events on the host's one clock, the call's
    are those that start in the window."""
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


def _timeline(ops, own, window, marks) -> dict:
    """Where the session's device operations lie, in ms from the host
    window's start on the profiler's timeline: ``window`` [0, its end];
    ``device_window`` the first mark's start and the second's end (None on
    the CPU); ``own`` the call's first start and last end; ``all`` the same
    over every device operation of the session; ``outside`` {name: count}
    of those the call did not launch, the marks left out."""
    lo, hi = window

    def ends(sel):
        sel = list(sel)
        if not sel:
            return None
        return [(min(e.time_range.start for e in sel) - lo) / 1e3,
                (max(e.time_range.end for e in sel) - lo) / 1e3]

    outside = {}
    for (e, _, _), mine in zip(ops, own):
        if not mine and MARK not in e.name:
            outside[e.name[:60]] = outside.get(e.name[:60], 0) + 1
    return {"window": [0.0, (hi - lo) / 1e3], "device_window": ends(marks),
            "own": ends(e for (e, _, _), m in zip(ops, own) if m),
            "all": ends(e for e, _, _ in ops), "outside": outside}


def device_time_by_kernel(fn: Callable, device=None) -> DeviceTrace:
    """Device time by kernel of one call of ``fn`` under ``torch.profiler``.

    On a CUDA ``device`` (the default) the device's operations are the
    CUDA events (kernels, copies, sets) that the call launched
    (``_launched_by_call``); on one stream they do not overlap and run
    between the marks, so busy <= span <= window, all read on the device's
    clock.  On the CPU they are the operators' self times on the host
    threads inside the call.  A session that records no device operation
    of the call (on the card: or no start mark, or not the end mark) is
    taken again, ``SESSIONS`` times in all, each running ``fn`` once more;
    after that this raises ``RuntimeError``: an empty trace is no
    measurement."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    for attempt in range(1, SESSIONS + 1):
        events, wall_ms = _profile_once(fn, dev)
        ops, window = _device_ops(events, cuda)
        split = _launched_by_call(ops, events, window, cuda) if window is not None else None
        if split is not None and any(split[1]):
            marks, own = split
            break
        ids = [e.id for e, _, _ in ops]
        print(f"device_time_by_kernel: session {attempt} of {SESSIONS} recorded no device "
              f"operation of the call ({len(ops)} in all, correlation ids "
              f"{min(ids, default=None)}-{max(ids, default=None)}, marks at "
              f"{[e.id for e, _, _ in ops if MARK in e.name]})", file=sys.stderr)
    else:
        raise RuntimeError(f"device_time_by_kernel: {SESSIONS} profiler sessions on {dev} "
                           f"recorded no device operation")
    mine = [o for o, m in zip(ops, own) if m]
    n_outside = sum(not m and MARK not in e.name for (e, _, _), m in zip(ops, own))
    timeline = _timeline(ops, own, window, marks)
    if n_outside:
        print(f"device_time_by_kernel: {n_outside} device operations outside the call: "
              f"{timeline['outside']}", file=sys.stderr)
    kernels = {}
    for e, _, us in mine:
        ms, n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (ms + us / 1e3, n + 1)
    span_us = max(e.time_range.end for e, _, _ in mine) - min(e.time_range.start for e, _, _ in mine)
    window_us = (marks[1].time_range.end - marks[0].time_range.start if marks
                 else window[1] - window[0])
    cpu = torch.autograd.DeviceType.CPU
    host = {e.thread for e in events if e.device_type == cpu} if cuda else set()
    return DeviceTrace(kernels=kernels, busy_ms=sum(us for _, _, us in mine) / 1e3,
                       span_ms=span_us / 1e3, n_ops=len(mine), wall_ms=wall_ms,
                       planes=sorted({p for _, p, _ in mine}), n_host_threads=len(host),
                       window_ms=window_us / 1e3, host_window_ms=(window[1] - window[0]) / 1e3,
                       n_ops_outside=n_outside, timeline=timeline, sessions=attempt)


def port_launches(tr: DeviceTrace, names=PORT_KERNELS) -> tuple[int, float]:
    """(launches, ms) of the port's kernels (those whose name holds one of
    ``names``) in the trace."""
    hits = [v for k, v in tr.kernels.items() if any(n in k for n in names)]
    return sum(n for _, n in hits), sum(ms for ms, _ in hits)


def launches_per_call(fn: Callable, device=None) -> int:
    """Kernel launches of the port that one call of ``fn`` makes, by the
    profiler's device events (after one call outside the profiler)."""
    dev = resolve_device(device)
    fn()
    sync(dev)
    n, _ = port_launches(device_time_by_kernel(fn, dev))
    if n == 0:
        print("launches per call: no kernel of the port among the device events",
              file=sys.stderr)
    return n


def profile_path(solve: Callable, g, cfg, iters: int = 5, top: int = 8) -> dict:
    """Device time by kernel over ``iters`` warm iterations of one path,
    ``solve(g, cfg)``, and the device's busy share of the window (one
    stream, so kernels do not overlap and their sum is the busy time);
    beside it the wall time of the warm-up run, outside the profiler."""
    cfg = cfg.replace(iters=iters)
    dev = g.device
    sync(dev)
    t0 = time.perf_counter()
    solve(g, cfg)
    sync(dev)
    warm_ms = (time.perf_counter() - t0) * 1e3
    tr = device_time_by_kernel(lambda: solve(g, cfg), dev)
    ranked = sorted(tr.kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(
        iters=iters, wall_ms_per_iter=tr.wall_ms / iters, wall_ms_per_iter_unprofiled=warm_ms / iters,
        device_busy_ms_per_iter=tr.busy_ms / iters, device_busy_share=tr.busy_ms / tr.window_ms,
        device_ops_per_iter=tr.n_ops / iters,
        top=[[name[:60], round(v[0] / iters, 4)] for name, v in ranked],
    )


def time_ms(fns: dict, reps=20, rounds: int = 5, graph: bool = False, device=None) -> dict:
    """{name: median ms} of each ``fns[name]()``.

    A round times each function once, in turn, as the mean of ``reps``
    calls (an int, or {name: int}); the median over ``rounds`` rounds is
    returned, so the functions are compared inside one window of the card's
    clocks.  On a CUDA ``device`` (the default) the time is by CUDA events;
    with ``graph`` the ``reps`` calls are captured once in a CUDA graph and
    the graph is replayed: the time is then the device's, not the host's
    enqueue rate, which bounds a call of a few microseconds.  On the CPU
    the time is the host clock's, and ``graph`` is refused."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if graph and not cuda:
        raise ValueError("time_ms: graph replay needs a CUDA device")
    reps = reps if isinstance(reps, dict) else {k: reps for k in fns}
    with host_sync(dev):
        run = {}
        for k, fn in fns.items():
            for _ in range(3):
                fn()
            sync(dev)
            if graph:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    for _ in range(reps[k]):
                        fn()
                run[k] = (g.replay, 1)
            else:
                run[k] = (fn, reps[k])
        times = {k: [] for k in fns}
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        for _ in range(rounds):
            for k, (fn, n) in run.items():
                fn()
                sync(dev)
                if cuda:
                    start.record()
                else:
                    t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                if cuda:
                    end.record()
                    sync(dev)
                    times[k].append(start.elapsed_time(end) / reps[k])
                else:
                    times[k].append((time.perf_counter() - t0) * 1e3 / reps[k])
    return {k: float(np.median(v)) for k, v in times.items()}
