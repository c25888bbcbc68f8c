"""The frozen copies in ``benchmark/harness`` hold equal to the project's
functions at the commit they were copied from: the traffic generator
(against both of the project's neighbour searches) and the trace reader's
correlation window on the same fake profiler sessions.  (The harness imports none of the project; these
tests may.)"""

import builtins
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import devtrace, traffic
from boslam_torch import synth
from boslam_torch.utils import profiling

CASES = [(60, 30, 1, {}), (301, 141, 50000, {}), (301, 141, 50002, {}),
         (301, 141, 16, {"loop_closures": 4}), (2000, 800, 7, {"turn_every": 10**9})]


def _no_scipy(fn, *a, **k):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name.startswith("scipy"):
            raise ImportError(name)
        return real(name, *args, **kw)

    builtins.__import__ = fake
    try:
        return fn(*a, **k)
    finally:
        builtins.__import__ = real


def _same(a, b):
    names = [f.name for f in dataclasses.fields(b)]
    assert list(a._fields) == names
    for f in names:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert x == y, f


@pytest.mark.parametrize("n_poses,n_landmarks,seed,kw", CASES)
@pytest.mark.parametrize("search", ["scipy", "brute force"])
def test_generator_equals_the_projects(n_poses, n_landmarks, seed, kw, search):
    gen = synth.generate_sequence
    theirs = (gen(n_poses, n_landmarks, seed=seed, **kw) if search == "scipy"
              else _no_scipy(gen, n_poses, n_landmarks, seed=seed, **kw))
    mine = traffic.generate_sequence(n_poses, n_landmarks, seed=seed, **kw)
    for a, b in zip(mine, theirs):
        _same(a, b)


def test_pool_is_drawn_from_the_seed_or_fixed():
    cfg = {"graph": {"n_poses": 120, "n_landmarks": 60}}
    drawn = {"pool": 3}
    pool = traffic.make_pool(cfg, drawn, 2**31 + 12345)
    again = traffic.make_pool(cfg, drawn, 2**31 + 12345)
    assert len(pool) == 3 and [k for k, _ in pool] == [k for k, _ in again]
    assert all(np.array_equal(a.bearing_meas, b.bearing_meas)
               for (_, a), (_, b) in zip(pool, again))
    other = traffic.make_pool(cfg, drawn, 7)
    assert any(not np.array_equal(a.bearing_meas, b.bearing_meas)
               for (_, a), (_, b) in zip(pool, other))
    fixed = {"pool": 2, "graph_seeds": [5, 6]}
    assert [k for k, _ in traffic.make_pool(cfg, fixed, 2**31 + 1)] == [6, 5]
    assert [k for k, _ in traffic.make_pool(cfg, fixed, 2**31 + 2)] == [5, 6]
    with pytest.raises(ValueError, match="not a pool of 3"):
        traffic.make_pool(cfg, {"pool": 3, "graph_seeds": [5, 6]}, 1)


def _event(eid, name, t0, t1, cuda=True):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    tr = SimpleNamespace(start=t0, end=t1, elapsed_us=lambda: t1 - t0)
    return SimpleNamespace(id=eid, name=name, time_range=tr, device_type=kind, device_index=0,
                           device_resource_id=7, thread=1, is_async=False,
                           self_cpu_time_total=t1 - t0)


def _session(window_name, lost, end_mark=True):
    """A fake card session: a stray kernel from before it, START_MARKS
    start marks of which the first ``lost`` lost their device records,
    three kernels whose device clock runs behind, the end mark."""
    mark = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    host = [_event(1, window_name, 100.0, 9000.0, cuda=False),
            _event(10, "cudaLaunchKernel", 50.0, 51.0, cuda=False)]
    dev = [_event(10, "stray_kernel", 95.0, 99.0)]
    t, eid = 110.0, 20
    for k in range(devtrace.START_MARKS):
        host.append(_event(eid, "cudaLaunchKernel", t, t + 1, cuda=False))
        if k >= lost:
            dev.append(_event(eid, mark, t + 5, t + 6))
        t, eid = t + 10, eid + 3
    for name in ("a_kernel", "b_kernel", "a_kernel"):
        host.append(_event(eid, "cudaLaunchKernel", t, t + 1, cuda=False))
        dev.append(_event(eid, name, t - 30, t - 20))
        t, eid = t + 10, eid + 3
    host.append(_event(eid, "cudaLaunchKernel", t, t + 1, cuda=False))
    if end_mark:
        dev.append(_event(eid, mark, t + 5, t + 6))
    return host + dev


@pytest.mark.parametrize("lost,end_mark,cuda", [(0, True, True), (3, True, True),
                                                (devtrace.START_MARKS, True, True),
                                                (0, False, True), (0, True, False)])
def test_trace_window_equals_the_projects(lost, end_mark, cuda):
    assert devtrace.START_MARKS == profiling.START_MARKS and devtrace.MARK == profiling.MARK
    readings = []
    for mod in (devtrace, profiling):
        events = _session(mod.WINDOW, lost, end_mark)
        ops, window = mod._device_ops(events, cuda)
        split = mod._launched_by_call(ops, events, window, cuda)
        readings.append((window, [(e.id, e.name, p, us) for e, p, us in ops],
                         None if split is None else ([m.id for m in split[0]], split[1])))
    assert readings[0] == readings[1]


def test_trace_reduces_a_session_by_span():
    events = _session(devtrace.WINDOW, 2)
    # a span around the three kernels' launches
    events.append(_event(2, "benchmark::solve", 110.0 + 10 * devtrace.START_MARKS - 1,
                         110.0 + 10 * devtrace.START_MARKS + 25, cuda=False))
    tr = devtrace.reduce(events, True, 1, 0.5)
    assert tr.n_ops == 3 and list(tr.by_span) == ["solve"] and tr.by_span["solve"][1] == 3
    assert tr.by_span["solve"][0] == pytest.approx(30e-6)
    assert abs(tr.busy_s - 30e-6) < 1e-12 and tr.busy_s < tr.window_s
    assert [n for n, _ in tr.device_ops] == ["a_kernel", "b_kernel"]
    assert devtrace.reduce(_session(devtrace.WINDOW, 0, end_mark=False), True, 1, 0.5) is None
