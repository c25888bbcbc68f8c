"""The port's trace and split tools on the CPU (``--device cpu``, small
sizes): ``tools/port_trace_validate.py`` prints records that carry the keys
of ``tools/trace_validate.py`` at every level (read from its source) and
the JAX roofline models' floats on the same dimensions;
``tools/port_packed_split_probe.py`` prints the JAX tool's line; neither
run imports JAX or the JAX package.  And the profiling helpers they share
(``boslam_torch/utils/profiling.py``): the trace's busy <= span <= wall,
and an empty profiler session taken again, up to three times, then an
error."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from boslam.graph.build import build_graph as build_graph_jax
from boslam.graph.packed import pack_edges as pack_edges_jax
from boslam.io.g2o import parse_g2o as parse_g2o_jax
from boslam.synth import generate_sequence as generate_sequence_jax
from boslam.utils import roofline as roofline_jax
from boslam_torch.io.g2o import write_g2o
from boslam_torch.synth import generate_sequence
from boslam_torch.utils import profiling

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO_ROOT, "tools")
POSES = 300  # the packed path's walk

# runs a tool as __main__, then names every JAX or JAX-package module it loaded
_LAUNCH = """
import runpy, sys
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    code = e.code
else:
    code = 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "boslam"))
print("IMPORTED=" + ",".join(bad), file=sys.stderr)
sys.exit(code)
"""


def _run(tool, *args, timeout=240):
    # one intra-op thread: the suite runs several workers on the same cores
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _LAUNCH, os.path.join(TOOLS, tool), "--device",
                          "cpu", *args], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED=\n" in out.stderr, out.stderr[-500:]
    return out.stdout


def _jax_dict_keys(func, marker):
    """Keys of the dict literal in ``func`` of tools/trace_validate.py that
    has the key ``marker``."""
    tree = ast.parse(open(os.path.join(TOOLS, "trace_validate.py")).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if marker in keys:
                return set(keys)
    raise AssertionError(f"trace_validate.py:{func} has no dict with {marker!r}")


@pytest.fixture(scope="module")
def g2o(tmp_path_factory):
    ig, _ = generate_sequence(30, 15, seed=3)
    path = str(tmp_path_factory.mktemp("trace") / "s.g2o")
    write_g2o(path, ig.pose_ids, ig.pose_xyt, ig.lm_ids, ig.lm_xy, parsed=ig,
              fixed_pose_id=ig.fixed_pose_id)
    return path


@pytest.fixture(scope="module")
def trace_records(g2o):
    lines = _run("port_trace_validate.py", "--paths", "dense", "schur", "packed", "--poses",
                 str(POSES), "--iters", "3", "--g2o", g2o).strip().splitlines()
    return {r["path"]: r for r in map(json.loads, lines)}


def test_trace_validate_keys(trace_records):
    top = _jax_dict_keys("run_path", "xla_cost_analysis")
    trace = _jax_dict_keys("_parse_xplane", "device_planes")
    vs_wall = _jax_dict_keys("run_path", "device_busy_frac_of_span")
    assert set(trace_records) == {"dense", "schur", "packed"}
    for name, rec in trace_records.items():
        assert top <= set(rec), name
        assert trace <= set(rec["trace"]), name
        assert vs_wall <= set(rec["trace_vs_wall"]), name
        # no compiler in the port, so no cost analysis
        assert rec["xla_cost_analysis"] is None and rec["model_vs_xla"] is None
        tr = rec["trace"]
        assert 0 < tr["device_time_ms"] <= tr["device_span_ms"] <= tr["profiled_wall_ms"], name
        assert tr["device_span_ms"] <= tr["window_ms"] and tr["n_ops_outside"] == 0, name
        assert tr["port_kernel_launches"] == 0 and rec["route"] == "plain", name  # the CPU
        assert np.isfinite(rec["chi2_final"]) and rec["ms_per_iter"] > 0
    assert trace_records["packed"]["iters"] == 5  # max(5, iters // 3), as the JAX tool
    for name in ("dense", "schur"):
        kw = trace_records[name]["kernel_work"]
        assert kw["fmas"] > 0 and kw["bytes"] > 0 and kw["launches"] == 0
        assert kw["bound_ms"] is None and kw["device_ms_per_step"] is None  # no card
    assert "kernel_work" not in trace_records["packed"]


def test_trace_validate_models_match_jax(trace_records, g2o):
    """Each record's model is the JAX module's on the JAX graph's
    dimensions, float for float (packed: at the CG count the record read)."""
    g, _ = build_graph_jax(parse_g2o_jax(g2o), init="triangulate")
    dims = (g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry)
    for name, fn in (("dense", roofline_jax.dense_step_model),
                     ("schur", roofline_jax.schur_step_model)):
        m = trace_records[name]["model"]
        assert tuple(m["args"]) == dims
        assert (m["flops"], m["hbm_bytes"]) == fn(*dims)
    ig, _ = generate_sequence_jax(POSES, max(8, POSES * 2 // 5), seed=0)
    gw, _ = build_graph_jax(ig, init="triangulate")
    pk, _ = pack_edges_jax(gw)
    rec = trace_records["packed"]
    cg = rec["cg_iters_warm_step"]
    assert 0 < cg <= 50
    want = roofline_jax.packed_outer_model(gw.n_poses, gw.n_landmarks, pk.K, pk.K2,
                                           gw.n_odometry, cg, lm_rows=pk.l_pose.shape[0])
    assert (rec["model"]["flops"], rec["model"]["hbm_bytes"]) == want


def test_packed_split_probe():
    out = _run("port_packed_split_probe.py", "2000").strip().splitlines()
    line = re.compile(r"^(\w+)\s+n=2000: build\s+([\d.]+) ms \| matvec\s+([\d.]+) ms \| "
                      r"factor\+apply\s+([\d.]+) ms \| apply\s+([\d.]+) ms$")
    first = [m for m in map(line.match, out) if m]
    assert [m.group(1) for m in first] == ["block_jacobi", "two_level"], out
    for m in first:
        assert all(float(t) > 0 for t in m.groups()[1:]), m.group(0)
    second = [ln for ln in out if "device ops" in ln]
    assert len(second) == 2 and all(ln.count("n/a (cpu)") == 4 for ln in second), out


def _ops():
    x = torch.ones(64, 64)
    for _ in range(5):
        x = torch.tanh(x @ x / 64)
    return x


def test_device_time_by_kernel_on_cpu():
    tr = profiling.device_time_by_kernel(_ops, "cpu")
    assert 0 < tr.busy_ms <= tr.span_ms <= tr.wall_ms
    assert tr.span_ms <= tr.window_ms and tr.n_ops_outside == 0
    assert tr.kernels["aten::mm"][1] == 5 and tr.n_ops >= 10
    assert tr.planes and all(p.startswith("cpu thread") for p in tr.planes)
    assert profiling.port_launches(tr) == (0, 0)


def test_window_leaves_out_ops_outside_the_call(monkeypatch):
    """Operators the session records before and after the profiled call's
    window (run around its record_function range) are not counted: the
    call's operators are those of a session without them, each counted
    once, and busy <= span <= window_ms."""
    import contextlib

    want = profiling.device_time_by_kernel(_ops, "cpu")
    real = torch.profiler.record_function

    @contextlib.contextmanager
    def around(name):
        torch.ones(8).sin()
        with real(name):
            yield
        torch.ones(8).cos()

    monkeypatch.setattr(torch.profiler, "record_function", around)
    tr = profiling.device_time_by_kernel(_ops, "cpu")
    assert {k: n for k, (_, n) in tr.kernels.items()} == {k: n for k, (_, n) in want.kernels.items()}
    assert tr.n_ops == want.n_ops and tr.n_ops_outside >= 2
    assert {"aten::sin", "aten::cos"} <= set(tr.timeline["outside"])
    assert 0 < tr.busy_ms <= tr.span_ms <= tr.window_ms
    lo, hi = tr.timeline["own"]
    assert 0 <= lo <= hi <= tr.window_ms and tr.timeline["all"][0] < 0 < tr.window_ms < tr.timeline["all"][1]


def _event(eid, name, t0, t1, cuda=True):
    from types import SimpleNamespace

    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    tr = SimpleNamespace(start=t0, end=t1, elapsed_us=lambda: t1 - t0)
    return SimpleNamespace(id=eid, name=name, time_range=tr, device_type=kind, device_index=0,
                           device_resource_id=7, thread=1, is_async=False)


@pytest.mark.parametrize("lost", [0, 1, 3])
def test_card_call_is_read_by_correlation_order(lost):
    """The card's reading of a session (fake events): the call's operations
    are those between its first launch in the host window and its end
    mark, in correlation order, whatever their device times; a stray
    operation from before the session and the lost device records of the
    first start marks change nothing; the window runs from the first mark
    recorded to the end mark.  With every start mark lost, or the end mark,
    the session counts as empty."""
    mark = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    host = [_event(profiling.WINDOW, profiling.WINDOW, 100.0, 900.0, cuda=False)]
    host[0].id = 1
    host += [_event(10, "cudaLaunchKernel", 50.0, 51.0, cuda=False)]  # before the window
    dev = [_event(10, "stray_kernel", 95.0, 99.0)]  # its kernel, recorded in this session
    t, eid = 110.0, 20
    for k in range(profiling.START_MARKS):
        host.append(_event(eid, "cudaLaunchKernel", t, t + 1, cuda=False))
        if k >= lost:
            dev.append(_event(eid, mark, t + 5, t + 6))
        t, eid = t + 10, eid + 3
    for name in ("a_kernel", "b_kernel", "a_kernel"):
        host.append(_event(eid, "cudaLaunchKernel", t, t + 1, cuda=False))
        dev.append(_event(eid, name, t - 30, t - 20))  # the device's clock runs behind
        t, eid = t + 10, eid + 3
    host.append(_event(eid, "cudaLaunchKernel", t, t + 1, cuda=False))
    dev.append(_event(eid, mark, t + 5, t + 6))
    ops, window = profiling._device_ops(host + dev, True)
    assert window == (100.0, 900.0) and len(ops) == len(dev)
    marks, own = profiling._launched_by_call(ops, host + dev, window, True)
    assert [e.name for (e, _, _), m in zip(ops, own) if m] == ["a_kernel", "b_kernel", "a_kernel"]
    assert marks[0].id == 20 + 3 * lost and marks[1].name == mark and marks[1].id == eid
    tl = profiling._timeline(ops, own, window, marks)
    assert tl["outside"] == {"stray_kernel": 1} and tl["device_window"][0] > 0
    no_end = profiling._launched_by_call(ops[:-1], host + dev, window, True)
    assert not any(no_end[1])
    first_marks = [o for o in ops if o[0].name == mark][:-1]
    rest = [o for o in ops if o not in first_marks]
    assert profiling._launched_by_call(rest, host + dev, window, True) is None


def test_trace_probe_session_record():
    """``tools/port_trace_probe.session_record`` on a fake card session: of
    six launches in the host range the first two and the last lost their
    device records, one record starts 30 us before its launch, one ends
    40 us after the range, and a record of a launch before the range is
    stray; API calls that make no device record are not launches."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_trace_probe",
                                                  os.path.join(TOOLS, "port_trace_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    host = [_event(5, "cudaLaunchKernel", 50.0, 51.0, cuda=False),
            _event(6, "cudaGetDevice", 120.0, 121.0, cuda=False)]
    dev = [_event(5, "before_kernel", 60.0, 70.0)]
    for k, eid in enumerate(range(10, 16)):
        t = 200.0 + 100.0 * k
        host.append(_event(eid, "cudaMemcpyAsync" if k == 3 else "cudaLaunchKernel", t, t + 1,
                           cuda=False))
        if 2 <= k <= 4:
            dev.append(_event(eid, f"op{k}", t - 30.0 if k == 2 else t + 5, 940.0 if k == 4 else t + 9))
    rec = probe.session_record(host + dev, (100.0, 900.0))
    assert rec == {"launches": 6, "lost": 3, "lost_first": 2, "lost_last": 1, "early_ms": 0.03,
                   "late_ms": 0.04, "stray": 1}


@pytest.mark.parametrize("empty", [0, 1, 2, 3])
def test_empty_session_taken_again_then_raises(monkeypatch, empty):
    calls = []
    real = profiling._profile_once

    def flaky(fn, dev):
        calls.append(1)
        events, wall = real(fn, dev)
        return ([] if len(calls) <= empty else events), wall

    monkeypatch.setattr(profiling, "_profile_once", flaky)
    if empty < profiling.SESSIONS:
        tr = profiling.device_time_by_kernel(_ops, "cpu")
        assert tr.busy_ms > 0 and len(calls) == empty + 1
    else:
        with pytest.raises(RuntimeError, match="no device operation"):
            profiling.device_time_by_kernel(_ops, "cpu")
        assert len(calls) == profiling.SESSIONS


def test_time_ms_and_profile_path_on_cpu():
    t = profiling.time_ms({"ops": _ops, "add": lambda: torch.ones(4) + 1}, reps=3, rounds=2,
                          device="cpu")
    assert set(t) == {"ops", "add"} and all(v > 0 for v in t.values())
    with pytest.raises(ValueError, match="CUDA"):
        profiling.time_ms({"ops": _ops}, graph=True, device="cpu")

    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.solver.optimizer import solve

    g, _ = build_graph(generate_sequence(20, 10, seed=0)[0], device="cpu")
    p = profiling.profile_path(solve, g, SolverConfig(linear_solver="schur"), iters=2)
    assert p["iters"] == 2 and 0 < p["device_busy_share"] <= 1 and p["device_ops_per_iter"] > 0
    assert len(p["top"]) == 8
