"""The readers that the loop-closing walk's cell adds (``benchmark/metrics``:
cg_loop_fused_share, loop_prep_ms, cg_body_roofline) on fake runs and a
fake ring, as ``test_bench_span_readers.py`` holds the other readers of the
program's spans: the window's roots only; nothing where the program keeps
no such counter or span (a program whose fused body has no loop rows, or
that lists no loop closures); the roofline's byte count against a
hand-worked graph, and nothing where a kernel of the body is missing from
the trace.  All three are read in the new cell alone."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest

import boslam_torch.utils
from benchmark.harness import spec
from benchmark.tests.conftest import REPO
from benchmark.tests.test_bench_span_readers import AFTER, RUN, SETUP, WINDOW, _ring

CELL = "walk_10k_loops.gn_pcg_jacobi"
OLD = ("walk_10k.gn_pcg_jacobi", "corridor_10k.gn_pcg_jacobi_windowed")
NAMES = ("cg_loop_fused_share", "loop_prep_ms", "cg_body_roofline")
MS = 1_000_000  # ns in a ms


@pytest.fixture
def readers():
    return {n: spec.load_reader(REPO, n) for n in NAMES}


def _roofline_module():
    import importlib.util

    path = REPO / "benchmark" / "metrics" / "cg_body_roofline.py"
    s = importlib.util.spec_from_file_location("cg_body_roofline_test", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _with(recs, fused=None, loops_ms=None, loop_fused=None):
    """The ring's "solve_packed" roots with "cg.fused_bodies" and
    "cg.loop_fused_bodies" (None: not kept) and the span
    "solve_packed/pack/loops" (None: not there)."""
    out = []
    for r in recs:
        if r.name == "solve_packed":
            counters, paths = dict(r.counters), dict(r.paths)
            if fused is not None:
                counters["cg.fused_bodies"] = fused
            if loop_fused is not None:
                counters["cg.loop_fused_bodies"] = loop_fused
            if loops_ms is not None:
                paths["solve_packed/pack/loops"] = (1, loops_ms * MS, loops_ms * MS)
            r = r._replace(counters=counters, paths=paths)
        out.append(r)
    return out


def test_the_cells_name_the_readers():
    """The three readers in the new cell alone; the old cells' lists of
    the step layer's readers name the new cell nowhere."""
    names = {m.name for m in spec.load_cell(REPO, CELL).per_layer}
    assert set(NAMES) <= names
    assert not {"windowed_gather_share", "window_prep_ms", "cg_fused_share"} & names
    for other in OLD:
        names = {m.name for m in spec.load_cell(REPO, other).per_layer}
        assert not set(NAMES) & names and "cg_fused_share" in names


def test_loop_fused_bodies_over_bodies(readers, monkeypatch):
    # the window's two solves ran 500 bodies each, all fused with loop
    # rows; the set-up's and the traced solve's are not the window's
    read = readers["cg_loop_fused_share"]
    _ring(monkeypatch, _with(SETUP, 500, loop_fused=0) + _with(WINDOW, 500, loop_fused=500)
          + _with(AFTER, 500, loop_fused=0))
    assert read(RUN) == pytest.approx(1.0)
    # fused on a chain: 0.0
    _ring(monkeypatch, _with(SETUP + WINDOW + AFTER, 500, loop_fused=0))
    assert read(RUN) == 0.0


def test_no_loop_counter_or_no_spans_read_nothing(readers, monkeypatch):
    read = readers["cg_loop_fused_share"]
    _ring(monkeypatch, _with(SETUP + WINDOW + AFTER, 500))  # fused, no loop counter
    assert read(RUN) is None
    _ring(monkeypatch, _with(SETUP + AFTER, 500, loop_fused=500))  # no root in the window
    assert read(RUN) is None
    monkeypatch.setitem(sys.modules, "boslam_torch.utils.spans", None)
    monkeypatch.delattr(boslam_torch.utils, "spans")
    assert read(RUN) is None


def test_loop_prep_reads_the_window(readers, monkeypatch):
    # the window's two solves: 3 ms of listing each; the set-up's and the
    # traced solve's are not the window's
    _ring(monkeypatch, _with(SETUP, None, 90) + _with(WINDOW, None, 3) + _with(AFTER, None, 90))
    assert readers["loop_prep_ms"](RUN) == pytest.approx(3.0)
    _ring(monkeypatch, SETUP + WINDOW + AFTER)
    assert readers["loop_prep_ms"](RUN) is None


def test_no_span_or_no_spans_read_nothing(readers, monkeypatch):
    _ring(monkeypatch, SETUP + WINDOW + AFTER)  # a program from before them
    assert readers["loop_prep_ms"](RUN) is None
    monkeypatch.setitem(sys.modules, "boslam_torch.utils.spans", None)
    monkeypatch.delattr(boslam_torch.utils, "spans")
    assert readers["loop_prep_ms"](RUN) is None


def _parsed():
    """A hand-worked graph: poses 10, 11, 12 (in that order), landmarks 20
    and 21 seen by four bearing edges (20 three times), odometry 10 -> 11,
    11 -> 12 (the chain) and 10 -> 12 (a loop closure)."""
    return SimpleNamespace(pose_ids=[10, 11, 12], bearing_meas=np.zeros(4),
                           bearing_lm_id=np.array([20, 20, 21, 20]),
                           odom_src_id=np.array([10, 11, 10]),
                           odom_dst_id=np.array([11, 12, 12]))


def test_body_bytes_of_a_hand_worked_graph():
    mod = _roofline_module()
    assert mod.graph_sizes(_parsed()) == (4, 3, 2, 2, 1)
    # 4 x 32 (bearing) + 3 x 184 (poses) + 2 x 16 (landmarks) + 2 x 36
    # (chain) + 1 x 44 (loop closure)
    assert mod.body_bytes(4, 3, 2, 2, 1) == 828.0
    # a loop closure is no chain edge though its poses are consecutive the
    # other way round
    p = _parsed()
    p.odom_src_id, p.odom_dst_id = np.array([10, 11, 12]), np.array([11, 12, 11])
    assert mod.graph_sizes(p)[3:] == (2, 1)


KERNELS = [["void (anonymous namespace)::pcg_lm_rows_kernel<16>(PCGBodyArgs)", 2e-3],
           ["void (anonymous namespace)::pcg_pose_rows_kernel<8>(PCGBodyArgs)", 3e-3],
           ["(anonymous namespace)::pcg_update_kernel(PCGBodyArgs)", 2e-3],
           ["(anonymous namespace)::pcg_commit_kernel(PCGBodyArgs)", 1e-3],
           ["void at::native::elementwise_kernel<128, 2>", 5e-3]]


def _traced_run(device_ops):
    # the traced solve (graph 1 of the pool) from 120.0 s to 120.7 s: the
    # ring's root AFTER[1]
    traced = [SimpleNamespace(graph=1, t0=120.0, t_end=120.7)]
    return SimpleNamespace(solves=RUN.solves, trace=SimpleNamespace(device_ops=device_ops),
                           traced=traced, pool=[(0, None), (1, _parsed())])


def test_roofline_of_the_traced_bodies(readers, monkeypatch):
    read = readers["cg_body_roofline"]
    _ring(monkeypatch, _with(SETUP + WINDOW, 500) + _with(AFTER, 1))
    # the traced root counts 1 fused body of 828 bytes over 8 ms of the
    # four kernels (the other kernel is not the body's)
    assert read(_traced_run(KERNELS)) == pytest.approx(100 * 828 / 3.35e12 / 8e-3)
    for gone in range(4):
        assert read(_traced_run(KERNELS[:gone] + KERNELS[gone + 1:])) is None
    _ring(monkeypatch, SETUP + WINDOW + AFTER)  # no fused-body counter
    assert read(_traced_run(KERNELS)) is None
    assert read(SimpleNamespace(trace=None, traced=[])) is None
