"""The port's spans and counters (``boslam_torch/utils/spans.py``) on the
CPU: nesting, self times, counters charged to their root, the ring's
bound, one stack per thread; a packed solve's paths and counters against
its own stats; and the profiler: a bare session sees no span of the
program, ``utils/profiling.trace`` and ``device_time_by_kernel`` do."""

import json
import threading
from types import SimpleNamespace

import pytest
import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.build import build_graph
from boslam_torch.solver.optimizer import solve, solve_packed
from boslam_torch.synth import generate_sequence
from boslam_torch.utils import profiling, spans

POSES = 300
CFG = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=3,
                   cg_iters=40)
PACKED = {"solve_packed", "solve_packed/pack", "solve_packed/step",
          "solve_packed/step/assemble", "solve_packed/step/pcg",
          "solve_packed/step/pcg/poll", "solve_packed/step/update"}
BUILD = {"build", "build/ids", "build/upload", "build/triangulate"}


@pytest.fixture(scope="module")
def walk():
    return generate_sequence(POSES, 120, seed=3)[0]


def _last(name):
    return [r for r in spans.records() if r.name == name][-1]


def test_spans_nest_with_parent_and_root_ids():
    with spans.span("outer") as a:
        with spans.span("mid") as b:
            with spans.span("leaf") as c:
                pass
            with spans.span("leaf"):
                pass
    assert a.parent is None and b.parent is a and c.parent is b
    assert a.root_id == b.root_id == c.root_id
    assert (a.path, b.path, c.path) == ("outer", "outer/mid", "outer/mid/leaf")
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= a.end_ns
    rec = spans.records()[-1]
    assert (rec.name, rec.id, rec.start_ns, rec.end_ns) == ("outer", a.root_id, a.start_ns,
                                                            a.end_ns)
    assert set(rec.paths) == {"outer", "outer/mid", "outer/mid/leaf"}
    assert rec.paths["outer/mid/leaf"][0] == 2 and rec.paths["outer"][0] == 1
    for n, total, own in rec.paths.values():
        assert 0 <= own <= total
    # a span's self time is its duration less its children's
    assert rec.paths["outer/mid"][2] == rec.paths["outer/mid"][1] - rec.paths["outer/mid/leaf"][1]
    assert rec.paths["outer"][1] == a.end_ns - a.start_ns
    with spans.span("other") as d:
        pass
    assert d.root_id != a.root_id and spans.records()[-1].id == d.root_id


def test_counters_are_charged_to_the_innermost_root():
    spans.count("nowhere", 5)  # no span open: not kept
    with spans.span("first"):
        spans.count("x")
        with spans.span("inner"):
            spans.count("x", 2)
            spans.count("y", 3)
    with spans.span("second"):
        spans.count("x", 7)
    first, second = spans.records()[-2:]
    assert first.counters == {"x": 3, "y": 3} and second.counters == {"x": 7}
    assert not any("nowhere" in r.counters for r in spans.records())


def test_ring_is_bounded_and_counts_what_it_drops():
    assert spans.RING >= 4096
    dropped = spans.dropped()
    for _ in range(spans.RING + 5):
        with spans.span("fill"):
            pass
    held = spans.records()
    assert len(held) == spans.RING and all(r.name == "fill" for r in held)
    assert spans.dropped() >= dropped + 5
    assert [r.id for r in held] == sorted(r.id for r in held)


def test_each_thread_nests_on_its_own_stack():
    seen = {}
    inside, release = threading.Event(), threading.Event()

    def worker():
        with spans.span("helper") as s:
            inside.set()
            release.wait(5)
        seen["helper"] = s

    with spans.span("main") as m:
        t = threading.Thread(target=worker)
        t.start()
        inside.wait(5)
        with spans.span("child") as c:
            pass
        release.set()
        t.join()
    h = seen["helper"]
    assert h.parent is None and h.path == "helper" and h.root_id != m.root_id
    assert c.parent is m and c.path == "main/child"
    assert {"helper", "main"} <= {r.name for r in spans.records()[-2:]}


def _packed_solve_record(walk, paths):
    """Solve ``walk`` packed; its root's paths must be ``paths`` and its
    counters agree with its stats (on the CPU no body is fused, so
    "cg.fused_bodies" and "cg.loop_fused_bodies" are 0).  Returns the
    root."""
    g, _ = build_graph(walk, init="triangulate", device="cpu")
    assert set(_last("build").paths) == BUILD
    _, stats = solve_packed(g, CFG)
    rec = _last("solve_packed")
    assert set(rec.paths) == paths
    # the walk's grids have no window plan: 4 plain gathers an outer (two
    # in the assembly, the reduced rhs, the back-substitution), 2 a matvec
    assert rec.counters == {"gn.outers": CFG.iters,
                            "cg.bodies": int(stats["cg_matvecs"].sum()),
                            "cg.polls": int(stats["cg_polls"].sum()),
                            "cg.graph_bodies": 0, "cg.fused_bodies": 0,
                            "cg.loop_fused_bodies": 0, "gather.windowed": 0,
                            "gather.plain": 4 * CFG.iters + 2 * int(stats["cg_matvecs"].sum())}
    return rec


def test_packed_solve_lists_loop_closures_under_pack():
    """With loop closures the packing lists them per pose under the span
    "solve_packed/pack/loops"; on the CPU no body is fused, so
    "cg.fused_bodies" and "cg.loop_fused_bodies" are 0."""
    looped = generate_sequence(POSES, 120, seed=3, loop_closures=60)[0]
    _packed_solve_record(looped, PACKED | {"solve_packed/pack/loops"})


def test_packed_solve_paths_and_counters_agree_with_its_stats(walk):
    rec = _packed_solve_record(walk, PACKED)
    assert rec.paths["solve_packed/step"][0] == CFG.iters
    assert rec.paths["solve_packed/step/pcg/poll"][0] == rec.counters["cg.polls"]
    assert rec.paths["solve_packed"][1] == rec.end_ns - rec.start_ns


@pytest.mark.parametrize("entry", ["solve_packed", "solve"])
def test_the_cpu_never_replays_a_cg_block(walk, entry):
    """On the CPU every CG body is launched from the host: both solve paths
    charge "cg.graph_bodies" 0, and their bodies are their stats' matvecs."""
    g, _ = build_graph(walk, init="triangulate", device="cpu")
    _, stats = {"solve_packed": solve_packed, "solve": solve}[entry](g, CFG)
    rec = _last(entry)
    assert rec.counters["cg.graph_bodies"] == 0 and "cg.captures" not in rec.counters
    assert rec.counters["cg.bodies"] == int(stats["cg_matvecs"].sum()) > 0

def test_flat_solve_is_one_root(walk):
    g, _ = build_graph(walk, init="triangulate", device="cpu")
    _, stats = solve(g, CFG)
    rec = _last("solve")
    assert rec.counters == {"cg.bodies": int(stats["cg_matvecs"].sum()),
                            "cg.polls": int(stats["cg_polls"].sum()),
                            "cg.graph_bodies": 0, "cg.fused_bodies": 0,
                            "cg.loop_fused_bodies": 0}
    assert set(rec.paths) == {"solve", "solve/poll"}


def _names(events):
    return {e.name for e in events if e.name.startswith(spans.ANNOTATION)}


def test_a_bare_profiler_session_sees_no_span(walk):
    g, _ = build_graph(walk, init="triangulate", device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        build_graph(walk, init="triangulate", device="cpu")
        solve_packed(g, CFG)
    assert prof.events() and not _names(prof.events())
    assert _last("solve_packed").paths  # the spans ran, unannotated


def test_trace_carries_the_span_names(walk, tmp_path):
    g, _ = build_graph(walk, init="triangulate", device="cpu")
    with profiling.trace(str(tmp_path)) as prof:
        solve_packed(g, CFG)
    want = {spans.ANNOTATION + p for p in PACKED}
    assert _names(prof.events()) == want
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    assert want <= {e.get("name") for e in doc["traceEvents"]}
    # annotations end with the session
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as bare:
        solve_packed(g, CFG)
    assert not _names(bare.events())


def test_device_time_by_kernel_puts_operations_under_spans(walk):
    g, _ = build_graph(walk, init="triangulate", device="cpu")
    tr = profiling.device_time_by_kernel(lambda: solve_packed(g, CFG), "cpu")
    assert not any(k.startswith(spans.ANNOTATION) for k in tr.kernels)
    assert {"solve_packed/pack", "solve_packed/step/assemble", "solve_packed/step/pcg",
            "solve_packed/step/update"} <= set(tr.by_span)
    assert set(tr.by_span) <= PACKED | {"end of call", "outside spans"}
    assert sum(n for _, n, _ in tr.by_span.values()) == tr.n_ops
    assert sum(b for b, _, _ in tr.by_span.values()) == pytest.approx(tr.busy_ms / 1e3)
    pcg = tr.by_span["solve_packed/step/pcg"]
    assert pcg[1] == max(n for _, n, _ in tr.by_span.values())
    # every idle gap is put down to a span: idle by span is the window's idle
    idle = sum(i for _, _, i in tr.by_span.values())
    assert 0 < idle == pytest.approx((tr.window_ms - tr.busy_ms) / 1e3, rel=1e-2)


def _ev(eid, name, t0, t1, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(id=eid, name=name, device_type=kind, device_index=0,
                           device_resource_id=7, thread=1, is_async=False,
                           self_cpu_time_total=t1 - t0,
                           time_range=SimpleNamespace(start=t0, end=t1,
                                                      elapsed_us=lambda: t1 - t0))


def test_card_sessions_drop_annotations_and_name_gaps_by_span():
    """A fake card session: the program's annotations (host ranges and their
    device-side copies) are no device operations; each kernel goes to the
    innermost span around its launch, and each idle gap to the span that
    launched the kernel ending it."""
    host = [_ev(1, profiling.WINDOW, 0.0, 100.0, False),
            _ev(2, spans.ANNOTATION + "solve_packed", 5.0, 90.0, False),
            _ev(3, spans.ANNOTATION + "solve_packed/pack", 6.0, 20.0, False),
            _ev(10, "cudaLaunchKernel", 10.0, 11.0, False),
            _ev(11, "cudaLaunchKernel", 30.0, 31.0, False),
            _ev(12, "cudaLaunchKernel", 95.0, 96.0, False)]
    dev = [_ev(2, spans.ANNOTATION + "solve_packed", 5.0, 90.0, True),
           _ev(10, "k_pack", 20.0, 25.0, True),
           _ev(11, "k_step", 40.0, 50.0, True),
           _ev(12, "k_after", 97.0, 98.0, True)]
    ops, window = profiling._device_ops(host + dev, True)
    assert [e.name for e, _, _ in ops] == ["k_pack", "k_step", "k_after"]
    by = profiling._by_span(ops, host + dev, 0.0, 100.0, True)
    assert by["solve_packed/pack"] == pytest.approx((5e-6, 1, 20e-6))
    assert by["solve_packed"] == pytest.approx((10e-6, 1, 15e-6))
    assert by["outside spans"] == pytest.approx((1e-6, 1, 47e-6))
    assert by["end of call"] == pytest.approx((0.0, 0, 2e-6))
    assert sum(i for _, _, i in by.values()) == pytest.approx(100e-6 - 16e-6)
