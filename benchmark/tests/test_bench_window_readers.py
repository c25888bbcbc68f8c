"""The readers of the windowed path (``benchmark/metrics``:
windowed_gather_share, window_prep_ms) on a fake run and a fake ring, as
``test_bench_span_readers.py`` holds the other readers of the program's
spans: the window's roots only; the share 1.0 where every gather was
windowed, 0.0 where the planner refused every grid, and nothing where the
program keeps no route counters (a program from before them); the
preparation's mean over the window's solves that relabelled, nothing
where none did or the program keeps no spans."""

import sys

import pytest

import boslam_torch.utils
from benchmark.harness import spec
from benchmark.tests.conftest import REPO
from benchmark.tests.test_bench_span_readers import AFTER, RUN, SETUP, WINDOW, _ring

CELL = "corridor_10k.gn_pcg_jacobi_windowed"
NAMES = ("windowed_gather_share", "window_prep_ms")
MS = 1_000_000  # ns in a ms


@pytest.fixture
def readers():
    return {n: spec.load_reader(REPO, n) for n in NAMES}


def _with(recs, windowed, plain, prep_ms=None):
    """The ring's "solve_packed" roots with the route counters (None: none
    kept) and, with ``prep_ms`` (reorder, plan_windows), the windowed
    path's two spans; the other roots as they are."""
    out = []
    for r in recs:
        if r.name == "solve_packed":
            counters = dict(r.counters)
            if windowed is not None:
                counters.update({"gather.windowed": windowed, "gather.plain": plain})
            paths = dict(r.paths)
            if prep_ms is not None:
                reorder, plan = prep_ms
                paths["solve_packed/pack/reorder"] = (1, reorder * MS, reorder * MS)
                paths["solve_packed/pack/plan_windows"] = (1, plan * MS, plan * MS)
            r = r._replace(counters=counters, paths=paths)
        out.append(r)
    return out


def test_the_cell_names_the_readers_and_the_walk_does_not():
    assert set(NAMES) <= {m.name for m in spec.load_cell(REPO, CELL).per_layer}
    walk = spec.load_cell(REPO, "walk_10k.gn_pcg_jacobi")
    assert not set(NAMES) & {m.name for m in walk.per_layer}


def test_every_gather_windowed_reads_one(readers, monkeypatch):
    # the set-up's and the traced solve's roots are not the window's
    _ring(monkeypatch, _with(SETUP, 0, 99, (500, 500)) + _with(WINDOW, 1025, 0, (30, 10))
          + _with(AFTER, 0, 99, (500, 500)))
    assert readers["windowed_gather_share"](RUN) == 1.0
    assert readers["window_prep_ms"](RUN) == pytest.approx(40.0)


def test_shares_and_means_over_the_window(readers, monkeypatch):
    window = _with(WINDOW, 300, 100, (30, 10))
    second = next(i for i, r in enumerate(window) if r.id == WINDOW[3].id)
    window[second] = _with([window[second]], 700, 900, (50, 30))[0]
    _ring(monkeypatch, SETUP + window + AFTER)
    assert readers["windowed_gather_share"](RUN) == pytest.approx(1000 / 2000)
    assert readers["window_prep_ms"](RUN) == pytest.approx((40 + 80) / 2)


def test_refused_plans_read_zero_and_no_preparation(readers, monkeypatch):
    # gather="windowed" on a walk relabels and plans; "take" does neither
    _ring(monkeypatch, SETUP + _with(WINDOW, 0, 1020, (30, 10)) + AFTER)
    assert readers["windowed_gather_share"](RUN) == 0.0
    _ring(monkeypatch, SETUP + _with(WINDOW, 0, 1020) + AFTER)
    assert readers["windowed_gather_share"](RUN) == 0.0
    assert readers["window_prep_ms"](RUN) is None


def test_a_program_without_the_counters_reads_nothing(readers, monkeypatch):
    # a program that keeps spans but no route counters: no share, no error
    _ring(monkeypatch, SETUP + _with(WINDOW, None, None, (30, 10)) + AFTER)
    assert readers["windowed_gather_share"](RUN) is None
    assert readers["window_prep_ms"](RUN) == pytest.approx(40.0)
    _ring(monkeypatch, SETUP + AFTER)  # no root in the window
    assert {n: r(RUN) for n, r in readers.items()} == {n: None for n in NAMES}
    # a program without the span module: nothing, no error
    monkeypatch.setitem(sys.modules, "boslam_torch.utils.spans", None)
    monkeypatch.delattr(boslam_torch.utils, "spans")
    assert {n: r(RUN) for n, r in readers.items()} == {n: None for n in NAMES}
