"""The readers of the program's spans (``benchmark/metrics``: build_ids_ms,
pack_ms, cg_body_us, poll_wait_ms, setup_program_s) on a fake run and a
fake ring: the window's roots only, a mean over what the ring still holds
where it has let the window's first roots go, nothing where a record is
missing or the program keeps no spans."""

import sys
from types import SimpleNamespace

import pytest

import boslam_torch.utils
from benchmark.harness import spec
from benchmark.tests.conftest import REPO
from boslam_torch.utils import spans

NAMES = ("build_ids_ms", "pack_ms", "cg_body_us", "poll_wait_ms", "setup_program_s")
S = 1_000_000_000  # ns in a second


def _rec(name, rid, t0_s, dur_s, paths=None, counters=None):
    t0 = int(t0_s * S)
    return spans.Record(name, rid, t0, t0 + int(dur_s * S), paths or {}, counters or {})


def _solve(rid, t0_s, ids_ms, pack_ms, pcg_ms, poll_ms, bodies, outers):
    """A window solve's two roots: its build and its packed solve."""
    ms = 1_000_000
    build = _rec("build", rid, t0_s, 0.05,
                 {"build": (1, 50 * ms, 1 * ms), "build/ids": (1, ids_ms * ms, ids_ms * ms)})
    solve = _rec("solve_packed", rid + 1, t0_s + 0.06, 0.6,
                 {"solve_packed/pack": (1, pack_ms * ms, pack_ms * ms),
                  "solve_packed/step/pcg": (outers, pcg_ms * ms, (pcg_ms - poll_ms) * ms),
                  "solve_packed/step/pcg/poll": (3 * outers, poll_ms * ms, poll_ms * ms)},
                 {"gn.outers": outers, "cg.bodies": bodies, "cg.polls": 3 * outers})
    return [build, solve]


# set-up: the import (100-102 s), two warm solves (103-105 s); the window
# 110-112 s, two solves; a traced solve after it
SETUP = [_rec("import", 1, 100.0, 2.0), *_solve(2, 103.0, 9, 9, 900, 90, 90, 5),
         *_solve(4, 104.0, 9, 9, 900, 90, 90, 5)]
WINDOW = [*_solve(10, 110.0, 40, 12, 600, 30, 500, 5),
          *_solve(12, 111.0, 60, 16, 800, 50, 500, 5)]
AFTER = _solve(20, 120.0, 999, 999, 999, 99, 1, 1)
RUN = SimpleNamespace(setup_s=12.0, solves=[SimpleNamespace(t0=110.0, t_end=110.7),
                                            SimpleNamespace(t0=111.0, t_end=111.7)])


@pytest.fixture
def readers():
    return {n: spec.load_reader(REPO, n) for n in NAMES}


def _ring(monkeypatch, recs):
    monkeypatch.setattr(spans, "records", lambda: list(recs))


def test_readers_read_the_window(readers, monkeypatch):
    _ring(monkeypatch, SETUP + WINDOW + AFTER)
    got = {n: r(RUN) for n, r in readers.items()}
    assert got["build_ids_ms"] == pytest.approx(50.0)
    assert got["pack_ms"] == pytest.approx(14.0)
    # (600 - 30 + 800 - 50) ms of pcg self time over 1000 bodies
    assert got["cg_body_us"] == pytest.approx(1320.0)
    # (30 + 50) ms of polls over 10 outers
    assert got["poll_wait_ms"] == pytest.approx(8.0)
    # the import (2 s) and two warm solves (0.05 + 0.6 s each)
    assert got["setup_program_s"] == pytest.approx(3.3)


def test_a_ring_that_let_the_first_roots_go(readers, monkeypatch):
    # the set-up and the window's first solve are gone
    _ring(monkeypatch, WINDOW[2:] + AFTER)
    got = {n: r(RUN) for n, r in readers.items()}
    assert got["build_ids_ms"] == pytest.approx(60.0)
    assert got["pack_ms"] == pytest.approx(16.0)
    assert got["cg_body_us"] == pytest.approx(1500.0)
    assert got["poll_wait_ms"] == pytest.approx(10.0)
    assert got["setup_program_s"] is None  # the import is missing


def test_missing_records_read_nothing(readers, monkeypatch):
    _ring(monkeypatch, SETUP + AFTER)  # no root in the window
    got = {n: r(RUN) for n, r in readers.items()}
    assert got == {**{n: None for n in NAMES}, "setup_program_s": pytest.approx(3.3)}
    # a program without the span module (its parent commit): nothing, no error
    monkeypatch.setitem(sys.modules, "boslam_torch.utils.spans", None)
    monkeypatch.delattr(boslam_torch.utils, "spans")
    assert {n: r(RUN) for n, r in readers.items()} == {n: None for n in NAMES}


def test_the_entries_name_their_readers():
    cell = spec.load_cell(REPO, "walk_10k.gn_pcg_jacobi")
    assert set(NAMES) <= {m.name for m in cell.per_layer}


def test_polls_timed_are_held_to_polls_counted(readers, monkeypatch):
    # one window solve counted a poll that no poll span timed
    solve = WINDOW[1]
    off = solve._replace(counters={**solve.counters, "cg.polls": solve.counters["cg.polls"] + 1})
    _ring(monkeypatch, SETUP + [WINDOW[0], off] + WINDOW[2:] + AFTER)
    got = {n: r(RUN) for n, r in readers.items()}
    assert got["poll_wait_ms"] is None
    assert got["cg_body_us"] == pytest.approx(1320.0)


def test_set_up_is_every_root_before_the_window(readers, monkeypatch):
    # the package imported long before the run's set-up began
    early = [_rec("import", 1, 10.0, 2.0), *SETUP[1:]]
    _ring(monkeypatch, early + WINDOW + AFTER)
    assert readers["setup_program_s"](RUN) == pytest.approx(3.3)
