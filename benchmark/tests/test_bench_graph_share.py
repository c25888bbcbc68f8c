"""The reader of ``cg_graph_share`` (``benchmark/metrics/cg_graph_share.py``)
on a fake run and a fake ring, as ``test_bench_span_readers.py`` holds the
other readers of the program's spans: 0.0 where no window root counts a
replayed CG body (a program that launches every body from the host), the
window's replayed bodies over its bodies where they do, nothing without
spans."""

import sys

import pytest

import boslam_torch.utils
from benchmark.harness import spec
from benchmark.tests.conftest import REPO
from benchmark.tests.test_bench_span_readers import AFTER, RUN, SETUP, WINDOW, _ring


@pytest.fixture
def read():
    return spec.load_reader(REPO, "cg_graph_share")


def test_the_cell_names_the_reader():
    cell = spec.load_cell(REPO, "walk_10k.gn_pcg_jacobi")
    assert "cg_graph_share" in {m.name for m in cell.per_layer}


def test_no_replayed_body_reads_zero(read, monkeypatch):
    _ring(monkeypatch, SETUP + WINDOW + AFTER)
    assert read(RUN) == 0.0


def test_replayed_bodies_over_bodies(read, monkeypatch):
    # the window's two solves ran 500 bodies each; the set-up's and the
    # traced solve's replays are not the window's
    counted = {"cg.graph_bodies": 495}
    graphed = [r._replace(counters={**r.counters, **counted}) if r.name == "solve_packed" else r
               for r in SETUP + WINDOW + AFTER]
    win = graphed.index(next(r for r in graphed if r.id == WINDOW[3].id))
    graphed[win] = graphed[win]._replace(counters={**graphed[win].counters,
                                                   "cg.graph_bodies": 400})
    _ring(monkeypatch, graphed)
    assert read(RUN) == pytest.approx((495 + 400) / 1000)


def test_no_spans_read_nothing(read, monkeypatch):
    _ring(monkeypatch, SETUP + AFTER)  # no root in the window
    assert read(RUN) is None
    # a program without the span module: nothing, no error
    monkeypatch.setitem(sys.modules, "boslam_torch.utils.spans", None)
    monkeypatch.delattr(boslam_torch.utils, "spans")
    assert read(RUN) is None
