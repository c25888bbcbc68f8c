"""The reader of ``cg_fused_share`` (``benchmark/metrics/cg_fused_share.py``)
on a fake run and a fake ring, as ``test_bench_graph_share.py`` holds
``cg_graph_share``: the window's fused bodies over its bodies where the
program counts them, 0.0 where it counts none fused, nothing where it
keeps no such counter (a program without the fused body) or no spans."""

import sys

import pytest

import boslam_torch.utils
from benchmark.harness import spec
from benchmark.tests.conftest import REPO
from benchmark.tests.test_bench_span_readers import AFTER, RUN, SETUP, WINDOW, _ring


@pytest.fixture
def read():
    return spec.load_reader(REPO, "cg_fused_share")


@pytest.mark.parametrize("cell", ["walk_10k.gn_pcg_jacobi", "corridor_10k.gn_pcg_jacobi_windowed"])
def test_the_cells_name_the_reader(cell):
    assert "cg_fused_share" in {m.name for m in spec.load_cell(REPO, cell).per_layer}


def _counted(fused_of):
    """The ring with "cg.fused_bodies" set on each root by ``fused_of(root)``."""
    return [r._replace(counters={**r.counters, "cg.fused_bodies": fused_of(r)})
            if r.name == "solve_packed" else r for r in SETUP + WINDOW + AFTER]


def test_fused_bodies_over_bodies(read, monkeypatch):
    # the window's two solves ran 500 bodies each, one of them all fused;
    # the set-up's and the traced solve's bodies are not the window's
    ring = _counted(lambda r: 500)
    win = ring.index(next(r for r in ring if r.id == WINDOW[3].id))
    ring[win] = ring[win]._replace(counters={**ring[win].counters, "cg.fused_bodies": 250})
    _ring(monkeypatch, ring)
    assert read(RUN) == pytest.approx((500 + 250) / 1000)


def test_no_fused_body_reads_zero(read, monkeypatch):
    _ring(monkeypatch, _counted(lambda r: 0))
    assert read(RUN) == 0.0


def test_no_counter_or_no_spans_read_nothing(read, monkeypatch):
    _ring(monkeypatch, SETUP + WINDOW + AFTER)  # roots without the counter
    assert read(RUN) is None
    _ring(monkeypatch, SETUP + AFTER)  # no root in the window
    assert read(RUN) is None
    # a program without the span module: nothing, no error
    monkeypatch.setitem(sys.modules, "boslam_torch.utils.spans", None)
    monkeypatch.delattr(boslam_torch.utils, "spans")
    assert read(RUN) is None
