"""Fixtures of the benchmark's tests: a checkout root in a temporary
directory that holds BENCHMARK.json, the metric readers and one small
cell, ``tiny.<traffic>``, added as data files only: the repository's walk
configuration cut to ``TINY``'s size, under the limits that the
repository's cell commits (``benchmark/checks/walk_10k.gn_pcg_jacobi.json``)."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
CELL = "walk_10k.gn_pcg_jacobi"

# a size that a CPU test run holds: poses, landmarks, GN outer steps
TINY = (300, 120, 5)
# a traffic mix that only the tests add: whole solves through
# optimizer.solve's exact Schur path instead of the packed PCG
EXACT = {"what": "a test's: whole solves through optimizer.solve, exact Schur solve",
         "entry": "solve", "solver": {"linear_solver": "schur"}, "pool": 2}


def committed_checks() -> dict:
    return json.loads((BENCH / "checks" / f"{CELL}.json").read_text())


def make_root(tmp: Path, traffic: str, checks: dict | None = None) -> Path:
    """A root with the repository's BENCHMARK.json plus a cell
    ``tiny.<traffic>`` (``traffic``: the repository's "gn_pcg_jacobi", or
    "exact", ``EXACT``), two graphs in its pool, two traced solves, under
    the committed limits (or ``checks``)."""
    root = tmp / "checkout"
    shutil.copytree(BENCH / "metrics", root / "benchmark" / "metrics")
    for d in ("configs", "traffic", "checks"):
        (root / "benchmark" / d).mkdir()
    n_poses, n_landmarks, iters = TINY
    cfg = json.loads((BENCH / "configs" / "walk_10k.json").read_text())
    cfg["graph"].update(n_poses=n_poses, n_landmarks=n_landmarks)
    cfg["solver"]["iters"] = iters
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = (EXACT if traffic == "exact"
          else json.loads((BENCH / "traffic" / f"{traffic}.json").read_text()))
    (root / "benchmark" / "traffic" / f"{traffic}.json").write_text(
        json.dumps({**tr, "trace_solves": 2}))
    checks = committed_checks() if checks is None else checks
    (root / "benchmark" / "checks" / f"tiny.{traffic}.json").write_text(json.dumps(checks))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test's", "reduced": ["n_poses"],
                             "file": "benchmark/configs/tiny.json", "why": "a test's"})
    bench["workloads"].append({"name": f"tiny.{traffic}", "config": "tiny", "traffic": traffic,
                               "chips": 1, "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(f"tiny.{traffic}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return lambda traffic, checks=None: make_root(tmp_path, traffic, checks)
