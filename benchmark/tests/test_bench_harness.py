"""The harness on the CPU: a cell added as files runs without a code
edit; unknown names fail with a clear message; a run without a card exits
non-zero and prints no result, and so does a checkout that holds only the
benchmark; and a run whose timed path is broken underneath comes out not
correct, once for each fault a cell of this benchmark can have (the
harness's look for a card is skipped: the runs are on the CPU).  The small
cells are held to the limits that the repository's cell commits."""

import json
import logging
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.harness.faults import FAULTS
from benchmark.tests.conftest import BENCH, REPO

logging.getLogger("boslam_torch").setLevel(logging.ERROR)


def _run(root, cell, trace=False, seconds=0.3, fault=None):
    torch.set_num_threads(1)
    return runner.run(root, cell, 2**31 + 17, seconds, trace, device="cpu", fault=fault)


def test_cells_of_the_repository_load():
    assert spec.cell_names(REPO) == ["walk_10k.gn_pcg_jacobi"]
    for name in spec.cell_names(REPO):
        cell = spec.load_cell(REPO, name)
        assert [m.name for m in cell.end_to_end][-1] == "setup_s" and cell.per_layer


@pytest.mark.parametrize("traffic", ["exact", "gn_pcg_jacobi"])
def test_a_cell_added_as_files_runs(tiny_root, traffic):
    root = tiny_root(traffic)
    assert f"tiny.{traffic}" in spec.cell_names(root)
    r = _run(root, f"tiny.{traffic}")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"iters_per_s", "setup_s"}
    assert list(r)[-2:] == ["checks", "_verdict"]
    t = _run(root, f"tiny.{traffic}", trace=True)
    want = {"build_ms", "ops_per_iter", "device_idle"} | (
        {"cg_iters_per_outer"} if traffic == "gn_pcg_jacobi" else set())
    assert set(t["metrics"]) == want and t["correct"]
    assert 0 < t["device"]["busy_s"] <= t["device"]["window_s"]
    assert 0 < len(t["breakdown"]["device_ops"]) <= 10


def test_unknown_names_fail_clearly(tiny_root):
    root = tiny_root("exact")
    with pytest.raises(SystemExit, match="unknown workload 'nope'"):
        spec.load_cell(root, "nope")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "no_reader", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "x", "moves": "iters_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SystemExit, match="metric 'no_reader': no reader"):
        spec.load_cell(root, "tiny.exact")


def _cli(cwd, script):
    return subprocess.run([sys.executable, script, "--workload", "walk_10k.gn_pcg_jacobi",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _cli(REPO, "benchmark/run.py")
    assert out.returncode == 2 and out.stdout == "" and "no measurement" in out.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, "benchmark/run.py")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("traffic", ["exact", "gn_pcg_jacobi"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_root, traffic, fault):
    root = tiny_root(traffic)
    r = _run(root, f"tiny.{traffic}", fault=fault)
    assert not r["correct"] and r["failed"] >= 1


def test_the_control_is_not_correct_and_the_system_is(tiny_root):
    root = tiny_root("gn_pcg_jacobi")
    r = _run(root, "tiny.gn_pcg_jacobi")
    assert r["correct"], r["_verdict"]["readings"]
    torch.set_num_threads(1)
    r = runner.run(root, "tiny.gn_pcg_jacobi", 2**31 + 5, 0.3, False, device="cpu", control=True)
    assert not r["correct"] and r["failed"] >= 1, r["_verdict"]["readings"]
