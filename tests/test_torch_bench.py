"""``python -m boslam_torch.bench``, the port of the root ``bench.py``, on the
CPU: it prints ``bench.py``'s keys, its roofline equals the JAX module's
``roofline_report`` (with ``useful_flops_util``) for the same time and
spec, its chi2 gate refuses a miss, it falls back to the recorded C++
figure, and it raises without CUDA unless the CPU is asked for."""

import ast
import json
import os

import pytest
import torch

from boslam.utils import roofline as RJ
from boslam_torch import bench
from boslam_torch.io.g2o import write_g2o
from boslam_torch.synth import generate_sequence
from boslam_torch.utils.roofline import chip_spec

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SXM = "NVIDIA H100 80GB HBM3"


def _bench_py_keys():
    """The keys of the JSON object the root bench.py prints."""
    tree = ast.parse(open(os.path.join(REPO_ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            return tuple(k.value for k in node.keys)
    raise AssertionError("bench.py prints no metric dict")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The bench's repeated solves on one intra-op thread: the suite runs
    several workers on the same cores, and a worker that spins a thread per
    core slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g2o(tmp_path_factory):
    ig, _ = generate_sequence(40, 20, seed=3)
    path = str(tmp_path_factory.mktemp("bench") / "s.g2o")
    write_g2o(path, ig.pose_ids, ig.pose_xyt, ig.lm_ids, ig.lm_xy, parsed=ig,
              fixed_pose_id=ig.fixed_pose_id)
    return path


@pytest.fixture(scope="module")
def sxm_run(g2o):
    return bench.run("cpu", g2o, spec=chip_spec(SXM))


def test_keys_are_bench_py_keys():
    assert bench.KEYS == _bench_py_keys()


def test_record_and_roofline_equal_jax(sxm_run):
    rec, info = sxm_run
    assert set(bench.KEYS) <= set(rec)
    assert rec["metric"] == "ba_gn_iterations_per_second_full_dataset" and rec["unit"] == "iters/s"
    assert rec["value"] == round(bench.ITERS / info["best_s"], 1)
    assert rec["device"] == "cpu" and rec["chi2_check"]["passed"]
    assert rec["chi2_check"]["reference_is"] == "port CPU solve"
    assert 5 <= len(info["times_s"]) <= 20 and info["best_s"] == min(info["times_s"])
    # the JAX module's functions, the same time and spec
    spec = chip_spec(SXM)
    g = info["graph"]
    dims = (g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry)
    t = info["best_s"] / bench.ITERS
    want = RJ.roofline_report(*RJ.schur_step_model(*dims), t, spec)
    want["useful_flops_util"] = round(RJ.useful_step_flops(*dims) / t / spec.peak_flops_f32, 6)
    assert rec["roofline"] == want
    assert rec["roofline_util"] == want["roofline_util"]


def test_main_prints_one_line_without_a_roofline_on_the_cpu(g2o, capsys):
    """On the CPU no card's peaks apply: the keys are there, the roofline
    is null."""
    assert bench.main(["--device", "cpu", "--g2o", g2o]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(bench.KEYS) <= set(rec)
    assert rec["roofline"] is None and rec["roofline_util"] is None
    assert rec["vs_baseline"] > 0


def test_chi2_gate_refuses_a_miss(g2o, monkeypatch):
    monkeypatch.setattr(bench, "CPU_RTOL", 0.0)  # rel 0 < 0 is false
    with pytest.raises(AssertionError, match="misses the port CPU solve"):
        bench.run("cpu", g2o)


def test_recorded_baseline_without_the_dataset(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(bench, "DATASET", str(tmp_path / "absent.g2o"))
    with open(os.path.join(REPO_ROOT, "tools", "refbench", "baseline.json")) as f:
        want = json.load(f)["iters_per_s"]
    assert bench.reference_baseline() == want
    assert "recorded C++ reference figure" in capsys.readouterr().err


def test_synthetic_graph_when_the_dataset_is_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "DATASET", str(tmp_path / "absent.g2o"))
    parsed, source = bench.load_graph()
    assert source == "generate_sequence(301, 141, seed=3)"
    want, _ = generate_sequence(301, 141, seed=3)
    assert parsed.pose_ids == want.pose_ids and (parsed.pose_xyt == want.pose_xyt).all()


def test_reference_dataset_where_it_exists(monkeypatch, g2o):
    """The fixed dataset path is read when a file lies there, and its chi2
    is then held to the C++ optimum, not to a CPU solve."""
    monkeypatch.setattr(bench, "DATASET", g2o)
    assert bench.load_graph()[1] == g2o
    with pytest.raises(AssertionError, match="misses the C\\+\\+ reference optimum"):
        bench.run("cpu")  # a small synthetic graph's chi2 is not the optimum


def test_raises_without_cuda(g2o):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(None, g2o)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--g2o", g2o])
