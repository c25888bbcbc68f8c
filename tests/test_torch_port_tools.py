"""Smoke runs of the port's measurement tools on the CPU (``--device cpu``,
tiny sizes): ``tools/port_headline_ab.py``, ``tools/port_scaling_bench.py``
and ``tools/port_mesh_sweep.py`` each print records that carry the keys
of the JAX tool they port (read from that tool's source), and their
checks hold: every path converged against the CPU, the 1/D slot work, the
all-reduce bytes per build and matvec against the analytic model, and the
chi2 trace of D = 2 against D = 1."""

import ast
import json
import os
import subprocess
import sys

import pytest

from boslam_torch.io.g2o import write_g2o
from boslam_torch.synth import generate_sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO_ROOT, "tools")


def _jax_dict_keys(tool, func, marker):
    """Keys of the dict literal in ``func`` of the JAX tool ``tool`` that
    has the key ``marker``."""
    tree = ast.parse(open(os.path.join(TOOLS, tool)).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if marker in keys:
                return set(keys)
    raise AssertionError(f"{tool}:{func} has no dict with {marker!r}")


def _run(tool, *args, timeout=240):
    # one intra-op thread: the suite runs several workers on the same cores
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, os.path.join(TOOLS, tool), "--device", "cpu", *args],
                         cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _write(path, parsed):
    write_g2o(str(path), parsed.pose_ids, parsed.pose_xyt, parsed.lm_ids, parsed.lm_xy,
              parsed=parsed, fixed_pose_id=parsed.fixed_pose_id)
    return str(path)


@pytest.fixture(scope="module")
def g2o(tmp_path_factory):
    ig, _ = generate_sequence(30, 15, seed=3)
    return _write(tmp_path_factory.mktemp("tools") / "s.g2o", ig)


def test_headline_ab(g2o):
    paths = ["dense", "schur_fused", "packed_bt"]
    out = json.loads(_run("port_headline_ab.py", "--g2o", g2o, "--repeats", "1",
                          "--no-cg-warmup", "--paths", *paths))
    assert _jax_dict_keys("headline_ab.py", "main", "dataset") <= set(out)
    want = _jax_dict_keys("headline_ab.py", "main", "useful_flops_util")
    assert set(out["results"]) == set(paths)
    for name, rec in out["results"].items():
        assert want <= set(rec), name
        assert rec["converged"] and rec["chi2_rel_vs_cpu"] < 1e-4, name
        assert rec["model_util"] is None and rec["useful_flops_util"] is None  # no card's peaks
        assert len(rec["times_ms"]) == 1
    assert out["results"]["packed_bt"]["cg_iters_mean"] > 0
    # the CG path skipped its first run; the kernel paths kept theirs
    assert out["results"]["packed_bt"]["compile_s"] is None
    assert out["results"]["dense"]["compile_s"] >= 0 <= out["results"]["schur_fused"]["compile_s"]
    assert out["chip"] is None and out["device"] == "cpu"


def test_scaling_bench(tmp_path):
    # an empty data directory: config 1 has no stand-in, config 3 takes the
    # synthetic graph with the reference dataset's dimensions
    lines = _run("port_scaling_bench.py", "--configs", "1", "3", "4", "--poses-override",
                 "200", "--data-dir", str(tmp_path)).strip().splitlines()
    recs = {r["config"]: r for r in map(json.loads, lines)}
    assert "absent" in recs[1]["skipped"]
    assert _jax_dict_keys("scaling_bench.py", "config_1_2_3", "ate_rmse") <= set(recs[3])
    assert recs[3]["graph"] == "generate_sequence(301, 141, seed=3)"
    assert recs[3]["chi2_final"] < recs[3]["chi2_initial"]
    r4 = recs[4]
    assert _jax_dict_keys("scaling_bench.py", "config_4_5", "poses_optimized_per_s") <= set(r4)
    assert (_jax_dict_keys("scaling_bench.py", "config_4_5", "cg_cap")
            <= set(r4["tol_controlled"]))
    assert r4["n_poses"] == 200 and r4["chi2_after"] < r4["chi2_initial"]
    assert 0 < r4["cg_iters_mean"] <= 8 and r4["roofline"] is None and r4["memory"] == {}


def test_scaling_bench_reads_the_data_dir(tmp_path):
    """Configs 2-3 read the reference dataset's files where the data
    directory holds them (here a small synthetic graph under their names)."""
    ig, gt = generate_sequence(30, 15, seed=3)
    path = _write(tmp_path / "slam2D_bearing_only_initial_guess.g2o", ig)
    _write(tmp_path / "slam2D_bearing_only_ground_truth.g2o", gt)
    lines = _run("port_scaling_bench.py", "--configs", "1", "2", "--data-dir",
                 str(tmp_path)).strip().splitlines()
    recs = {r["config"]: r for r in map(json.loads, lines)}
    assert str(tmp_path / "mini_initial_guess.g2o") in recs[1]["skipped"]
    r2 = recs[2]
    assert r2["graph"] == path and r2["n_poses"] == 30
    assert r2["chi2_final"] < r2["chi2_initial"] and r2["ate_rmse_aligned"] >= 0


def test_mesh_sweep():
    recs = json.loads(_run("port_mesh_sweep.py", "--devices", "1", "2", "--poses", "200",
                           "--iters", "2", "--cg-iters", "10"))
    want = (_jax_dict_keys("mesh_scaling_bench.py", "run_one", "slots_per_device")
            | {"chi2_rel_vs_1dev", "work_fraction"})
    assert [r["devices"] for r in recs] == [1, 2]
    for r in recs:
        assert want <= set(r)
        assert r["hlo_matvec_allreduce_bytes"] == r["model_matvec_allreduce_bytes"]
        # the model leaves out the stats: three f32 sums and two int64 counts
        assert r["hlo_build_allreduce_bytes"] == r["model_build_allreduce_bytes"] + 3 * 4 + 2 * 8
        assert r["chi2_trace_max_rel_vs_1dev"] < 2e-3
    # half the slots per rank at D = 2, up to the padding to a multiple of D
    assert recs[1]["work_fraction"] < 0.6
    assert recs[1]["slots_on_rank0"] < 0.6 * recs[0]["slots_on_rank0"]


def test_pcg_body_probe():
    """``tools/port_pcg_body_probe.py`` on the CPU, at 600 poses: a walk
    with split landmark rows and a corridor with both grids planned, where
    the twin stands for the kernel (every gap between the two 0, the float64
    bounds of ``one_body_misses`` met), the frozen state kept, and ``pcg``
    with the fused body giving its own body's bits; nothing is timed."""
    sys.path.insert(0, TOOLS)
    try:
        import port_pcg_body_probe as probe
    finally:
        sys.path.remove(TOOLS)
    recs = [json.loads(line) for line in _run("port_pcg_body_probe.py", "--poses", "600",
                                              "--seed", "3").splitlines()]
    assert [r["graph"] for r in recs] == ["walk", "corridor"]
    assert [r["split_rows"] for r in recs] == [True, False]
    assert recs[0]["plans"] == [None, None] and None not in recs[1]["plans"]
    for r in recs:
        for where in ("start", "mid_chain"):
            one = r[where]
            assert one["same_counts"] and not probe.one_body_misses(one)
            assert all(v == 0.0 for k, v in one.items() if k not in ("same_counts", "f64"))
        assert r["frozen_kept"] and "ms_alone" not in r
        p = r["pcg"]
        assert p["x"] == 0.0 and p["rel_res2"][0] == p["rel_res2"][1]
        assert p["iters"][0] == p["iters"][1] and p["fused_bodies"] >= p["iters"][1]


@pytest.mark.parametrize("kernel, twin, missed", [
    ((3.6e-7, 3.0e-7), (2.9e-8, 2.9e-8), False),  # the twin within an ulp by luck
    ((7.6e-6, 7.6e-6), (0.0, 0.0), False),  # 64 ulps: the floor
    ((1.9e-5, 9.9e-6), (2.0e-6, 5.0e-6), False),  # within WORST / BULK of the twin
    ((2.0e-5, 2.0e-5), (1.0e-7, 1.0e-7), True),  # past both
    ((1.0e-3, 1.0e-3), (2.0e-5, 2.0e-5), True),  # a transposed block's whole terms
])
def test_pcg_body_probe_bound_floor(kernel, twin, missed):
    """``one_body_misses``: a vector's gap to the float64 twin is held to a
    factor of the f32 twin's or to FLOOR (64 float32 ulps of the largest
    entry), the larger; a scalar to SCALAR."""
    sys.path.insert(0, TOOLS)
    try:
        import port_pcg_body_probe as probe
    finally:
        sys.path.remove(TOOLS)
    assert probe.FLOOR == 64 * 2.0**-23
    worst, bulk = kernel
    rec = {"f64": {"x": [worst, twin[0], bulk, twin[1]], "rz": [1e-4, 1e-5]}}
    assert probe.one_body_misses(rec) == (["x"] if missed else [])
    rec["f64"]["rz"] = [2e-3, 1e-5]
    assert probe.one_body_misses(rec) == (["x", "rz"] if missed else ["rz"])
