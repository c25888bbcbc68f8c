"""The port's CLI flows of the survey-scale path on the CPU: the pose-graph
init, the two-level preconditioner with its aggregate size, and the
``bench`` subcommand's JSON line, beside the JAX CLI's."""

import json

import numpy as np
import pytest
import torch

from boslam_torch.cli import main


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    ds = str(tmp_path_factory.mktemp("cli") / "s.g2o")
    assert main(["synth", "--poses", "150", "--landmarks", "60", "--seed", "4",
                 "--loop-closures", "3", "--out", ds]) == 0
    return ds


def _table(out):
    return [line.split() for line in out.splitlines() if line[:4].strip().isdigit()]


def test_pgo_init_flag(dataset, capsys):
    """--pgo-init (with virtual-closure rounds) starts the solve from the
    pose-graph init: its first chi2 is the port's pgo_initialize state's."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.init.pose_graph import pgo_initialize
    from boslam_torch.io.g2o import parse_g2o
    from boslam_torch.solver.normal_eq import chi2_stats, edge_terms

    capsys.readouterr()
    assert main(["solve", dataset, "--pgo-init", "--pgo-lm-rounds", "1", "--iters", "2",
                 "--linear-solver", "schur", "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "pose-graph init applied" in cap.err
    g, _ = build_graph(parse_g2o(dataset), device="cpu")
    cfg = SolverConfig()
    want = float(chi2_stats(edge_terms(pgo_initialize(g, landmark_rounds=1), cfg),
                            cfg)["chi2_robust"])
    np.testing.assert_allclose(float(_table(cap.out)[0][1]), want, rtol=1e-6)


@pytest.mark.parametrize("extra", [["--packed"], ["--packed", "--optimizer", "lm"], []])
def test_two_level_coarse_q_flags(dataset, capsys, extra):
    """--preconditioner two_level --coarse-q on the packed (GN, LM) and the
    flat schur_cg path: the aggregate size reaches the solve (q 7 and q 64
    give other CG counts), the run descends."""
    runs = {}
    for q in ("7", "64"):
        capsys.readouterr()
        assert main(["solve", dataset, "--linear-solver", "schur_cg", "--preconditioner",
                     "two_level", "--coarse-q", q, "--iters", "3", "--cg-tol", "1e-6",
                     "--device", "cpu", *extra]) == 0
        runs[q] = np.array([float(r[1]) for r in _table(capsys.readouterr().out)])
    for c in runs.values():
        assert np.isfinite(c).all() and c[-1] < c[0]
    assert not np.array_equal(runs["7"], runs["64"])


def test_bench_json_line_matches_jax_keys(dataset, capsys):
    """bench --device cpu prints one JSON line with the JAX CLI's keys."""
    from boslam.cli import main as main_jax

    capsys.readouterr()
    assert main(["bench", dataset, "--iters", "3", "--linear-solver", "schur",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert main_jax(["bench", dataset, "--iters", "3", "--linear-solver", "schur",
                     "--platform", "cpu"]) == 0
    rec_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(rec) == sorted(rec_j)
    assert rec["iters"] == 3 and rec["iters_per_s"] > 0 and rec["best_run_s"] > 0
    assert (rec["n_poses"], rec["n_landmarks"], rec["n_edges"]) == (
        rec_j["n_poses"], rec_j["n_landmarks"], rec_j["n_edges"])
    np.testing.assert_allclose(rec["final_chi2"], rec_j["final_chi2"], rtol=5e-4)


def test_bench_refuses_cuda_without_a_card(dataset):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["bench", dataset, "--iters", "1"])
