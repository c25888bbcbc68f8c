"""The rigid-segment coarse correction (``solver/coarse.py``) against the
JAX package on the CPU.

``total_cost`` is host f64 numpy in both packages: held at rel 1e-9 on the
same inputs.  ``coarse_correct``'s cost trace at rel 1e-5 and its step
choices exactly: each round re-triangulates the landmarks, each package
its own way (the JAX package sums and solves in f32, the port in f64).  The properties (cost cut, monotone trace, the fixed
pose kept, a second application no worse) as tests/test_coarse.py:43-76.
"""

import dataclasses

import numpy as np
import pytest
import torch

from boslam.graph.build import build_graph as build_graph_jax
from boslam.solver import coarse as coarse_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.metrics import ate_metrics, match_gt_poses
from boslam_torch.solver import coarse
from boslam_torch.solver.normal_eq import chi2_stats, edge_terms


@pytest.fixture(scope="module")
def bent():
    """The odometry-integrated init of a 1500-pose walk with 20 closures:
    heavily bent, the coarse correction's target."""
    ig, gt = generate_sequence(1500, 600, seed=0, loop_closures=20)
    gj, meta = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj, gt, meta


def _state64(g):
    return g.poses.numpy().astype(np.float64), g.landmarks.numpy().astype(np.float64)


@pytest.mark.parametrize("kt", [None, 1.0, 100.0])
def test_total_cost_matches_jax(bent, kt):
    g, gj, _, _ = bent
    got = coarse.total_cost(*_state64(g), g, kt)
    want = coarse_jax.total_cost(np.asarray(gj.poses, np.float64),
                                 np.asarray(gj.landmarks, np.float64), gj, kt)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert got == coarse.total_cost(*_state64(g), coarse.host_edges(g), kt)


def test_total_cost_matches_device_chi2(bent):
    """The host objective is the solver's robust chi2 (tests/test_coarse.py:27)."""
    g, _, _, _ = bent
    cfg = SolverConfig(kernel_threshold=1.0)
    chi2 = float(chi2_stats(edge_terms(g, cfg), cfg)["chi2_robust"])
    np.testing.assert_allclose(coarse.total_cost(*_state64(g), g, kt=1.0), chi2, rtol=1e-4)


def _jax_triangulation(poses, b_pose, b_lm, b_meas, *, n_landmarks):
    """The JAX package's f32 triangulation, on the port's tensors."""
    import jax.numpy as jnp

    from boslam.init.triangulation import triangulate_landmarks

    out = triangulate_landmarks(*(jnp.asarray(t.numpy()) for t in (poses, b_pose, b_lm, b_meas)),
                                n_landmarks=n_landmarks)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("seg, rounds, kt", [(32, 3, None), (64, 2, 100.0)])
def test_coarse_correct_matches_jax(bent, seg, rounds, kt, monkeypatch):
    """With the JAX package's f32 triangulation in the port, everything else
    is host f64 on the same inputs: the same step choices and the whole
    cost trace at rel 1e-9.  With each package's own triangulation, the
    first round's step and costs at rel 1e-5 (8.8e-6 measured at seg 32);
    later rounds start from landmarks that the two triangulations put
    apart (tests/test_torch_io_graph.py's bound), and near the optimum a
    round's accept-or-stop falls either way (seg 32's third round: the port
    takes alpha 1/2 for a 5e-6 relative cut that the JAX package's
    landmarks do not give)."""
    import boslam_torch.init.triangulation as tri

    g, gj, _, _ = bent
    gj2, info_j = coarse_jax.coarse_correct(gj, seg=seg, rounds=rounds, kt=kt)
    g2, info = coarse.coarse_correct(g, seg=seg, rounds=rounds, kt=kt)
    assert info["alphas"][0] == info_j["alphas"][0] is not None
    np.testing.assert_allclose(info["cost_trace"][:2], info_j["cost_trace"][:2], rtol=1e-5)
    assert g2.device.type == "cpu" and g2.poses.dtype == torch.float32
    monkeypatch.setattr(tri, "triangulate_landmarks", _jax_triangulation)
    g3, info3 = coarse.coarse_correct(g, seg=seg, rounds=rounds, kt=kt)
    assert info3["alphas"] == info_j["alphas"]
    np.testing.assert_allclose(info3["cost_trace"], info_j["cost_trace"], rtol=1e-9)
    np.testing.assert_allclose(g3.poses.numpy(), np.asarray(gj2.poses), rtol=1e-6, atol=1e-6)


def test_coarse_reduces_cost_and_ate(bent):
    g, _, gt, meta = bent
    gt_poses = match_gt_poses(meta, gt)
    c0 = coarse.total_cost(*_state64(g), g, None)
    g2, info = coarse.coarse_correct(g, seg=32, rounds=4)
    assert info["cost_trace"][0] == c0
    assert info["cost_trace"][-1] < 0.2 * c0
    m0 = ate_metrics(g.poses.numpy(), gt_poses)
    m1 = ate_metrics(g2.poses.numpy(), gt_poses)
    assert m1["ate_rmse_aligned"] < m0["ate_rmse_aligned"]
    fix = int(g.fixed_pose_ix)
    np.testing.assert_allclose(g2.poses.numpy()[fix], g.poses.numpy()[fix], atol=1e-6)


def test_coarse_no_op_near_optimum(bent):
    """Backtracking never accepts an ascent, and a second application from
    the corrected state does not raise the cost."""
    g, _, _, _ = bent
    g2, info = coarse.coarse_correct(g, seg=32, rounds=2)
    tr = info["cost_trace"]
    assert all(b <= a * (1 + 1e-12) for a, b in zip(tr, tr[1:]))
    _, info2 = coarse.coarse_correct(g2, seg=32, rounds=2)
    assert info2["cost_trace"][-1] <= info2["cost_trace"][0] * (1 + 1e-12)
