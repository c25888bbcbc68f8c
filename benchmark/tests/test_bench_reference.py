"""The plain reference (``benchmark/reference/slam.py``) at small sizes on
the CPU: it recovers a noiseless graph exactly, its Jacobians are the
derivatives of its errors under its boxplus, and on noisy graphs its
float64 solve is the solve the project's solvers approximate in float32."""

import logging

import numpy as np
import pytest
import torch

from benchmark.harness import traffic
from benchmark.reference import slam

KT, DAMPING = 1.0, 0.01


def _noiseless(n_poses=60, n_landmarks=30, seed=3):
    return traffic.generate_sequence(n_poses, n_landmarks, seed=seed, odom_noise=(0.0, 0.0),
                                     bearing_noise=0.0, init_noise=(0.0, 0.0))


def test_noiseless_graph_is_its_own_solution():
    ig, gt = _noiseless()
    pb = slam.problem(ig)
    lms = slam.triangulate(pb)
    # float32 inputs: the rays meet within their rounding
    assert np.allclose(lms.numpy(), gt.lm_xy, atol=2e-4)
    poses, new_lms, ok = slam.gn_step(pb, pb.poses, torch.as_tensor(gt.lm_xy, dtype=torch.float64),
                                   DAMPING, KT)
    assert ok
    assert float(slam.robust_cost(pb, pb.poses, torch.as_tensor(gt.lm_xy).double(), KT)) < 1e-6  # float32 inputs
    assert torch.allclose(poses, pb.poses, atol=1e-5)


def test_jacobians_are_the_errors_derivatives():
    ig, _ = traffic.generate_sequence(40, 20, seed=5)
    pb = slam.problem(ig)
    rng = np.random.default_rng(0)
    poses = pb.poses + torch.as_tensor(rng.normal(0, 0.05, pb.poses.shape))
    lms = slam.triangulate(pb) + torch.as_tensor(rng.normal(0, 0.1, (pb.n_landmarks, 2)))
    be, bjp, bjl = slam.bearing_terms(pb, poses, lms)
    oe, ojs, ojd = slam.odometry_terms(pb, poses)
    h = 1e-6

    def boxplus(p, d):
        c, s = torch.cos(d[2]), torch.sin(d[2])
        return torch.stack([c * p[0] - s * p[1] + d[0], s * p[0] + c * p[1] + d[1], p[2] + d[2]])

    for j in range(3):
        d = torch.zeros(3, dtype=torch.float64)
        d[j] = h
        moved = poses.clone()
        moved[pb.b_pose[0]] = boxplus(poses[pb.b_pose[0]], d)
        num = (slam.bearing_terms(pb, moved, lms)[0][0] - be[0]) / h
        assert float(num) == pytest.approx(float(bjp[0, j]), rel=1e-4, abs=1e-6)
        for which, jac in ((pb.o_src, ojs), (pb.o_dst, ojd)):
            moved = poses.clone()
            moved[which[0]] = boxplus(poses[which[0]], d)
            num = (slam.odometry_terms(pb, moved)[0][0] - oe[0]) / h
            assert torch.allclose(num, jac[0, :, j], rtol=1e-4, atol=1e-5)
    for j in range(2):
        moved = lms.clone()
        moved[pb.b_lm[0], j] += h
        num = (slam.bearing_terms(pb, poses, moved)[0][0] - be[0]) / h
        assert float(num) == pytest.approx(float(bjl[0, j]), rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("linear_solver", ["dense", "schur"])
def test_reference_is_what_the_projects_solvers_approximate(linear_solver):
    """The project's CPU solve in float32 follows the float64 reference's
    chi2 trace through the descent and triangulates the same start."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.io.g2o import ParsedG2O
    from boslam_torch.solver.optimizer import solve

    logging.getLogger("boslam_torch").setLevel(logging.ERROR)
    ig, _ = traffic.generate_sequence(80, 40, seed=11)
    sol = slam.solve(slam.problem(ig), 8, DAMPING, KT)
    g, _ = build_graph(ParsedG2O(**ig._asdict()), init="triangulate", device="cpu")
    assert np.allclose(g.landmarks.numpy(), sol.landmarks0.numpy(), rtol=1e-6, atol=1e-6)
    _, st = solve(g, SolverConfig(linear_solver=linear_solver, iters=8))
    assert np.allclose(st["chi2_robust"].numpy(), sol.chi2, rtol=1e-3)
    assert sol.chi2[-1] < 1e-2 * sol.chi2[0] and sol.failed_steps == 0

