"""The port's dense GN against the float64 oracle of the reference's
semantics (``tests/reference_oracle.py``), on the CPU: the port's
counterpart of test_reference_oracle.py::test_mini_matches_oracle, on
synthetic graphs, so it needs no data file.

Both the port's default ``solve`` (GN, dense solve) and ten calls of
``gn_step_dense`` must land on the oracle's iterates at that test's bounds:
poses atol 2e-4, landmarks atol 2e-3, the chi2 trace rtol 1e-3 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.build import build_graph
from boslam_torch.solver.gauss_newton import gn_step_dense
from boslam_torch.solver.optimizer import solve
from boslam_torch.synth import generate_sequence
from tests.reference_oracle import oracle_gn_iterations

ITERS = 10


@pytest.fixture(scope="module", params=[(60, 30, 3, 0), (120, 60, 5, 3)],
                ids=["60x30-seed3", "120x60-seed5-3lc"])
def case(request):
    n_poses, n_landmarks, seed, loop_closures = request.param
    ig, _ = generate_sequence(n_poses, n_landmarks, seed=seed, loop_closures=loop_closures)
    g, _ = build_graph(ig, init="triangulate", device="cpu")
    oracle = oracle_gn_iterations(
        *(x.numpy() for x in (g.poses, g.landmarks, g.b_pose, g.b_lm, g.b_meas, g.b_omega,
                              g.o_src, g.o_dst, g.o_meas, g.o_omega)),
        int(g.fixed_pose_ix), ITERS)
    return g, oracle


def _stepped(g, cfg):
    chi2 = []
    for _ in range(ITERS):
        g, st = gn_step_dense(g, cfg)
        assert st["spd_ok"].item()
        chi2.append(st["chi2_robust"])
    return g, torch.stack(chi2)


@pytest.mark.parametrize("run", ["solve", "gn_step_dense"])
def test_dense_gn_matches_oracle(case, run):
    g, (op, ol, ochi) = case
    cfg = SolverConfig(iters=ITERS)
    if run == "solve":
        g2, stats = solve(g, cfg)
        chi2 = stats["chi2_robust"]
    else:
        g2, chi2 = _stepped(g, cfg)
    np.testing.assert_allclose(g2.poses.numpy(), op, atol=2e-4)
    np.testing.assert_allclose(g2.landmarks.numpy(), ol, atol=2e-3)
    np.testing.assert_allclose(chi2.numpy(), ochi, rtol=1e-3, atol=1e-5)
