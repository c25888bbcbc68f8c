"""Autodiff Jacobians (``use_autodiff_jacobians``, ``residuals.*_autodiff``)
against the JAX package's on the CPU.

Tolerances.  Jacobians against JAX's jacfwd: rtol 1e-5 with an atol of
1e-5 of the largest entry (both are f32 forward-mode derivatives of the
same expressions; the gap seen is <= 9.5e-7 on entries up to ~10).
Against the analytic blocks: test_jacobians.py:46's atol 5e-4, rtol 1e-3.
Solves: GN-schur 50 converged chi2 at rel 1e-5 against JAX
(test_torch_solve.py's bound) and against the port's analytic run; GN-dense
at test_torch_solve.py's trace bound, rtol 5e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boslam.solver import residuals as R_jax
from boslam_torch.solver import normal_eq as ne
from boslam_torch.solver import residuals as R
from tests.test_torch_solve import TRACE_RTOL, SolverConfig, _graphs, _solve_both, opt


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5 * np.abs(b).max())


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_state(seed):
    rng = np.random.default_rng(seed)
    poses = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    lms = rng.uniform(-5, 5, (32, 2)).astype(np.float32)
    b_pose = rng.integers(0, 64, 128).astype(np.int64)
    b_lm = rng.integers(0, 32, 128).astype(np.int64)
    b_meas = rng.uniform(-np.pi, np.pi, 128).astype(np.float32)
    o_src = rng.integers(0, 64, 80).astype(np.int64)
    o_dst = (o_src + rng.integers(1, 5, 80)) % 64
    o_meas = rng.uniform(-2, 2, (80, 3)).astype(np.float32)
    return poses, lms, b_pose, b_lm, b_meas, o_src, o_dst, o_meas


@pytest.mark.parametrize("seed", [0, 1])
def test_autodiff_jacobians_match_jax_and_analytic(seed):
    poses, lms, b_pose, b_lm, b_meas, o_src, o_dst, o_meas = _random_state(seed)
    t = torch.from_numpy
    jp, jl = R.bearing_jacobians_autodiff(t(poses), t(lms), t(b_pose), t(b_lm), t(b_meas))
    js, jd = R.odometry_jacobians_autodiff(t(poses), t(o_src), t(o_dst), t(o_meas))
    for x in (jp, jl, js, jd):
        assert x.dtype == torch.float32
    assert jp.shape == (128, 3) and jl.shape == (128, 2) and js.shape == jd.shape == (80, 3, 3)
    jp_j, jl_j = R_jax.bearing_jacobians_autodiff(
        jnp.asarray(poses), jnp.asarray(lms), jnp.asarray(b_pose), jnp.asarray(b_lm),
        jnp.asarray(b_meas))
    js_j, jd_j = R_jax.odometry_jacobians_autodiff(
        jnp.asarray(poses), jnp.asarray(o_src), jnp.asarray(o_dst), jnp.asarray(o_meas))
    for a, b in ((jp, jp_j), (jl, jl_j), (js, js_j), (jd, jd_j)):
        _close(a.numpy(), b)
    ap, al = R.bearing_jacobians_from(t(poses)[t(b_pose)], t(lms)[t(b_lm)])
    as_, ad = R.odometry_jacobians_from(t(poses)[t(o_src)], t(poses)[t(o_dst)])
    for a, b in ((jp, ap), (jl, al), (js, as_), (jd, ad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4, rtol=1e-3)


def test_edge_terms_autodiff_takes_gathers():
    """With autodiff the edge terms come from index gathers (not the one-hot
    products the "auto" assembly picks here) and equal the analytic terms
    but for the Jacobians' rounding; the assembled H is held likewise."""
    g, _ = _graphs(3)
    cfg = SolverConfig()
    assert ne.use_matmul_assembly(g, cfg)
    t, t_ad = ne.edge_terms(g, cfg), ne.edge_terms(g, cfg.replace(use_autodiff_jacobians=True))
    for name in ("be", "oe", "bchi2", "ochi2", "bw_H", "ow_H"):
        assert torch.equal(getattr(t, name), getattr(t_ad, name)), name
    for name in ("bjp", "bjl", "ojs", "ojd"):
        np.testing.assert_allclose(getattr(t_ad, name).numpy(), getattr(t, name).numpy(),
                                   atol=5e-4, rtol=1e-3)
    H, b, _ = ne.assemble_dense(g, cfg, t)
    H_ad, b_ad, _ = ne.assemble_dense(g, cfg, t_ad)
    _close(H_ad.numpy(), H.numpy(), rtol=1e-3)
    _close(b_ad.numpy(), b.numpy(), rtol=1e-3)


def test_autodiff_gn_schur_converged_matches_jax():
    """GN-schur 50 with autodiff Jacobians on generate_sequence(301, 141,
    seed=3): converged chi2 against JAX's autodiff run and the port's
    analytic run at rel 1e-5."""
    g, gj = _graphs(3)
    _, st, _, stj = _solve_both(g, gj, linear_solver="schur", iters=50,
                                use_autodiff_jacobians=True)
    _, st_an = opt.solve(g, SolverConfig(linear_solver="schur", fused_step="off", iters=50))
    c, cj, c_an = st["chi2_robust"], stj["chi2_robust"], st_an["chi2_robust"].numpy()
    np.testing.assert_allclose(c[0], cj[0], rtol=1e-6)
    assert abs(c[-1] - cj[-1]) / cj[-1] < 1e-5
    assert abs(c[-1] - c_an[-1]) / c_an[-1] < 1e-5
    assert st["spd_ok"].all()


def test_autodiff_gn_dense_matches_jax():
    g, gj = _graphs(3)
    _, st, _, stj = _solve_both(g, gj, linear_solver="dense", iters=3,
                                use_autodiff_jacobians=True)
    np.testing.assert_allclose(st["chi2_robust"], stj["chi2_robust"], rtol=TRACE_RTOL)
    assert st["spd_ok"].all()


def test_autodiff_is_outside_the_whole_step_gate():
    """As in the JAX package, autodiff never takes the whole-step path:
    "force" on the CPU runs the unfused step."""
    g, _ = _graphs(3)
    cfg = SolverConfig(linear_solver="schur", fused_step="force", use_autodiff_jacobians=True)
    assert not opt._fused_step_applicable(g, cfg)
    assert opt._fused_step_applicable(g, cfg.replace(use_autodiff_jacobians=False))
