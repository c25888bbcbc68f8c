"""Port parity: residuals, analytic Jacobians, robust kernels, edge terms,
chi2 stats and dense assembly (boslam_torch against boslam, on the CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boslam.config import SolverConfig as SolverConfigJax
from boslam.geometry import se2 as se2_jax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.solver import normal_eq as ne_jax
from boslam.solver import residuals as res_jax
from boslam.solver import robust as robust_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.geometry import se2
from boslam_torch.graph.data import FactorGraph
from boslam_torch.solver import normal_eq as ne
from boslam_torch.solver import residuals as res
from boslam_torch.solver import robust

# f32 transcendental functions (sin, cos, atan2) of XLA and of PyTorch may
# differ in the last bit; every per-edge quantity is a short chain of them.
EDGE_TOL = dict(rtol=1e-5, atol=1e-5)


def _random_edges(n=500, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.concatenate(
        [rng.uniform(-20, 20, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))], 1
    ).astype(np.float32)
    other = np.concatenate(
        [poses[:, :2] + rng.uniform(-10, 10, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))], 1
    ).astype(np.float32)
    meas = rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)
    return poses, other, meas


def test_wrap_and_boxplus():
    p, d, _ = _random_edges()
    d = d * 0.01
    a = np.linspace(-20, 20, 1001, dtype=np.float32)
    np.testing.assert_array_equal(se2.wrap_angle(torch.from_numpy(a)).numpy(),
                                  np.asarray(se2_jax.wrap_angle(jnp.asarray(a))))
    got = se2.boxplus_pose(torch.from_numpy(p), torch.from_numpy(d)).numpy()
    want = np.asarray(se2_jax.boxplus_pose(jnp.asarray(p), jnp.asarray(d)))
    np.testing.assert_allclose(got, want, **EDGE_TOL)


def test_errors_and_jacobians():
    p, o, meas = _random_edges()
    tp, to, tm = (torch.from_numpy(x) for x in (p, o, meas))
    jp, jo, jm = (jnp.asarray(x) for x in (p, o, meas))
    np.testing.assert_allclose(
        res.bearing_error_from(tp, to[:, :2], tm[:, 0]).numpy(),
        np.asarray(res_jax.bearing_error_from(jp, jo[:, :2], jm[:, 0])), **EDGE_TOL)
    np.testing.assert_allclose(
        res.odometry_error_from(tp, to, tm).numpy(),
        np.asarray(res_jax.odometry_error_from(jp, jo, jm)), **EDGE_TOL)
    for a, b in zip(res.bearing_jacobians_from(tp, to[:, :2]),
                    res_jax.bearing_jacobians_from(jp, jo[:, :2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **EDGE_TOL)
    for a, b in zip(res.odometry_jacobians_from(tp, to), res_jax.odometry_jacobians_from(jp, jo)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **EDGE_TOL)


@pytest.mark.parametrize("kernel,quirk", [("threshold", True), ("threshold", False),
                                          ("huber", True), ("none", True)])
def test_robust_kernels(kernel, quirk):
    """Weights and costs agree to f32 rounding (one sqrt and one divide)."""
    chi2 = np.concatenate([[0.0, 1.0], np.random.default_rng(1).exponential(2.0, 300)]).astype(np.float32)
    kw = dict(robust=kernel, reference_kernel_quirk=quirk, kernel_threshold=1.5)
    cfg, cfg_j = SolverConfig(**kw), SolverConfigJax(**kw)
    t, j = torch.from_numpy(chi2), jnp.asarray(chi2)
    for a, b in zip(robust.robust_weights(t, cfg), robust_jax.robust_weights(j, cfg_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(robust.robust_cost(t, cfg).numpy(),
                               np.asarray(robust_jax.robust_cost(j, cfg_j)), rtol=1e-6)


@pytest.fixture(scope="module")
def graphs():
    ig, _ = generate_sequence(120, 60, seed=7, loop_closures=3)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


@pytest.mark.parametrize("assembly", ["matmul", "scatter"])
def test_edge_terms_and_stats(graphs, assembly):
    g, gj = graphs
    cfg, cfg_j = SolverConfig(assembly=assembly), SolverConfigJax(assembly=assembly)
    t, tj = ne.edge_terms(g, cfg), ne_jax.edge_terms(gj, cfg_j)
    for name in t._fields:
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(tj, name)),
                                   err_msg=name, **EDGE_TOL)
    s, sj = ne.chi2_stats(t, cfg), ne_jax.chi2_stats(tj, cfg_j)
    assert set(s) == set(sj)
    for k in s:
        np.testing.assert_allclose(s[k].numpy(), np.asarray(sj[k]), rtol=1e-5, err_msg=k)


def test_gather_modes_bit_equal(graphs):
    """One-hot matmul gathers are exact on the CPU (as test_assembly_modes.py:32
    requires of the JAX package): every edge term is bit-equal."""
    g, _ = graphs
    ts = ne.edge_terms(g, SolverConfig(assembly="scatter"))
    tm = ne.edge_terms(g, SolverConfig(assembly="matmul"))
    for name in ts._fields:
        assert torch.equal(getattr(ts, name), getattr(tm, name)), name


@pytest.mark.parametrize("assembly", ["matmul", "scatter"])
def test_assemble_dense(graphs, assembly):
    """H and b against the JAX package in the same mode, and the two modes
    against each other, at the JAX suite's scatter-vs-matmul bound
    (tests/test_assembly_modes.py: atol 2e-6 * max|H|, 2e-5 * max|b|):
    summation orders differ."""
    g, gj = graphs
    H, b, _ = ne.assemble_dense(g, SolverConfig(assembly=assembly))
    Hj, bj, _ = ne_jax.assemble_dense(gj, SolverConfigJax(assembly=assembly))
    Hs, bs, _ = ne.assemble_dense(g, SolverConfig(assembly="scatter"))
    for Hx, bx in ((np.asarray(Hj), np.asarray(bj)), (Hs.numpy(), bs.numpy())):
        np.testing.assert_allclose(H.numpy(), Hx, atol=2e-6 * np.abs(Hx).max())
        np.testing.assert_allclose(b.numpy(), bx, atol=2e-5 * np.abs(bx).max())
    assert ne.use_matmul_assembly(g, SolverConfig()) == ne_jax.use_matmul_assembly(gj, SolverConfigJax())


@pytest.mark.parametrize("kernel", ["threshold", "huber"])
def test_gnc_threshold_schedule(kernel):
    """kt_at follows the JAX schedule (f32 pow, rtol 1e-6) and is None with
    GNC off; the scheduled tensor threshold drives the robust weights and
    costs as in the JAX package (rtol 1e-6, as test_robust_kernels)."""
    kw = dict(robust=kernel, gnc_kt0=50.0, gnc_anneal_iters=8, kernel_threshold=1.0)
    cfg, cfg_j = SolverConfig(**kw), SolverConfigJax(**kw)
    assert SolverConfig().kt_at(3) is None and SolverConfigJax().kt_at(3) is None
    chi2 = np.random.default_rng(2).exponential(20.0, 300).astype(np.float32)
    t, j = torch.from_numpy(chi2), jnp.asarray(chi2)
    for i in (0, 1, 4, 8, 12):
        kt, kt_j = cfg.kt_at(i), cfg_j.kt_at(i)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kt_j), rtol=1e-6)
        for a, b in zip(robust.robust_weights(t, cfg, kt), robust_jax.robust_weights(j, cfg_j, kt_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        np.testing.assert_allclose(robust.robust_cost(t, cfg, kt).numpy(),
                                   np.asarray(robust_jax.robust_cost(j, cfg_j, kt_j)), rtol=1e-6)


def test_autodiff_jacobians_not_ported(graphs):
    g, _ = graphs
    with pytest.raises(NotImplementedError):
        ne.edge_terms(g, SolverConfig(use_autodiff_jacobians=True))
