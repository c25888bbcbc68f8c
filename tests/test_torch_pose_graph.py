"""The linear pose-graph initializer (``init/pose_graph.py``) against the
JAX package on the CPU.

Both packages compute the pose initializer in host f64 numpy, so on one
host ``linear_pose_init``, ``virtual_closures`` and ``pgo_initialize``'s
poses agree to the bit: any difference is a porting error.  The landmarks
come from the f32 triangulation of each package and are held at the
triangulation bound (atol 2e-2, rtol 1e-3, tests/test_torch_io_graph.py).
The chain-plus-closures solve is held against a dense solve at 1e-9
(tests/test_pose_graph_init.py:39-71).
"""

import dataclasses

import numpy as np
import pytest
import torch

from boslam.graph.build import build_graph as build_graph_jax
from boslam.init import pose_graph as pg_jax
from boslam.synth import generate_sequence
from boslam_torch.graph.data import FactorGraph
from boslam_torch.init import pose_graph as pg


def _graphs(n, nl=None, seed=0, **kw):
    ig, gt = generate_sequence(n, nl, seed=seed, **kw)
    gj, meta = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj, gt, meta


def _edges(gj, o_dst=None):
    return (np.asarray(gj.poses), np.asarray(gj.o_src),
            np.asarray(gj.o_dst) if o_dst is None else o_dst,
            np.asarray(gj.o_meas), np.asarray(gj.o_omega), int(gj.fixed_pose_ix))


def _laplacian_dense(n, w_chain, c_src, c_dst, w_clo):
    L = np.zeros((n, n))
    for (i, j), w in zip([(e, e + 1) for e in range(n - 1)] + list(zip(c_src, c_dst)),
                         list(w_chain) + list(w_clo)):
        L[i, i] += w
        L[j, j] += w
        L[i, j] -= w
        L[j, i] -= w
    return L


@pytest.mark.parametrize("closures", [0, 4])
def test_chain_plus_closures_solve_matches_dense(closures):
    """Closed-form chain solve + Woodbury == the dense anchored Laplacian."""
    rng = np.random.default_rng(closures)
    n = 60
    w_chain = rng.uniform(0.5, 3.0, n - 1)
    c_src = np.array([3, 10, 0, 25], np.int64)[:closures]
    c_dst = np.array([40, 55, 30, 59], np.int64)[:closures]
    w_clo = rng.uniform(0.5, 3.0, closures)
    b = rng.normal(size=n)
    b[0] = 0.0
    x = pg._ChainPlusClosures(w_chain, c_src, c_dst, w_clo).solve(b)
    L = _laplacian_dense(n, w_chain, c_src, c_dst, w_clo)
    x_ref = np.zeros(n)
    x_ref[1:] = np.linalg.solve(L[1:, 1:], b[1:])
    np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(
        x, pg_jax._ChainPlusClosures(w_chain, c_src, c_dst, w_clo).solve(b))


@pytest.mark.parametrize("loop_closures, wrap_rounds", [(0, 3), (10, 3), (10, 1)])
def test_linear_pose_init_bitwise(loop_closures, wrap_rounds):
    _, gj, _, _ = _graphs(500, seed=1, loop_closures=loop_closures)
    got = pg.linear_pose_init(*_edges(gj), wrap_rounds=wrap_rounds)
    want = pg_jax.linear_pose_init(*_edges(gj), wrap_rounds=wrap_rounds)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_virtual_closures_bitwise():
    """On a 2000-pose walk with 40 closures, whose re-observed landmarks give
    segment pairs; the closures then feed a linear init, also to the bit."""
    _, gj, _, _ = _graphs(2000, 800, seed=1, loop_closures=40)
    args = (np.asarray(gj.poses, np.float64), np.asarray(gj.b_pose), np.asarray(gj.b_lm),
            np.asarray(gj.b_meas, np.float64))
    got, want = pg.virtual_closures(*args), pg_jax.virtual_closures(*args)
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pg.linear_pose_init(*_edges(gj), extra=got),
                                  pg_jax.linear_pose_init(*_edges(gj), extra=want))


@pytest.mark.parametrize("landmark_rounds", [0, 2])
def test_pgo_initialize_matches_jax(landmark_rounds):
    """Poses to the bit; landmarks at the triangulation bound; the edges
    are untouched and the graph stays on its device."""
    g, gj, _, _ = _graphs(1200, 480, seed=2, loop_closures=20)
    g2 = pg.pgo_initialize(g, landmark_rounds=landmark_rounds)
    gj2 = pg_jax.pgo_initialize(gj, landmark_rounds=landmark_rounds)
    assert g2.device.type == "cpu" and g2.poses.dtype == torch.float32
    np.testing.assert_array_equal(g2.poses.numpy(), np.asarray(gj2.poses))
    np.testing.assert_allclose(g2.landmarks.numpy(), np.asarray(gj2.landmarks), atol=2e-2,
                               rtol=1e-3)
    assert torch.equal(g2.o_meas, g.o_meas) and torch.equal(g2.b_lm, g.b_lm)
    assert not torch.equal(g2.poses, g.poses)


def test_linear_init_reduces_ate():
    """On a noisy synthetic with closures the init cuts the raw ATE sharply
    (tests/test_pose_graph_init.py:74), and keeps the fixed pose."""
    g, _, gt, _ = _graphs(500, seed=1, loop_closures=10)
    gt_poses = np.asarray(gt.pose_xyt)
    p0 = g.poses.numpy()
    pn = pg.linear_pose_init(p0, g.o_src.numpy(), g.o_dst.numpy(), g.o_meas.numpy(),
                             g.o_omega.numpy(), int(g.fixed_pose_ix))

    def ate(p):
        return np.sqrt(np.mean(np.sum((p[:, :2] - gt_poses[:, :2]) ** 2, -1)))

    assert ate(pn) < 0.4 * ate(p0)
    fix = int(g.fixed_pose_ix)
    np.testing.assert_allclose(pn[fix, :2], p0[fix, :2], atol=1e-9)


def test_linear_init_noiseless_recovers_ground_truth():
    """Zero noise: the linear solve reproduces the ground truth
    (tests/test_pose_graph_init.py:99), here through pgo_initialize."""
    g, _, gt, _ = _graphs(200, seed=3, loop_closures=5, odom_noise=(0.0, 0.0), bearing_noise=0.0,
                          init_noise=(0.0, 0.0))
    g2 = pg.pgo_initialize(g)
    np.testing.assert_allclose(g2.poses.numpy()[:, :2], np.asarray(gt.pose_xyt)[:, :2], atol=1e-3)
    assert torch.isfinite(g2.landmarks).all()


def test_no_chain_falls_back():
    """Odometry without a full i->i+1 chain: the init declines and keeps the
    poses (tests/test_pose_graph_init.py:131), as the JAX package's."""
    _, gj, _, _ = _graphs(50, seed=0)
    o_dst = np.asarray(gj.o_dst).copy()
    o_dst[10] = 30
    got = pg.linear_pose_init(*_edges(gj, o_dst))
    np.testing.assert_array_equal(got, np.asarray(gj.poses))
    np.testing.assert_array_equal(got, pg_jax.linear_pose_init(*_edges(gj, o_dst)))
