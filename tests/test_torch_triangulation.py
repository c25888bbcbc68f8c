"""The port's triangulation (``boslam_torch/init/triangulation.py``), which
sums and solves in f64 and returns f32, on the CPU.

Held against a numpy f64 triangulation (``_oracle``: the same normal
equations, rank rule and 2x2 solve) within one f32 ulp per coordinate;
against itself under permutations of the edge order, to the bit (the card's
``index_add_`` is atomic, so its order changes from run to run); on a
crafted near-collinear landmark and on the rank-1 cases; and against the
JAX package's f32 triangulation at the JAX suite's bound (atol 2e-2, rtol
1e-3, tests/test_triangulation.py:41).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boslam.init.triangulation import triangulate_landmarks as triangulate_jax
from boslam_torch.graph.build import build_graph
from boslam_torch.init.triangulation import _DEGENERATE_RTOL, triangulate_landmarks
from boslam_torch.synth import generate_sequence

# (n_poses, n_landmarks, seed, loop_closures)
GRAPHS = [(301, 141, 0, 0), (301, 141, 0, 4), (1200, 480, 2, 20)]


def _oracle(poses, b_pose, b_lm, b_meas, n_landmarks):
    """Numpy f64: the per-landmark normal equations, summed by np.add.at,
    the rank test at _DEGENERATE_RTOL, Cramer's rule or the rank-1
    minimum-norm point."""
    p = np.asarray(poses, np.float64)[b_pose]
    ang = p[:, 2] + np.asarray(b_meas, np.float64)
    s, c = np.sin(ang), np.cos(ang)
    rhs = s * p[:, 0] - c * p[:, 1]
    sums = np.zeros((n_landmarks, 5))
    np.add.at(sums, b_lm, np.stack([s * s, -s * c, c * c, s * rhs, -c * rhs], 1))
    A00, A01, A11, B0, B1 = sums.T
    det = A00 * A11 - A01 * A01
    tr = A00 + A11
    ok = det > _DEGENERATE_RTOL * tr * tr
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.where(ok, (A11 * B0 - A01 * B1) / det, (A00 * B0 + A01 * B1) / tr**2)
        y = np.where(ok, (A00 * B1 - A01 * B0) / det, (A01 * B0 + A11 * B1) / tr**2)
    return np.stack([x, y], 1)


def _within_one_ulp(got, want64):
    """Coordinates of ``got`` (f32) more than one f32 ulp from ``want64``
    rounded to f32."""
    want = np.asarray(want64, np.float32)
    lo, hi = np.nextafter(want, np.float32(-np.inf)), np.nextafter(want, np.float32(np.inf))
    return np.argwhere(~((got >= lo) & (got <= hi)))


def _inputs(n_poses, n_landmarks, seed, loop_closures):
    ig, _ = generate_sequence(n_poses, n_landmarks, seed=seed, loop_closures=loop_closures)
    g, _ = build_graph(ig, init="triangulate", device="cpu")
    return g, (g.poses, g.b_pose, g.b_lm, g.b_meas)


def _run(args, n):
    return triangulate_landmarks(*args, n_landmarks=n)


def _numpy(args):
    return [t.numpy() for t in args]


@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: "{}-{}-s{}-c{}".format(*g))
def test_matches_f64_oracle_within_one_ulp(graph):
    g, args = _inputs(*graph)
    got = _run(args, g.n_landmarks)
    assert got.dtype == torch.float32 and got.shape == (g.n_landmarks, 2)
    torch.testing.assert_close(g.landmarks, got, rtol=0, atol=0)  # build_graph's call
    bad = _within_one_ulp(got.numpy(), _oracle(*_numpy(args), g.n_landmarks))
    assert len(bad) == 0, bad


@pytest.mark.parametrize("graph", GRAPHS[1:], ids=lambda g: "{}-{}-s{}-c{}".format(*g))
def test_edge_order_does_not_change_the_bits(graph):
    """Five seeded permutations of the edge arrays: the same f32 bits."""
    g, (poses, b_pose, b_lm, b_meas) = _inputs(*graph)
    ref = _run((poses, b_pose, b_lm, b_meas), g.n_landmarks)
    rng = np.random.default_rng(0)
    for _ in range(5):
        p = torch.from_numpy(rng.permutation(b_pose.shape[0]))
        got = _run((poses, b_pose[p], b_lm[p], b_meas[p]), g.n_landmarks)
        assert torch.equal(got, ref), (got != ref).nonzero()


def _rays(poses, lm):
    """Noise-free f32 bearings of landmark ``lm`` from each pose."""
    d = lm[None, :] - poses[:, :2]
    return (np.arctan2(d[:, 1], d[:, 0]) - poses[:, 2]).astype(np.float32)


def test_near_collinear_landmark():
    """A landmark 800 m off a 1 m baseline of five poses: rays 1.25e-3 rad
    apart, det / tr^2 ~2e-7, twice the rank threshold.  The f64 sums give
    the oracle within one ulp in every edge order, and land near the
    landmark; a second landmark seen by rays that differ in f32 only by
    rounding takes the rank-1 branch in both."""
    rng = np.random.default_rng(7)
    poses = np.zeros((5, 3), np.float32)
    poses[:, 0] = np.linspace(0.0, 1.0, 5)
    poses[:, 2] = rng.uniform(-0.1, 0.1, 5)
    near = np.array([0.5, 800.0])
    far = np.array([0.5, 1e7])
    b_pose = np.concatenate([np.arange(5), np.arange(5)])
    b_lm = np.repeat([0, 1], 5)
    b_meas = np.concatenate([_rays(poses, near), _rays(poses, far)])
    args = (torch.from_numpy(poses), torch.from_numpy(b_pose), torch.from_numpy(b_lm),
            torch.from_numpy(b_meas))
    want = _oracle(poses, b_pose, b_lm, b_meas, 2)
    got = _run(args, 2)
    assert len(_within_one_ulp(got.numpy(), want)) == 0, (got, want)
    for seed in range(5):
        p = torch.from_numpy(np.random.default_rng(seed).permutation(10))
        assert torch.equal(_run((args[0], args[1][p], args[2][p], args[3][p]), 2), got)
    # the near landmark is well-posed: within a few f32 roundings of the
    # bearings (800 m x 1e-7 rad / 1.25e-3 rad) of the truth
    np.testing.assert_allclose(got[0].numpy(), near, atol=2.0)
    # the far one is rank-1 in f64: its point lies on the mean ray's line
    # through the poses, at the minimum norm (within a metre of the origin)
    assert np.linalg.norm(got[1].numpy()) < 1.0


def test_single_ray_and_collinear_rays_rank1():
    """One ray, and two rays along one line: the rank-1 branch, the
    minimum-norm point on the line, within one ulp of the oracle."""
    poses = np.array([[1.0, 0.0, 0.0], [3.0, 2.0, 0.3], [5.0, 4.0, -0.2]], np.float32)
    alpha = 0.7
    b_pose = np.array([0, 1, 2])
    b_lm = np.array([0, 1, 1])
    # landmark 1: both rays along the line y = x - 1 (pose 2 lies on it too)
    b_meas = np.array([alpha, np.pi / 4 - 0.3, np.pi / 4 + 0.2], np.float32)
    args = tuple(map(torch.from_numpy, (poses, b_pose, b_lm, b_meas)))
    got = _run(args, 2).numpy()
    assert len(_within_one_ulp(got, _oracle(poses, b_pose, b_lm, b_meas, 2))) == 0
    s, c = np.sin(alpha), np.cos(alpha)
    assert abs(s * (got[0, 0] - 1.0) - c * got[0, 1]) < 1e-6  # on the ray's line
    np.testing.assert_allclose(got[1], [0.5, -0.5], atol=1e-6)  # min-norm point of y = x - 1


@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: "{}-{}-s{}-c{}".format(*g))
def test_matches_jax_f32_at_the_jax_suite_bound(graph):
    g, args = _inputs(*graph)
    got = _run(args, g.n_landmarks).numpy()
    poses, b_pose, b_lm, b_meas = _numpy(args)
    want = np.asarray(triangulate_jax(jnp.asarray(poses), jnp.asarray(b_pose, jnp.int32),
                                      jnp.asarray(b_lm, jnp.int32), jnp.asarray(b_meas),
                                      n_landmarks=g.n_landmarks))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-3)
