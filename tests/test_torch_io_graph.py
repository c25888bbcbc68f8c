"""Port parity: g2o I/O, the synthetic generator, graph build, triangulation
and ``FactorGraph.from_numpy`` (boslam_torch against boslam, on the CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import boslam_torch
from boslam.graph.build import build_graph as build_graph_jax
from boslam.init.triangulation import triangulate_landmarks as triangulate_jax
from boslam.io.g2o import parse_g2o as parse_g2o_jax
from boslam.io.g2o import write_g2o as write_g2o_jax
from boslam.synth import generate_sequence as generate_sequence_jax
from boslam_torch.graph.build import build_graph
from boslam_torch.graph.data import FactorGraph
from boslam_torch.init.triangulation import triangulate_landmarks
from boslam_torch.io.g2o import parse_g2o, write_g2o
from boslam_torch.synth import generate_sequence


def _assert_parsed_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("loop_closures", [0, 4])
def test_synth_identical(loop_closures):
    """The numpy copy of the generator gives bit-identical graphs."""
    for a, b in zip(
        generate_sequence(120, 60, seed=5, loop_closures=loop_closures),
        generate_sequence_jax(120, 60, seed=5, loop_closures=loop_closures),
    ):
        _assert_parsed_equal(a, b)


def test_g2o_round_trip(tmp_path):
    """Both writers emit the same text, and both Python parsers read it back
    the same (the native ones: tests/test_torch_native_io.py)."""
    ig, gt = generate_sequence(60, 30, seed=2, loop_closures=2)
    for parsed in (ig, gt):
        p_t, p_j = tmp_path / "t.g2o", tmp_path / "j.g2o"
        args = (parsed.pose_ids, parsed.pose_xyt, parsed.lm_ids, parsed.lm_xy)
        write_g2o(str(p_t), *args, parsed=parsed, fixed_pose_id=parsed.fixed_pose_id)
        write_g2o_jax(str(p_j), *args, parsed=parsed, fixed_pose_id=parsed.fixed_pose_id)
        assert p_t.read_text() == p_j.read_text()
        _assert_parsed_equal(parse_g2o(str(p_t), use_native=False),
                             parse_g2o_jax(str(p_t), use_native=False))


def test_g2o_quirks(tmp_path):
    """Unknown tags are skipped, the 4th bearing field is ignored, the last FIX wins."""
    text = (
        "VERTEX_SE2 3 1.0 -7.5 0.1\nVERTEX_SE2 4 2.0 0.5 0.2\nVERTEX_XY 9 0.5 4.0\n"
        "FIX 3\nFIX 4\nBOGUS 1 2\n\nEDGE_BEARING_SE2_XY 3 9 0.7 57295.8\n"
        "EDGE_SE2 3 4 1.0 0.0 0.1 500 0 0 500 0 5000\n"
    )
    path = tmp_path / "q.g2o"
    path.write_text(text)
    got, want = parse_g2o(str(path), use_native=False), parse_g2o_jax(str(path), use_native=False)
    _assert_parsed_equal(got, want)
    assert got.fixed_pose_id == 4 and got.bearing_omega[0] == 1.0 and got.bound == 10.5


@pytest.mark.parametrize("loop_closures", [0, 4])
def test_build_graph_matches(loop_closures):
    """Indices and state are equal; triangulated landmarks within the JAX
    suite's own triangulation bound (tests/test_triangulation.py: atol
    2e-2, rtol 1e-3): both are f32 segment sums in different orders, and
    near-collinear rays amplify the rounding."""
    ig, _ = generate_sequence_jax(301, 141, seed=0, loop_closures=loop_closures)
    gj, mj = build_graph_jax(ig, init="triangulate")
    gt, mt = build_graph(ig, init="triangulate", device="cpu")
    for name in ("b_pose", "b_lm", "o_src", "o_dst", "fixed_pose_ix"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)))
        assert getattr(gt, name).dtype == torch.int64
    for name in ("poses", "b_meas", "b_omega", "o_meas", "o_omega"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)))
    np.testing.assert_allclose(gt.landmarks.numpy(), np.asarray(gj.landmarks), atol=2e-2, rtol=1e-3)
    assert mt.lm_ids == mj.lm_ids and mt.pose_ids == mj.pose_ids
    assert mt.fixed_pose_id == mj.fixed_pose_id and mt.bound == mj.bound


def test_build_graph_file_init():
    """Ground-truth files keep VERTEX_XY landmarks in file order, exactly."""
    _, gt = generate_sequence(80, 40, seed=1)
    gj, _ = build_graph_jax(gt, init="auto")
    g, _ = build_graph(gt, init="auto", device="cpu")
    np.testing.assert_array_equal(g.landmarks.numpy(), np.asarray(gj.landmarks))


def test_triangulation_matches():
    """Noiseless rays meet at the landmark in both packages (f32 rounding,
    atol 1e-4), and the two agree to the same bound; the rank-1 fallback of
    a single-ray landmark agrees too."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    poses = np.concatenate([rng.uniform(-5, 5, (12, 2)), rng.uniform(-np.pi, np.pi, (12, 1))], 1)
    lms = rng.uniform(-5, 5, (6, 2))
    b_pose = np.concatenate([np.arange(12), [0]])
    b_lm = np.concatenate([np.arange(12) % 5, [5]])  # landmark 5 has one ray
    d = lms[b_lm] - poses[b_pose, :2]
    meas = np.arctan2(d[:, 1], d[:, 0]) - poses[b_pose, 2]
    poses, meas = poses.astype(np.float32), meas.astype(np.float32)
    got = triangulate_landmarks(
        torch.from_numpy(poses), torch.from_numpy(b_pose), torch.from_numpy(b_lm),
        torch.from_numpy(meas), n_landmarks=6,
    ).numpy()
    want = np.asarray(triangulate_jax(
        jnp.asarray(poses), jnp.asarray(b_pose, jnp.int32), jnp.asarray(b_lm, jnp.int32),
        jnp.asarray(meas), n_landmarks=6,
    ))
    np.testing.assert_allclose(got[:5], lms[:5], atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_metrics_match():
    """ATE, rotation and landmark RMSE (raw and aligned) and the ground-truth
    matching agree with the JAX package's numpy metrics: f64 on both sides
    (rtol 1e-12), except that the JAX package wraps the heading errors
    through jnp in f32 (rot_rmse: rtol 1e-6)."""
    from boslam import metrics as metrics_jax
    from boslam_torch import metrics

    ig, gt = generate_sequence(80, 40, seed=6)
    g, meta = build_graph(ig, init="triangulate", device="cpu")
    gt_p, gt_l = metrics.match_gt_poses(meta, gt), metrics.match_gt_landmarks(meta, gt)
    np.testing.assert_array_equal(gt_p, metrics_jax.match_gt_poses(meta, gt))
    np.testing.assert_array_equal(gt_l, metrics_jax.match_gt_landmarks(meta, gt))
    gt_l[3] = np.nan  # a landmark absent from the ground truth is left out
    args = (g.poses.numpy(), gt_p, g.landmarks.numpy(), gt_l)
    got, want = metrics.ate_metrics(*args), metrics_jax.ate_metrics(*args)
    assert set(got) == set(want) == {"ate_rmse", "rot_rmse", "ate_rmse_aligned", "lm_rmse",
                                     "lm_rmse_aligned"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6 if k == "rot_rmse" else 1e-12,
                                   err_msg=k)


def test_from_numpy_carries_jax_graph():
    """A JAX graph carried across keeps every value; indices become int64."""
    ig, _ = generate_sequence_jax(50, 25, seed=4)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    for f in dataclasses.fields(g):
        t = getattr(g, f.name)
        assert t.dtype == (torch.int64 if t.dtype != torch.float32 else torch.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(gj, f.name)))
    assert g.state_dim == gj.state_dim and g.device.type == "cpu"
    g2 = g.to("cpu").with_state(g.poses + 1, g.landmarks)
    assert torch.equal(g2.poses, g.poses + 1) and g2.b_lm is not None
    assert boslam_torch.FactorGraph is FactorGraph
