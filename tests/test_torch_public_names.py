"""The last public names of the JAX package, in the port: the SE(2) charts,
the whole-graph residual forms, ``gn_step_dense``, the legacy bearings-only
parse, ``pack_delta`` and the sub-package re-exports, each against the
JAX package on the CPU; and every module's public names against the JAX
module's, but for those left out on purpose.

Tolerances: per-edge quantities at ``EDGE_TOL`` (f32 sin, cos and atan2 of
XLA and PyTorch may differ in the last bit, as in test_torch_edge_math.py),
chi2 traces at test_torch_solve.py's ``TRACE_RTOL`` (two f32 summation
orders).  What the port computes twice by the same arithmetic is held
bit for bit.
"""

import ast
import dataclasses
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boslam.config import SolverConfig as SolverConfigJax
from boslam.geometry import se2 as se2_jax
from boslam.graph import data as data_jax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.io.g2o import parse_g2o_bearings_only as parse_bo_jax
from boslam.solver import gauss_newton as gn_jax
from boslam.solver import residuals as res_jax
from boslam.synth import generate_sequence as generate_sequence_jax
from boslam_torch import config
from boslam_torch.config import SolverConfig
from boslam_torch.geometry import se2
from boslam_torch.graph import data
from boslam_torch.graph.data import FactorGraph
from boslam_torch.io.g2o import parse_g2o_bearings_only, write_g2o
from boslam_torch.solver import gauss_newton as gn
from boslam_torch.solver import optimizer as opt
from boslam_torch.solver import residuals as res

EDGE_TOL = dict(rtol=1e-5, atol=1e-5)
TRACE_RTOL = 5e-4
SUBPACKAGES = ("solver", "geometry", "io", "init", "graph", "viz")


def _port_graph(gj):
    return FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                                  device="cpu")


def _graphs(n_poses, n_landmarks, seed, loop_closures=0):
    ig, _ = generate_sequence_jax(n_poses, n_landmarks, seed=seed, loop_closures=loop_closures)
    gj, _ = build_graph_jax(ig, init="triangulate")
    return _port_graph(gj), gj


# ---- SE(2) charts ----


def _poses(n, seed, lo=-20.0, hi=20.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(lo, hi, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def test_charts_match_jax():
    p = _poses(500, 0)
    q = _poses(500, 1)[:, :2]
    tp, tq, jp, jq = torch.from_numpy(p), torch.from_numpy(q), jnp.asarray(p), jnp.asarray(q)
    np.testing.assert_allclose(se2.rot2(tp[:, 2]).numpy(), np.asarray(se2_jax.rot2(jp[:, 2])),
                               **EDGE_TOL)
    T, Tj = se2.v2t(tp), se2_jax.v2t(jp)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), **EDGE_TOL)
    Tn = np.array(Tj)
    np.testing.assert_allclose(se2.t2v(torch.from_numpy(Tn)).numpy(), np.asarray(se2_jax.t2v(Tn)),
                               **EDGE_TOL)
    np.testing.assert_allclose(se2.transform_point(tp, tq).numpy(),
                               np.asarray(se2_jax.transform_point(jp, jq)), **EDGE_TOL)
    # batched over two leading dimensions, as the JAX maps are
    assert se2.v2t(tp.reshape(25, 20, 3)).shape == (25, 20, 3, 3)
    assert se2.rot2(tp[:, 2].reshape(25, 20)).shape == (25, 20, 2, 2)


def test_v2t_t2v_roundtrip():
    """tests/test_geometry.py's round trip, on the port."""
    ep = np.random.default_rng(2).uniform(-3, 3, (64, 3)).astype(np.float32)
    back = se2.t2v(se2.v2t(torch.from_numpy(ep))).numpy()
    np.testing.assert_allclose(back[:, :2], ep[:, :2], atol=1e-5)
    np.testing.assert_allclose(se2.wrap_angle(torch.from_numpy(back[:, 2] - ep[:, 2])).numpy(),
                               0, atol=1e-5)


def test_boxplus_matches_homogeneous_product():
    """boxplus(X, dx) = v2t(dx) * X, tests/test_geometry.py's check, and
    transform_point inverts inverse_transform_point."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.uniform(-2, 2, (32, 3)).astype(np.float32))
    dx = torch.from_numpy(rng.uniform(-0.5, 0.5, (32, 3)).astype(np.float32))
    want = se2.t2v(se2.v2t(dx) @ se2.v2t(X))
    np.testing.assert_allclose(se2.boxplus_pose(X, dx).numpy(), want.numpy(), atol=1e-5)
    p = torch.from_numpy(rng.uniform(-5, 5, (32, 2)).astype(np.float32))
    np.testing.assert_allclose(se2.transform_point(X, se2.inverse_transform_point(X, p)).numpy(),
                               p.numpy(), atol=1e-5)


# ---- whole-graph residual forms ----


@pytest.fixture(scope="module")
def graphs():
    """test_torch_edge_math.py's graph."""
    return _graphs(120, 60, 7, loop_closures=3)


def _whole_graph(mod, g):
    return {
        "bearing_error": mod.bearing_error(g.poses, g.landmarks, g.b_pose, g.b_lm, g.b_meas),
        "odometry_error": mod.odometry_error(g.poses, g.o_src, g.o_dst, g.o_meas),
        "bearing_jacobians": mod.bearing_jacobians(g.poses, g.landmarks, g.b_pose, g.b_lm),
        "odometry_jacobians": mod.odometry_jacobians(g.poses, g.o_src, g.o_dst),
    }


def _flat(x):
    return x if isinstance(x, tuple) else (x,)


def test_whole_graph_forms_match_jax(graphs):
    g, gj = graphs
    got, want = _whole_graph(res, g), _whole_graph(res_jax, gj)
    for name in got:
        for a, b in zip(_flat(got[name]), _flat(want[name]), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **EDGE_TOL)


def test_whole_graph_forms_equal_from_forms(graphs):
    """Each whole-graph form is the gather and the ``_from`` form, bit for bit."""
    g, _ = graphs
    p, l, src, dst = g.poses[g.b_pose], g.landmarks[g.b_lm], g.poses[g.o_src], g.poses[g.o_dst]
    got = _whole_graph(res, g)
    want = {
        "bearing_error": res.bearing_error_from(p, l, g.b_meas),
        "odometry_error": res.odometry_error_from(src, dst, g.o_meas),
        "bearing_jacobians": res.bearing_jacobians_from(p, l),
        "odometry_jacobians": res.odometry_jacobians_from(src, dst),
    }
    for name in got:
        for a, b in zip(_flat(got[name]), _flat(want[name]), strict=True):
            assert torch.equal(a, b), name


# ---- gn_step_dense ----


@pytest.fixture(scope="module")
def small():
    return _graphs(60, 30, 3)


def _steps(step, g, cfg, n):
    trace = []
    for _ in range(n):
        g, st = step(g, cfg)
        trace.append(st)
    return g, trace


@pytest.mark.parametrize("n", [1, 5])
def test_gn_step_dense_matches_jax(small, n):
    """chi2 at every step at ``TRACE_RTOL``, every step SPD, and JAX's
    stats keys exactly (no ``accepted`` or ``damping``, as in JAX)."""
    g, gj = small
    _, tr = _steps(gn.gn_step_dense, g, SolverConfig(), n)
    _, trj = _steps(gn_jax.gn_step_dense_jit, gj, SolverConfigJax(), n)
    assert set(tr[0]) == set(trj[0])
    for k in ("chi2_bearing", "chi2_odometry", "chi2_robust"):
        np.testing.assert_allclose([s[k].item() for s in tr], [np.asarray(s[k]) for s in trj],
                                   rtol=TRACE_RTOL, err_msg=k)
    assert all(s["spd_ok"].item() for s in tr) and all(bool(s["spd_ok"]) for s in trj)
    if n > 1:
        assert tr[-1]["chi2_robust"] < tr[0]["chi2_robust"]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_gn_step_dense_equals_optimizer_gn_step(small, backend):
    """The same step as ``optimizer.gn_step`` under the dense solve, bit for
    bit, under torch.linalg ("xla") and the Cholesky kernel's plain
    version ("pallas"); ``gn_step`` adds only ``accepted`` and ``damping``."""
    g, _ = small
    cfg = SolverConfig(linear_solver="dense", cholesky_backend=backend)
    g1, st = gn.gn_step_dense(g, cfg)
    g2, st2 = opt.gn_step(g, cfg)
    assert torch.equal(g1.poses, g2.poses) and torch.equal(g1.landmarks, g2.landmarks)
    assert set(st2) - set(st) == {"accepted", "damping"}
    for k in st:
        assert torch.equal(st[k], st2[k]), k
    assert gn.gn_step_dense_jit is gn.gn_step_dense


def test_cholesky_rule_without_cfg():
    """No cfg takes torch.linalg, as the JAX package's no-cfg rule takes XLA's."""
    H = torch.eye(128)
    assert not gn._use_cholesky_kernel(H, None)
    assert not gn_jax._use_pallas_cholesky(128, None)
    assert gn._use_cholesky_kernel(H, SolverConfig(cholesky_backend="pallas"))


# ---- the legacy bearings-only parse ----


@pytest.fixture(scope="module")
def g2o_file(tmp_path_factory):
    from boslam_torch.synth import generate_sequence

    _, gt = generate_sequence(80, 40, seed=5, loop_closures=2)
    path = str(tmp_path_factory.mktemp("bo") / "synth.g2o")
    write_g2o(path, gt.pose_ids, gt.pose_xyt, gt.lm_ids, gt.lm_xy, parsed=gt,
              fixed_pose_id=gt.fixed_pose_id)
    return path


@pytest.mark.parametrize("use_native", [False, True])
def test_parse_g2o_bearings_only_matches_jax(g2o_file, use_native):
    """Bit for bit the JAX overload's arrays, the odometry ones empty with
    its dtypes and shapes; ``True`` builds the port's tokenizer, as
    test_torch_native_io.py does."""
    p = parse_g2o_bearings_only(g2o_file, use_native=use_native)
    pj = parse_bo_jax(g2o_file, use_native=False)
    assert p.pose_ids == pj.pose_ids and p.lm_ids == pj.lm_ids
    assert p.fixed_pose_id == pj.fixed_pose_id and abs(p.bound - pj.bound) < 1e-4
    assert len(p.bearing_meas) > 0
    for f in dataclasses.fields(p):
        a, b = getattr(p, f.name), getattr(pj, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert p.odom_src_id.shape == (0,) and p.odom_meas.shape == (0, 3)
    assert p.odom_omega.shape == (0, 3, 3)


# ---- pack_delta ----


def test_pack_delta_equals_jax():
    rng = np.random.default_rng(4)
    dp = rng.standard_normal((7, 3)).astype(np.float32)
    dl = rng.standard_normal((5, 2)).astype(np.float32)
    got, want = data.pack_delta(dp, dl), data_jax.pack_delta(dp, dl)
    assert got.dtype == want.dtype and got.shape == (31,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        data.full_state_vector(torch.from_numpy(dp), torch.from_numpy(dl)),
        data_jax.full_state_vector(dp, dl))


# ---- sub-package re-exports ----


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_exports_equal_jax(name):
    """``__all__`` equals the JAX sub-package's, and each name is the object
    of the module that defines it (a star import gives exactly these)."""
    pkg = importlib.import_module(f"boslam_torch.{name}")
    pkg_j = importlib.import_module(f"boslam.{name}")
    assert pkg.__all__ == pkg_j.__all__
    for attr in pkg.__all__:
        obj = getattr(pkg, attr)
        home = importlib.import_module(obj.__module__)
        assert home.__name__.startswith(f"boslam_torch.{name}.")
        assert getattr(home, attr) is obj, attr
    ns = {}
    exec(f"from boslam_torch.{name} import *", ns)
    assert sorted(k for k in ns if k != "__builtins__") == sorted(pkg_j.__all__)


# ---- every module's public names ----

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The port's module where its name differs from the JAX package's.
PORT_MODULE = {
    "ops/pallas_cholesky.py": "ops/cholesky.py",
    "ops/pallas_schur.py": "ops/schur_solve.py",
    "ops/pallas_gn_step.py": "ops/gn_step.py",
    "utils/hlo.py": "utils/collectives.py",
}
# Left out on purpose (ROADMAP.md, Queue 1): a TPU-only workaround, JAX
# PartitionSpecs, HLO parsing, an unused logger and a config nothing reads.
LEFT_OUT = {
    "config.py": {"MeshConfig"},
    "ops/pallas_gn_step.py": {"detect_odo_chain"},
    "parallel/pose_range.py": {"range_specs"},
    "solver/coarse.py": {"logger"},
    "utils/hlo.py": {"collective_instruction_bytes"},
}


def _public_names(path: pathlib.Path) -> set:
    """Top-level functions, classes and assigned names without a leading
    underscore; in an ``__init__.py`` also the names it imports."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and path.name == "__init__.py":
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def test_public_names_equal_jax_but_those_left_out():
    missing = {}
    for path in sorted((ROOT / "boslam").rglob("*.py")):
        rel = path.relative_to(ROOT / "boslam").as_posix()
        port = ROOT / "boslam_torch" / PORT_MODULE.get(rel, rel)
        assert port.exists(), f"no counterpart of boslam/{rel}"
        gone = _public_names(path) - _public_names(port)
        if gone:
            missing[rel] = gone
    assert missing == LEFT_OUT
