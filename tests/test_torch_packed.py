"""The packed scale path against the JAX package on the CPU: the packing,
the packed blocks, matvec and diagonal on one shared packing, and whole
packed solves (windowed gathers in Pallas interpret mode on the JAX side).

Tolerances.  Blocks, matvec and diagonal: rtol 1e-5, with an atol of 1e-5
of the array's largest magnitude for entries that cancel to near zero (the
gap ``_close`` prints is at most 3.9e-7 of it).  Whole solves: chi2 at iteration 0
rtol 1e-5 (test_schur_packed.py:86), later GN iterations 2e-3
(test_schur_packed.py:195,220, test_windowed_gather.py:88).  LM is held
for its first two trials, as tests/test_torch_solve.py holds flat LM: on
this graph the JAX package's own windowed and take LM runs part by 1.6e-2
at the fourth trial and 0.19 at the fifth, and the port's take run parts
from the JAX one by 3.1e-3 at the third (truncated f32 CG at LM's small
dampings; tools/port_packed_scan.py --what lm --jax), so no bound between
two f32 runs holds past the second.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.graph.packed import pack_edges as pack_edges_jax
from boslam.graph.reorder import reorder_landmarks_by_pose as reorder_jax
from boslam.solver import optimizer as opt_jax
from boslam.solver import schur as schur_jax
from boslam.solver import schur_packed as sp_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.graph.packed import PackedEdges, pack_edges
from boslam_torch.graph.reorder import reorder_landmarks_by_pose
from boslam_torch.solver import optimizer as opt
from boslam_torch.solver import schur_packed as sp

TRACE_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _graphs(kind):
    """("corridor", reordered or not) or ("closures",): the corridor of
    the windowed path and a default walk with 8 loop closures."""
    if kind == "closures":
        ig, _ = generate_sequence(300, 120, seed=11, loop_closures=8)
    else:
        ig, _ = generate_sequence(600, 240, seed=3, turn_every=10**9)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


def _packing_arrays(pk_j) -> dict:
    """The JAX packing as numpy (``dataclasses.asdict``, arrays through np.asarray)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v if v is None or isinstance(v, (bool, int)) else np.asarray(v)

    return {k: conv(v) for k, v in dataclasses.asdict(pk_j).items()}


def _shared_packing(g, gj, windows, split_lm="auto"):
    """Both packages on one packing: the JAX one, carried into the port."""
    if windows:
        gj = reorder_jax(gj)[0]
        g = reorder_landmarks_by_pose(g)[0]
    pk_j, _ = pack_edges_jax(gj, windows=windows, split_lm=split_lm)
    return g, gj, PackedEdges.from_numpy(_packing_arrays(pk_j), device="cpu"), pk_j


def _close(a, b, rtol=1e-5, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    print(f"{name}: max |port - jax| / max |jax| = {np.abs(a - b).max() / scale:.2e}")
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("kind, windows, split_lm", [
    ("corridor", True, "auto"), ("corridor", False, 8), ("closures", True, "auto"),
    ("closures", False, 8), ("closures", False, None),
])
def test_pack_edges_matches_jax(kind, windows, split_lm):
    """Identical grids, plans, chain_len, l_virt and meta on a corridor and
    on a loop-closure walk, with and without plans, with forced hot-landmark
    splitting."""
    g, gj = _graphs(kind)
    if windows:
        g, gj = reorder_landmarks_by_pose(g)[0], reorder_jax(gj)[0]
    pk, meta = pack_edges(g, windows=windows, split_lm=split_lm)
    pk_j, meta_j = pack_edges_jax(gj, windows=windows, split_lm=split_lm)
    assert dataclasses.asdict(meta) == dataclasses.asdict(meta_j)
    for name in ("p_lm", "p_meas", "p_omega", "l_pose", "l_meas", "l_omega"):
        np.testing.assert_array_equal(getattr(pk, name).numpy(), np.asarray(getattr(pk_j, name)),
                                      err_msg=name)
    assert pk.p_lm.dtype == pk.l_pose.dtype == torch.int32
    assert (pk.chain_len, pk.odometry_is_chain) == (pk_j.chain_len, pk_j.odometry_is_chain)
    assert (pk.l_virt is None) == (pk_j.l_virt is None)
    if pk.l_virt is not None:
        np.testing.assert_array_equal(pk.l_virt.numpy(), np.asarray(pk_j.l_virt))
    for plan, plan_j in ((pk.p_plan, pk_j.p_plan), (pk.l_plan, pk_j.l_plan)):
        assert (plan is None) == (plan_j is None)
        if plan is not None:
            np.testing.assert_array_equal(plan.starts.numpy(), np.asarray(plan_j.starts))
            assert (plan.window, plan.tile_rows) == (plan_j.window, plan_j.tile_rows)
    assert meta.windowed == windows
    if kind == "closures":
        assert pk.chain_len == g.n_poses - 1 < g.n_odometry
    # a packing carried across from the JAX package is the port's own
    pk2 = PackedEdges.from_numpy(_packing_arrays(pk_j), device="cpu")
    for name in ("p_lm", "l_pose", "l_omega"):
        assert torch.equal(getattr(pk2, name), getattr(pk, name))


@pytest.mark.parametrize("kind, windows, split_lm", [
    ("corridor", True, "auto"), ("corridor", False, "auto"), ("closures", False, 8),
])
def test_build_packed_blocks_matches_jax(kind, windows, split_lm):
    g, gj, pk, pk_j = _shared_packing(*_graphs(kind), windows, split_lm)
    cfg, cfg_j = SolverConfig(), SolverConfigJax()
    b, st = sp.build_packed_blocks(g, pk, cfg, cfg.damping)
    b_j, st_j = sp_jax.build_packed_blocks(gj, pk_j, cfg_j, cfg_j.damping)
    for name in ("Hpp_diag", "Hll_inv", "Bp", "Bl", "bp", "bl", "Ho_sd"):
        _close(getattr(b, name).numpy(), getattr(b_j, name), name=name)
    for k in ("chi2_bearing", "chi2_odometry", "chi2_robust"):
        _close(st[k].numpy(), st_j[k], rtol=1e-6, name=k)
    for k in ("n_bearing_clamped", "n_odometry_clamped"):
        assert st[k].item() == int(st_j[k])


@pytest.mark.parametrize("kind, windows, split_lm, row_chunk", [
    ("corridor", True, "auto", 0), ("corridor", False, "auto", 0), ("closures", False, 8, 0),
    ("closures", False, 8, 64),
])
def test_packed_matvec_and_diag_match_jax(kind, windows, split_lm, row_chunk):
    """packed_s_matvec (with and without row chunks) and packed_s_diag on both
    of its branches: the windowed gather and the transposed components."""
    g, gj, pk, pk_j = _shared_packing(*_graphs(kind), windows, split_lm)
    cfg, cfg_j = SolverConfig(), SolverConfigJax()
    b, _ = sp.build_packed_blocks(g, pk, cfg, cfg.damping)
    b_j, _ = sp_jax.build_packed_blocks(gj, pk_j, cfg_j, cfg_j.damping)
    mask = sp._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    mask_j = schur_jax._pose_mask(gj.n_poses, gj.fixed_pose_ix, jnp.float32)
    x = np.random.default_rng(0).standard_normal((g.n_poses, 3)).astype(np.float32)
    y = sp.packed_s_matvec(b, pk, torch.from_numpy(x), mask, row_chunk=row_chunk)
    y_j = sp_jax.packed_s_matvec(b_j, pk_j, jnp.asarray(x), mask_j, row_chunk=row_chunk)
    _close(y.numpy(), y_j, name="matvec")
    _close(sp.packed_s_diag(b, pk).numpy(), sp_jax.packed_s_diag(b_j, pk_j), name="diag")


def _solve_both(g, gj, **kw):
    _, st = opt.solve_packed(g, SolverConfig(linear_solver="schur_cg", **kw))
    _, st_j = opt_jax.solve_packed(gj, SolverConfigJax(linear_solver="schur_cg", **kw))
    return {k: v.numpy() for k, v in st.items()}, {k: np.asarray(v) for k, v in st_j.items()}


@pytest.mark.parametrize("gather", ["take", "windowed"])
@pytest.mark.parametrize("optimizer", ["gn", "lm"])
def test_solve_packed_matches_jax(gather, optimizer):
    """Five packed iterations on the corridor, preconditioner "auto"
    (btridiag here), from the same graph."""
    g, gj = _graphs("corridor")
    st, st_j = _solve_both(g, gj, gather=gather, optimizer=optimizer, iters=5)
    c, c_j = st["chi2_robust"], st_j["chi2_robust"]
    np.testing.assert_allclose(c[0], c_j[0], rtol=1e-5)
    held = 5 if optimizer == "gn" else 2
    np.testing.assert_allclose(c[:held], c_j[:held], rtol=TRACE_RTOL)
    np.testing.assert_array_equal(st["accepted"][:held], st_j["accepted"][:held])
    assert st["chi2_robust"].shape == (5,) and st["dp_final"].shape == (g.n_poses, 3)
    assert np.isfinite(c).all() and st["spd_ok"].all()
    assert (st["cg_matvecs"] >= st["cg_iters"]).all()
    if optimizer == "lm":
        np.testing.assert_allclose(st["damping"][:held + 1], st_j["damping"][:held + 1], rtol=1e-6)
        assert st["lam_final"].shape == ()


def test_solve_packed_closures_split_warm_start():
    """Loop closures (the general odometry path), a forced landmark split,
    block-Jacobi and a warm-started CG, against the JAX package."""
    g, gj = _graphs("closures")
    kw = dict(iters=4, lm_split=8, preconditioner="block_jacobi", cg_warm_start=True,
              cg_tol=1e-6)
    st, st_j = _solve_both(g, gj, **kw)
    np.testing.assert_allclose(st["chi2_robust"][0], st_j["chi2_robust"][0], rtol=1e-5)
    np.testing.assert_allclose(st["chi2_robust"], st_j["chi2_robust"], rtol=TRACE_RTOL)
    # the warm start's r0 matvec is counted
    assert (st["cg_matvecs"] >= st["cg_iters"] + 1).all()


def test_solve_packed_gnc_schedule_and_resume():
    """GNC: the threshold follows the host schedule (kt_at) from
    start_iter on, matches the JAX package's, and lam0/dp0 restore LM."""
    g, gj = _graphs("closures")
    kw = dict(optimizer="lm", iters=3, gnc_kt0=50.0, gnc_anneal_iters=6)
    cfg = SolverConfig(linear_solver="schur_cg", **kw)
    _, st = opt.solve_packed(g, cfg, lam0=0.01, dp0=np.zeros((g.n_poses, 3)), start_iter=2)
    _, st_j = opt_jax.solve_packed(gj, SolverConfigJax(linear_solver="schur_cg", **kw),
                                   lam0=0.01, start_iter=2)
    want = np.array([cfg.kt_at(2 + i) for i in range(3)], np.float32)
    np.testing.assert_array_equal(st["kt"].numpy(), want)
    np.testing.assert_allclose(st["kt"].numpy(), np.asarray(st_j["kt"]), rtol=1e-6)
    np.testing.assert_allclose(st["damping"][0].item(), 0.01, rtol=1e-7)
    np.testing.assert_allclose(st["chi2_robust"][0].item(), float(st_j["chi2_robust"][0]),
                               rtol=1e-5)


@pytest.mark.parametrize("kind, optimizer, cycle", [("corridor", "gn", "additive"),
                                                    ("corridor", "lm", "vcycle"),
                                                    ("closures", "gn", "vcycle"),
                                                    ("closures", "lm", "additive")])
def test_solve_packed_two_level_matches_jax(kind, optimizer, cycle):
    """Packed GN and LM under the two-level preconditioner, both cycles, on
    the corridor and on the 8-closure walk: chi2 at iteration 0 at rtol
    1e-5, later iterations as test_solve_packed_matches_jax holds them.
    Neither the corridor's automatic q (32 of 600 poses) nor the walk's
    ``coarse_q`` 7 (of 300) divides the chain."""
    g, gj = _graphs(kind)
    kw = dict(optimizer=optimizer, preconditioner="two_level", two_level_cycle=cycle, iters=5,
              coarse_q=7 if kind == "closures" else 0)
    st, st_j = _solve_both(g, gj, **kw)
    c, c_j = st["chi2_robust"], st_j["chi2_robust"]
    np.testing.assert_allclose(c[0], c_j[0], rtol=1e-5)
    held = 5 if optimizer == "gn" else 2
    np.testing.assert_allclose(c[:held], c_j[:held], rtol=TRACE_RTOL)
    np.testing.assert_array_equal(st["accepted"][:held], st_j["accepted"][:held])
    assert np.isfinite(c).all() and st["spd_ok"].all() and (st["cg_iters"] > 0).all()


def test_solve_packed_two_level_matches_block_jacobi():
    """The synthetic counterpart of tests/test_two_level.py's
    test_solve_packed_two_level_matches_block_jacobi (which reads the absent
    reference dataset): at the reference dataset's size, 25 packed GN
    iterations at cg_tol 1e-6 reach the same chi2 under two-level and
    block-Jacobi PCG within 1e-3 (that test's bound); the port alone."""
    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence as generate_sequence_torch

    g = build_graph(generate_sequence_torch(301, 141, seed=3)[0], init="triangulate",
                    device="cpu")[0]
    base = SolverConfig(iters=25, linear_solver="schur_cg", cg_iters=150, cg_tol=1e-6)
    _, s_tl = opt.solve_packed(g, base.replace(preconditioner="two_level"))
    _, s_bj = opt.solve_packed(g, base.replace(preconditioner="block_jacobi"))
    a, b = float(s_tl["chi2_robust"][-1]), float(s_bj["chi2_robust"][-1])
    assert abs(a - b) / b < 1e-3


@pytest.mark.parametrize("precond, exc", [("bband", None), ("jacobi", ValueError)])
def test_unported_preconditioners_raise(precond, exc):
    """An unknown preconditioner raises; "bband" is ported now and runs a
    finite step (tests/test_torch_bband.py holds it against the JAX
    package)."""
    g, _ = _graphs("closures")
    cfg = SolverConfig(linear_solver="schur_cg", iters=1, preconditioner=precond)
    if exc is None:
        _, st = opt.solve_packed(g, cfg)
        assert torch.isfinite(st["chi2_robust"]).all() and st["spd_ok"].all()
        return
    with pytest.raises(exc):
        opt.solve_packed(g, cfg)


def test_cli_packed_on_cpu(tmp_path):
    from boslam_torch.cli import main

    path = str(tmp_path / "s.g2o")
    assert main(["synth", "--poses", "80", "--landmarks", "40", "--out", path]) == 0
    for extra in ([], ["--optimizer", "lm", "--preconditioner", "block_jacobi",
                       "--cg-warm-start", "--lm-split", "8", "--gnc-kt0", "20", "--gnc-iters", "2"]):
        assert main(["solve", path, "--packed", "--iters", "3", "--cg-iters", "40",
                     "--device", "cpu", "--gt", path.replace(".g2o", "_ground_truth.g2o"),
                     *extra]) == 0
