"""Pose-range sharding (``parallel/pose_range.py``) on spawned gloo ranks,
against the JAX package's ``pose_range_solve`` on a virtual CPU mesh of as
many devices and against the port at one rank.

The host arrays of ``prepare_pose_range_host`` equal those of the JAX
``prepare_pose_range`` to the bit (D = 1-4, with and without loop
closures: the halo rows and the suffix padding included).  Solves, under
tests/test_pose_range.py's configuration (block-Jacobi, cg_tol 1e-7, no
landmark split): GN 10 on ``generate_sequence(301, 141, seed=3)`` at
D = 1-4 (3 divides neither count), LM 8 with 6 closures (the
psum_scatter of the suffix edges) at D = 2 and 3, two_level at D = 4.

Tolerances (the JAX suite's, test_pose_range.py): state rtol 5e-3 / atol
5e-4; chi2 rtol 1e-3 (GN), 2e-3 (LM), 5e-3 (two_level); iteration 0 rel
1e-5.  The gauge pose keeps its bits.  Every rank ends with the same bits.
"""

import dataclasses

import numpy as np
import pytest

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.parallel.mesh import make_mesh as make_mesh_jax
from boslam.parallel import pose_range as pr_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.parallel.mesh import spawn
from boslam_torch.parallel.pose_range import pose_range_solve, prepare_pose_range_host

CFG = dict(iters=10, linear_solver="schur_cg", cg_iters=100, cg_tol=1e-7,
           preconditioner="block_jacobi", lm_split=0)
GRAPHS = {"chain": (301, 141, dict(seed=3)), "closures": (120, 60, dict(seed=3, loop_closures=6))}
CASES = {
    "gn": ("chain", {}, 1e-3),
    "lm": ("closures", dict(optimizer="lm", iters=8), 2e-3),
    "two_level": ("chain", dict(iters=4, preconditioner="two_level", cg_iters=40, cg_tol=1e-8),
                  5e-3),
}
AT = {1: ("gn",), 2: ("gn", "lm"), 3: ("gn", "lm"), 4: ("gn", "two_level")}


def _graph(name):
    n_poses, n_landmarks, kw = GRAPHS[name]
    ig, _ = generate_sequence(n_poses, n_landmarks, **kw)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


@pytest.fixture(scope="module")
def graphs():
    return {k: _graph(k) for k in GRAPHS}


@pytest.fixture(scope="module")
def runs(graphs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pose_range")
    port, jax_d = {}, {}
    for D, names in AT.items():
        jobs = [(pose_range_solve, (graphs[CASES[k][0]][0], SolverConfig(**{**CFG, **CASES[k][1]})),
                 {}) for k in names]
        port[D] = spawn(jobs, D, str(tmp / f"store{D}"))
        for name in names:
            gname, kw, _ = CASES[name]
            gd, sd = pr_jax.pose_range_solve(graphs[gname][1], SolverConfigJax(**{**CFG, **kw}),
                                             make_mesh_jax(D, axis_name="range"))
            jax_d[name, D] = (np.asarray(gd.poses), np.asarray(gd.landmarks),
                              {k: np.asarray(v) for k, v in sd.items()})
    return port, jax_d


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_host_arrays_equal_jax(graphs, gname, D):
    g, gj = graphs[gname]
    arrays, meta = prepare_pose_range_host(g, D)
    sh_j, meta_j = pr_jax.prepare_pose_range(gj, make_mesh_jax(D, axis_name="range"))
    assert dataclasses.asdict(meta) == dataclasses.asdict(meta_j)
    assert set(arrays) == {f.name for f in dataclasses.fields(sh_j)}
    for k, v in arrays.items():
        vj = np.asarray(getattr(sh_j, k))
        assert v.dtype == vj.dtype and v.shape == vj.shape, k
        np.testing.assert_array_equal(v, vj, err_msg=k)
    assert meta.has_suffix == (gname == "closures")


@pytest.mark.parametrize("case, D", [(k, D) for D, names in AT.items() for k in names])
def test_matches_jax_and_one_rank(graphs, runs, case, D):
    port, jax_d = runs
    gname, _, chi2_rtol = CASES[case]
    g_p, st = port[D][0][AT[D].index(case)]
    refs = [("jax", jax_d[case, D])]
    if D > 1 and case == "gn":
        refs.append(("one rank", (lambda r: (r[0]["poses"], r[0]["landmarks"], r[1]))(
            port[1][0][0])))
    for ref_name, (poses, lms, ref) in refs:
        c, cr = st["chi2_robust"].astype(np.float64), ref["chi2_robust"].astype(np.float64)
        assert abs(c[0] - cr[0]) / cr[0] < 1e-5, (ref_name, c[0], cr[0])
        np.testing.assert_allclose(c, cr, rtol=chi2_rtol, err_msg=ref_name)
        np.testing.assert_allclose(g_p["poses"], poses, rtol=5e-3, atol=5e-4, err_msg=ref_name)
        np.testing.assert_allclose(g_p["landmarks"], lms, rtol=5e-3, atol=5e-4, err_msg=ref_name)
    assert st["dp_final"].shape == (graphs[gname][0].n_poses, 3)
    if case == "lm":
        assert st["accepted"].any()
    if case == "gn":
        # the gauge pose keeps its bits
        g = graphs[gname][0]
        fixed = int(g.fixed_pose_ix)
        np.testing.assert_array_equal(g_p["poses"][fixed], g.poses.numpy()[fixed])


@pytest.mark.parametrize("D", [2, 3, 4])
def test_ranks_bit_equal(runs, D):
    port = runs[0][D]
    for r in range(1, D):
        for (ga, sa), (gb, sb) in zip(port[0], port[r]):
            np.testing.assert_array_equal(ga["poses"], gb["poses"])
            np.testing.assert_array_equal(ga["landmarks"], gb["landmarks"])
            for k in sa:
                np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
