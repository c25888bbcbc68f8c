"""The edge-sharded packed layout (``parallel/sharded_packed.py``) on
spawned gloo ranks, against the JAX package's ``sharded_packed_solve`` on a
virtual CPU mesh of as many devices and against the port on one device.

Cases (the JAX suite's, test_sharded_packed.py, on the reference
dimensions): GN and LM under block-Jacobi on ``generate_sequence(301, 141,
seed=3)`` and its 4-closure twin; btridiag with warm start, two_level,
bband, a forced hot-landmark split (cap 4) and closures; uneven padding on
a graph whose slot counts no mesh size here divides.  GN and LM at D = 2
and 4, each other case at one of them (the JAX side compiles each anew).

Tolerances (the JAX suite's): chi2 at iteration 0 rel 1e-5, the trace
rtol 2e-3, poses 5e-4 of their scale; LM's accept decisions equal and its
damping rtol 1e-6.  The port on one device takes the chain-shift odometry
path, the ranks the general one, so it is held at the same bounds.  Every
rank ends with the same bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.parallel.mesh import make_mesh as make_mesh_jax
from boslam.parallel.sharded_packed import sharded_packed_solve as sharded_packed_solve_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.graph.packed import pack_edges
from boslam_torch.parallel.mesh import spawn
from boslam_torch.parallel.sharded_packed import pad_packed, sharded_packed_solve
from boslam_torch.solver import optimizer as opt

BASE = dict(linear_solver="schur_cg", iters=10, cg_iters=100, cg_tol=1e-6,
            preconditioner="block_jacobi")
GRAPHS = {
    "chain": dict(n_poses=301, n_landmarks=141, seed=3),
    "closures": dict(n_poses=301, n_landmarks=141, seed=3, loop_closures=4),
    "uneven": dict(n_poses=90, n_landmarks=45, seed=3, obs_per_pose=5),
}
CASES = {
    "gn": ("chain", {}),
    "lm": ("closures", dict(optimizer="lm", iters=8)),
    "btridiag-warm": ("chain", dict(iters=5, preconditioner="btridiag", cg_warm_start=True)),
    "two_level": ("chain", dict(iters=5, preconditioner="two_level")),
    "bband": ("chain", dict(iters=5, preconditioner="bband")),
    "lm_split": ("closures", dict(iters=6, lm_split=4)),
    "closures": ("closures", dict(iters=6)),
    "uneven": ("uneven", dict(iters=5)),
}
AT = {2: ("gn", "lm", "btridiag-warm", "two_level"),
      4: ("gn", "lm", "bband", "lm_split", "closures", "uneven")}
TRACE_RTOL = 2e-3


def _graph(name):
    kw = dict(GRAPHS[name])
    ig, _ = generate_sequence(kw.pop("n_poses"), kw.pop("n_landmarks"), **kw)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    graphs = {k: _graph(k) for k in GRAPHS}
    tmp = tmp_path_factory.mktemp("sharded_packed")
    port, jax_d = {}, {}
    for D, names in AT.items():
        jobs = [(sharded_packed_solve,
                 (graphs[CASES[k][0]][0], SolverConfig(**{**BASE, **CASES[k][1]})), {})
                for k in names]
        port[D] = spawn(jobs, D, str(tmp / f"store{D}"))
        for name in names:
            gname, kw = CASES[name]
            gd, sd = sharded_packed_solve_jax(graphs[gname][1], SolverConfigJax(**{**BASE, **kw}),
                                              make_mesh_jax(D))
            jax_d[name, D] = (np.asarray(gd.poses), {k: np.asarray(v) for k, v in sd.items()})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {}
        for name, (gname, kw) in CASES.items():
            gs, st = opt.solve_packed(graphs[gname][0], SolverConfig(**{**BASE, **kw}))
            single[name] = (gs.poses.numpy(), {k: v.numpy() for k, v in st.items()})
    finally:
        torch.set_num_threads(n)
    return graphs, port, jax_d, single


def _rel(c, ref):
    c, ref = np.asarray(c, np.float64), np.asarray(ref, np.float64)
    return np.abs(c - ref) / np.abs(ref)


@pytest.mark.parametrize("case, D", [(k, D) for D, names in AT.items() for k in names])
def test_matches_jax_and_one_device(runs, case, D):
    _, port, jax_d, single = runs
    g_p, st = port[D][0][AT[D].index(case)]
    c = st["chi2_robust"]
    for ref_name, (poses, ref) in (("jax", jax_d[case, D]), ("one device", single[case])):
        cr = ref["chi2_robust"]
        assert _rel(c[0], cr[0]) < 1e-5, (ref_name, c[0], cr[0])
        assert _rel(c, cr).max() < TRACE_RTOL, (ref_name, _rel(c, cr))
        p64 = np.asarray(poses, np.float64)
        err = np.max(np.abs(g_p["poses"] - p64)) / max(1.0, float(np.abs(p64).max()))
        assert err < 5e-4, (ref_name, err)
        if case == "lm":
            np.testing.assert_array_equal(st["accepted"], ref["accepted"])
            np.testing.assert_allclose(st["damping"], ref["damping"], rtol=1e-6)
        assert st["spd_ok"].all() or case == "lm"
    if case == "lm":
        assert int(st["accepted"].sum()) >= 5


@pytest.mark.parametrize("D", list(AT))
def test_ranks_bit_equal(runs, D):
    port = runs[1][D]
    for r in range(1, D):
        for (ga, sa), (gb, sb) in zip(port[0], port[r]):
            np.testing.assert_array_equal(ga["poses"], gb["poses"])
            np.testing.assert_array_equal(ga["landmarks"], gb["landmarks"])
            for k in sa:
                np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_pad_packed_noop(runs):
    """Padding slots carry zero information, and the uneven graph's grids
    really are padded at D = 4; the lm_split case really splits."""
    graphs = runs[0]
    g, _ = graphs["uneven"]
    pk, _ = pack_edges(g)
    assert pk.K % 4 != 0 or pk.K2 % 4 != 0
    pk4 = pad_packed(pk, 4)
    assert pk4.K % 4 == 0 and pk4.K2 % 4 == 0
    assert int((pk4.p_omega > 0).sum()) == int((pk4.l_omega > 0).sum()) == g.n_bearing
    pks, _ = pack_edges(graphs["closures"][0], split_lm=4)
    assert pks.l_virt is not None and pks.l_pose.shape[0] > graphs["closures"][0].n_landmarks
