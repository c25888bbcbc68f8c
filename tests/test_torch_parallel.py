"""The port's multi-device layer on the CPU, without JAX: the collectives
of ``parallel/mesh.py`` on spawned gloo ranks, their byte counters against
the JAX module's formulas, per-rank shard bytes, resumed runs of the three
layouts against straight ones, a mirror of
``__graft_entry__.dryrun_multichip``, and the CLI under
``torch.distributed.run``.

This file imports nothing of JAX, so that a spawned rank, which imports
the module of the functions it runs, never does.  Each test spawns its
ranks once per world size and runs all its cases in that group.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.build import build_graph
from boslam_torch.parallel import mesh as M
from boslam_torch.parallel.pose_range import pose_range_solve, prepare_pose_range_host
from boslam_torch.parallel.sharded import sharded_solve
from boslam_torch.parallel.sharded_packed import sharded_packed_solve
from boslam_torch.synth import generate_sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph(n_poses, n_landmarks, seed=3, **kw):
    ig, _ = generate_sequence(n_poses, n_landmarks, seed=seed, **kw)
    return build_graph(ig, init="triangulate", device="cpu")


def _store(tmp_path, name):
    return str(tmp_path / f"store_{name}")


# ---- functions the spawned ranks run (module level, so they pickle) ----


def collectives_job(mesh):
    r, D = mesh.rank, mesh.size
    s = mesh.psum(torch.full((3, 2), float(r + 1)))
    a, i = mesh.psum(torch.full((2,), float(r)), torch.full((1,), r + 1, dtype=torch.int64))
    m = mesh.pmax(torch.tensor(r == D - 1))
    g = mesh.all_gather(torch.full((2, 3), float(r)), dim=1)
    sc = mesh.psum_scatter(torch.arange(4 * D, dtype=torch.float32).reshape(2 * D, 2) * (r + 1))
    return dict(s=s, a=a, i=i, m=m, g=g, sc=sc, bytes=dict(mesh.bytes), calls=dict(mesh.calls),
                rank=mesh.axis_index, size=mesh.axis_size, backend=mesh.backend,
                jax="jax" in sys.modules or "boslam" in sys.modules)


def failing_job(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    return mesh.rank


def matvec_bytes_job(g, mesh):
    """Collective bytes of one CG matvec of each layout, and the rank's
    range-shard bytes."""
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.parallel.pose_range import (
        _local_mask, _range_build, _range_matvec, prepare_pose_range)
    from boslam_torch.parallel.sharded import shard_graph
    from boslam_torch.parallel.sharded_packed import shard_packed
    from boslam_torch.solver import schur, schur_packed as sp

    cfg = SolverConfig(linear_solver="schur_cg")
    out = {}
    gs = shard_graph(g, mesh)
    blocks, _ = schur.build_blocks(gs, cfg, cfg.damping, mesh=mesh)
    mask = schur._pose_mask(g.n_poses, gs.fixed_pose_ix, torch.float32)
    x = torch.ones((g.n_poses, 3))
    mesh.reset_counts()
    schur.s_matvec(blocks, gs, x, mask, mesh)
    out["flat"] = (dict(mesh.bytes), dict(mesh.calls))

    pk, _ = pack_edges(g, split_lm=0)
    gs, pks = shard_packed(g, pk, mesh)
    pblocks, _ = sp.build_packed_blocks(gs, pks, cfg, cfg.damping, mesh=mesh)
    mesh.reset_counts()
    sp.packed_s_matvec(pblocks, pks, x, mask, mesh=mesh)
    out["packed"] = (dict(mesh.bytes), dict(mesh.calls))

    sh, meta = prepare_pose_range(g, mesh)
    rblocks, _ = _range_build(sh, cfg, cfg.damping, meta, mesh)
    rmask = _local_mask(sh, meta, mesh)
    mesh.reset_counts()
    _range_matvec(rblocks, sh, torch.ones_like(sh.poses), rmask, meta, mesh)
    out["range"] = (dict(mesh.bytes), dict(mesh.calls))
    out["range_meta"] = (meta.np_pad, meta.nl_pad, meta.has_suffix)
    out["range_shard_bytes"] = sh.nbytes()
    return out


def resume_job(g, meta, cfg, k, layout, path, mesh):
    """(straight stats and state, resumed ones): ``cfg.iters`` straight,
    against k, a checkpoint written and read back, and the rest."""
    from boslam_torch.io.checkpoint import load_npz, save_npz

    run = {"sharded": sharded_solve, "packed": sharded_packed_solve,
           "range": pose_range_solve}[layout]

    def solve(graph, c, **kw):
        if layout == "sharded":
            kw.pop("dp0", None)
            kw.pop("start_iter", None)
        return run(graph, c, mesh, **kw)

    path = path.replace(".npz", f".{mesh.rank}.npz")
    g_all, st_all = solve(g, cfg)
    g_k, st_k = solve(g, cfg.replace(iters=k))
    lam = float(st_k["lam_final"]) if cfg.optimizer == "lm" else None
    save_npz(path, g_k, meta, iteration=k, lm_lambda=lam, dp=st_k.get("dp_final"))
    g_r, _, it, lam0, dp0 = load_npz(path, g, meta)
    g_rest, st_rest = solve(g_r, cfg.replace(iters=cfg.iters - it), lam0=lam0, dp0=dp0,
                            start_iter=it)
    return (g_all.poses, g_all.landmarks, st_all["chi2_robust"]), (
        g_rest.poses, g_rest.landmarks,
        torch.cat([st_k["chi2_robust"], st_rest["chi2_robust"]]))


# ---- the inputs, and one spawn per world size for every case ----

FLAT_LM = SolverConfig(iters=6, optimizer="lm", linear_solver="schur")
GNC_LM = SolverConfig(iters=6, optimizer="lm", linear_solver="schur_cg", cg_warm_start=True,
                      gnc_kt0=50.0, gnc_anneal_iters=5, kernel_threshold=0.05, lm_split=0,
                      cg_tol=1e-7)
UNEVEN = SolverConfig(linear_solver="schur_cg", iters=5, cg_tol=1e-6,
                      preconditioner="block_jacobi")
DRY_FLAT = [SolverConfig(iters=1, linear_solver=ls, cg_iters=8) for ls in ("dense", "schur_cg")]
DRY_PACKED = [SolverConfig(iters=2, optimizer=o, linear_solver="schur_cg", cg_iters=8,
                           preconditioner="btridiag", cg_warm_start=True) for o in ("gn", "lm")]
DRY_RANGE = SolverConfig(iters=2, optimizer="lm", linear_solver="schur_cg", cg_iters=50,
                         cg_tol=1e-7, preconditioner="block_jacobi", lm_split=0,
                         cg_warm_start=True)
RESUMED = (("sharded", FLAT_LM), ("packed", GNC_LM), ("range", GNC_LM))


@pytest.fixture(scope="module")
def graphs():
    return {"closures301": _graph(301, 141, loop_closures=4),
            "closures120": _graph(120, 60, loop_closures=4),
            "uneven": _graph(90, 45, obs_per_pose=5),
            "dryrun": _graph(64, 40, seed=0, loop_closures=3)}


@pytest.fixture(scope="module")
def ranks(graphs, tmp_path_factory):
    """{case: [its result on each rank]}: every case of this file, one
    spawn per world size."""
    tmp = tmp_path_factory.mktemp("parallel")
    g120, meta120 = graphs["closures120"]
    g90, g64 = graphs["uneven"][0], graphs["dryrun"][0]
    cases = {
        1: {"collectives": (collectives_job, ())},
        2: {"bytes": (matvec_bytes_job, (graphs["closures301"][0],)),
            **{f"resume {layout}": (resume_job, (g120, meta120, cfg, 3, layout,
                                                 str(tmp / f"{layout}.npz")))
               for layout, cfg in RESUMED}},
        3: {"collectives": (collectives_job, ()),
            "uneven sharded": (sharded_solve, (g90, UNEVEN)),
            "uneven packed": (sharded_packed_solve, (g90, UNEVEN))},
        4: {**{f"dry flat {c.linear_solver}": (sharded_solve, (g64, c)) for c in DRY_FLAT},
            **{f"dry packed {c.optimizer}": (sharded_packed_solve, (g64, c)) for c in DRY_PACKED},
            "dry range": (pose_range_solve, (g64, DRY_RANGE))},
    }
    out = {}
    for D, named in cases.items():
        res = M.spawn([(fn, args, {}) for fn, args in named.values()], D, str(tmp / f"store{D}"))
        out.update({(name, D): [r[i] for r in res] for i, name in enumerate(named)})
    return out


# ---- tests ----


@pytest.mark.parametrize("D", [1, 3])
def test_collectives(ranks, D):
    """Each collective at world size 1 (still through the group) and 3,
    with the bytes of its result counted under its JAX name; the ranks
    import neither JAX nor the JAX package."""
    tot = D * (D + 1) / 2
    for r, res in enumerate(ranks["collectives", D]):
        assert (res["rank"], res["size"], res["backend"], res["jax"]) == (r, D, "gloo", False)
        np.testing.assert_array_equal(res["s"], np.full((3, 2), tot, np.float32))
        np.testing.assert_array_equal(res["a"], np.full(2, D * (D - 1) / 2, np.float32))
        assert res["i"].dtype == np.int64 and res["i"].tolist() == [tot]
        assert res["m"].item() is True
        np.testing.assert_array_equal(res["g"], np.repeat(np.arange(D, dtype=np.float32), 3)[None]
                                      .repeat(2, 0))
        full = np.arange(4 * D, dtype=np.float32).reshape(2 * D, 2) * tot
        np.testing.assert_array_equal(res["sc"], full[2 * r:2 * r + 2])
        # psum: one call per dtype (f32 24 + 8 bytes, i64 8 bytes)
        assert res["bytes"] == {"psum": 24 + 8 + 8, "pmax": 4, "all_gather": 24 * D,
                                "psum_scatter": 16}
        assert res["calls"] == {"psum": 3, "pmax": 1, "all_gather": 1, "psum_scatter": 1}


def test_a_failing_rank_raises(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        M.spawn([(failing_job, (), {})], 2, _store(tmp_path, "fail"))


def test_bytes_per_matvec_and_shard_bytes(graphs, ranks):
    """One CG matvec moves what the JAX modules' docstrings count: the
    flat layout psums (y_edge, z) and the back-coupling, the packed layout
    z and the y partials (two psums), the range layout all-gathers x and w
    (12 NPp + 8 NLp bytes) plus one psum_scatter with loop closures.
    Per-rank range-shard bytes at D = 8 are under half those at D = 2
    (``prepare_pose_range_host``'s arrays split over the ranks)."""
    g = graphs["closures301"][0]
    NP_, NL = g.n_poses, g.n_landmarks
    out = ranks["bytes", 2]
    for res in out:
        b, c = res["flat"]
        assert b["psum"] == 4 * (3 * NP_ + 2 * NL) + 4 * 3 * NP_ and c["psum"] == 2
        b, c = res["packed"]
        assert b["psum"] == 4 * (2 * NL + 3 * NP_) and c["psum"] == 2
        assert sum(v for k, v in b.items() if k != "psum") == 0
        b, c = res["range"]
        NPp, NLp, has_suffix = res["range_meta"]
        assert has_suffix
        assert b["all_gather"] == 12 * NPp + 8 * NLp and c["all_gather"] == 2
        assert b["psum_scatter"] == 12 * NPp // 2 and b["psum"] == 0
    assert out[0]["range_shard_bytes"] == out[1]["range_shard_bytes"]

    def per_rank(D):
        arrays, _ = prepare_pose_range_host(g, D)
        return sum(v.nbytes for k, v in arrays.items() if k != "fixed_pose_ix") / D

    assert abs(per_rank(2) - out[0]["range_shard_bytes"]) <= 8
    assert per_rank(8) < 0.5 * per_rank(2)


@pytest.mark.parametrize("layout", [layout for layout, _ in RESUMED])
def test_resume_matches_straight_run(ranks, layout):
    """A resumed run (k iterations, a checkpoint written and read back, the
    rest) equals the straight run to the bit on each layout at D = 2: the
    sharded LM restores its damping, the sharded packed and pose-range
    runs the damping, the warm-start delta and the GNC schedule's offset
    (the JAX CLI passes no lam0 to --sharded and no start_iter to the
    packed one, and its pose-range loop has no start_iter)."""
    for straight, resumed in ranks[f"resume {layout}", 2]:
        for a, b in zip(straight, resumed):
            np.testing.assert_array_equal(a, b)


def test_dryrun_multichip_mirror(graphs, ranks):
    """``__graft_entry__.dryrun_multichip`` at D = 4: finite chi2 and poses
    on the flat sharded dense and CG paths, the sharded packed GN and LM
    under btridiag with warm start, and pose-range LM against the
    replicated packed solve at rtol 5e-3; every rank the same bits."""
    from boslam_torch.solver.optimizer import solve_packed

    names = ([f"dry flat {c.linear_solver}" for c in DRY_FLAT]
             + [f"dry packed {c.optimizer}" for c in DRY_PACKED] + ["dry range"])
    for name in names:
        per_rank = ranks[name, 4]
        gr, st = per_rank[0]
        assert np.isfinite(st["chi2_robust"]).all() and np.isfinite(gr["poses"]).all(), name
        for gb, sb in per_rank[1:]:
            np.testing.assert_array_equal(gr["poses"], gb["poses"])
            np.testing.assert_array_equal(st["chi2_robust"], sb["chi2_robust"])
    ref = solve_packed(graphs["dryrun"][0], DRY_RANGE)[1]["chi2_robust"].numpy()
    np.testing.assert_allclose(ranks["dry range", 4][0][1]["chi2_robust"], ref, rtol=5e-3)


def _table(text):
    rows = [line.split() for line in text.splitlines() if line[:4].strip().isdigit()]
    return np.array([[float(v) for v in r[1:5]] for r in rows])


def test_cli_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m boslam_torch
    solve ... --pose-range --device cpu`` against the same command at world
    size 1: one table (rank 0 prints), chi2 at iteration 0 within 1e-6 and
    later within the pose-range bound (2e-3, tests/test_pose_range.py:57),
    one --out file, its poses within 5e-3 + 5e-4 of the other's."""
    from boslam_torch.cli import main
    from boslam_torch.io.g2o import parse_g2o

    ds = str(tmp_path / "s.g2o")
    assert main(["synth", "--poses", "60", "--landmarks", "30", "--seed", "2", "--out", ds]) == 0
    args = ["solve", ds, "--pose-range", "--linear-solver", "schur_cg", "--cg-tol", "1e-7",
            "--iters", "4", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    outs = {}
    for n, cmd in ((2, [sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "boslam_torch"]),
                   (1, [sys.executable, "-m", "boslam_torch"])):
        out = str(tmp_path / f"o{n}.g2o")
        p = subprocess.run(cmd + args + ["--out", out], cwd=REPO_ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == 0, p.stderr[-3000:]
        assert p.stdout.count("iter  chi2_robust") == 1, p.stdout
        assert f"{n} rank(s), gloo" in p.stderr
        outs[n] = (_table(p.stdout), parse_g2o(out))
    (t2, o2), (t1, o1) = outs[2], outs[1]
    assert t2.shape == t1.shape == (4, 4)
    np.testing.assert_allclose(t2[0], t1[0], rtol=1e-6)
    np.testing.assert_allclose(t2[:, 0], t1[:, 0], rtol=2e-3)
    np.testing.assert_allclose(o2.pose_xyt, o1.pose_xyt, rtol=5e-3, atol=5e-4)


def test_uneven_padding_at_three_ranks(graphs, ranks):
    """At D = 3, where neither the edge counts nor the slot counts divide:
    the padding carries zero information, and the flat and packed sharded
    solves start from the one-device chi2 (rel 1e-5) and follow its trace
    within 2e-3 (test_sharded_packed.py's bounds; the one-device runs at
    one thread, as a rank sums)."""
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.parallel.sharded import pad_edges
    from boslam_torch.parallel.sharded_packed import pad_packed
    from boslam_torch.solver.optimizer import solve, solve_packed

    g = graphs["uneven"][0]
    pk, _ = pack_edges(g)
    assert g.n_bearing % 3 and g.n_odometry % 3 and (pk.K % 3 or pk.K2 % 3)
    gp, pk3 = pad_edges(g, 3), pad_packed(pk, 3)
    assert gp.n_bearing % 3 == gp.n_odometry % 3 == pk3.K % 3 == pk3.K2 % 3 == 0
    assert float(gp.b_omega[g.n_bearing:].abs().sum()) == 0.0
    assert float(gp.o_omega[g.n_odometry:].abs().sum()) == 0.0
    assert int((pk3.p_omega > 0).sum()) == int((pk3.l_omega > 0).sum()) == g.n_bearing
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = [solve(g, UNEVEN)[1]["chi2_robust"].numpy(),
                solve_packed(g, UNEVEN)[1]["chi2_robust"].numpy()]
    finally:
        torch.set_num_threads(n)
    for name, ref in zip(("uneven sharded", "uneven packed"), refs):
        c = ranks[name, 3][0][1]["chi2_robust"].astype(np.float64)
        assert abs(c[0] - ref[0]) / ref[0] < 1e-5, name
        np.testing.assert_allclose(c, ref, rtol=2e-3, err_msg=name)
