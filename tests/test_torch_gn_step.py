"""The whole-GN-step path (boslam_torch/ops/gn_step.py) on the CPU, where
it runs its plain PyTorch version, against the JAX package: its Pallas
whole-step kernel in interpret mode, its unfused GN step, and its
converged solve, on the same graphs (numpy arrays through
``FactorGraph.from_numpy``).

Tolerances: chi2 statistics of the shared pre-step state at rtol 1e-5,
atol 1e-6 and clamp counts exact (test_pallas_gn_step.py:75-80).  The
converged chi2 at rel 1e-5 (test_pallas_gn_step.py:93).  The updated
state is held against the same step solved in f64 (the port's dense path
on f64 tensors): its distance from it may be at most twice that of the
JAX package's own f32 steps (its whole-step kernel and unfused step, or
its Schur and dense steps).  At these condition numbers (~1e7) every f32
solver lands 3e-4 to 2e-3 from the f64 step, each in its own direction,
so the distance between two f32 solvers says little: the port's whole
step lies 6.2e-4 from the f64 step where the JAX kernel lies 1.1e-3 and
its unfused step 1.7e-3 (60 poses), yet 1.7e-3 from the JAX kernel.
"""

import dataclasses
import functools
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.ops import pallas_gn_step as pgs
from boslam.solver import optimizer as opt_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.ops import gn_step as gs
from boslam_torch.solver import optimizer as opt

STATS = ("chi2_bearing", "chi2_odometry", "chi2_robust")
COUNTS = ("n_bearing_clamped", "n_odometry_clamped")


@pytest.fixture(autouse=True)
def _few_threads():
    # six test workers share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the plain whole steps taken (the CPU side of the path)."""
    calls = []
    real = gs.fused_gn_step_plain

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(gs, "fused_gn_step_plain", spy)
    return calls


def _arrays(gj):
    return {k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()}


def _graphs(n_poses, n_landmarks, seed, loop_closures=0, bearing_every=None):
    """Both packages' graphs; ``bearing_every`` keeps only the bearing edges
    of every k-th pose."""
    ig, _ = generate_sequence(n_poses, n_landmarks, seed=seed, loop_closures=loop_closures)
    gj, _ = build_graph_jax(ig, init="triangulate")
    arrays = _arrays(gj)
    if bearing_every is not None:
        keep = arrays["b_pose"] % bearing_every == 0
        for k in ("b_pose", "b_lm", "b_meas", "b_omega"):
            arrays[k] = arrays[k][keep]
        gj = type(gj)(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    return FactorGraph.from_numpy(arrays, device="cpu"), gj


def _check_stats(st, stj):
    for k in STATS:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(stj[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in COUNTS:
        assert st[k].item() == np.asarray(stj[k]).item(), k


def _f64(g):
    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).double() for f in dataclasses.fields(g)
        if getattr(g, f.name).is_floating_point()})


def _check_near_f64(port, jax_steps, g, cfg, label):
    """max|port - x64| <= 2 max_j max|jax_j - x64| for poses and landmarks,
    x64 the same step solved in f64."""
    x64, _ = opt.gn_step(_f64(g), cfg.replace(linear_solver="dense", fused_step="off"))
    for k in ("poses", "landmarks"):
        ref = getattr(x64, k).numpy()
        step = np.abs(ref - getattr(g, k).numpy()).max()
        err = np.abs(getattr(port, k).numpy() - ref).max()
        errs_j = [np.abs(np.asarray(getattr(j, k)) - ref).max() for j in jax_steps]
        err_j = max(errs_j)
        print(f"{label} {k}: step {step:.3f}, port vs f64 {err:.4e}, jax vs f64 "
              + ", ".join(f"{e:.4e}" for e in errs_j) + f", ratio {err / err_j:.3f}")
        assert 0.0 < err_j < 1e-2 * max(step, 1.0), (k, err_j, step)
        assert err <= 2.0 * err_j, (k, err, err_j)


@pytest.mark.parametrize("n_poses, n_landmarks, loop_closures", [(60, 30, 0), (120, 50, 3)])
def test_step_vs_pallas_interpret(n_poses, n_landmarks, loop_closures, plain_calls):
    """One whole step against the JAX whole-step kernel in interpret mode:
    chain odometry, and three loop closures (general coupling); the gauge
    pose does not move."""
    g, gj = _graphs(n_poses, n_landmarks, 3, loop_closures)
    cfg_j = SolverConfigJax(linear_solver="schur", fused_step="off")
    gjf, sjf = pgs.fused_gn_step(gj, cfg_j, interpret=True)
    gju, _ = jax.jit(lambda x: opt_jax.gn_step(x, cfg_j))(gj)
    g1, s1 = gs.fused_gn_step(g, SolverConfig(linear_solver="schur"), gs.tile_band(g))
    assert len(plain_calls) == 1
    _check_stats(s1, sjf)
    assert bool(s1["spd_ok"]) and bool(s1["accepted"])
    _check_near_f64(g1, (gjf, gju), g, SolverConfig(),
                    f"interpret {n_poses}/{n_landmarks}/{loop_closures}")
    fix = int(g.fixed_pose_ix)
    np.testing.assert_allclose(g1.poses[fix].numpy(), g.poses[fix].numpy(), atol=1e-7)


def _vs_unfused(g, gj, **kw):
    """One port whole step against the JAX unfused Schur step; the state
    against the f64 step, beside the JAX Schur and dense steps."""
    cfg = SolverConfig(linear_solver="schur", fused_step="force", **kw)
    g1, s1 = opt.gn_step(g, cfg, gs.tile_band(g))
    cfg_j = SolverConfigJax(linear_solver="schur", fused_step="off", **kw)
    gjs, sjs = jax.jit(lambda x: opt_jax.gn_step(x, cfg_j))(gj)
    gjd, _ = jax.jit(lambda x: opt_jax.gn_step(x, cfg_j.replace(linear_solver="dense")))(gj)
    _check_stats(s1, sjs)
    assert bool(s1["spd_ok"]) and bool(np.asarray(sjs["spd_ok"]))
    _check_near_f64(g1, (gjs, gjd), g, cfg, f"unfused {kw}")
    return g1, s1


@pytest.mark.parametrize("loop_closures", [0, 4])
def test_step_vs_unfused_reference_size(loop_closures, plain_calls):
    """At the reference size (301 poses, 141 landmarks, seed 0), with chain
    odometry and with four loop closures."""
    g, gj = _graphs(301, 141, 0, loop_closures)
    _vs_unfused(g, gj)
    assert len(plain_calls) == 1


@pytest.mark.parametrize("kw", [
    dict(robust="none"),
    dict(robust="huber", kernel_threshold=1e-3),
    dict(reference_kernel_quirk=False, kernel_threshold=1e-3),
], ids=["none", "huber", "textbook-threshold"])
def test_robust_variants(kw, plain_calls):
    """Each robust variant against the unfused step.  A threshold of 1e-3
    clamps bearing and odometry edges alike, so both weights are live; the
    odometry b-side takes J^T Omega (w_b e), as the unfused step does."""
    g, gj = _graphs(301, 141, 0)
    _, s1 = _vs_unfused(g, gj, **kw)
    if "kernel_threshold" in kw:
        assert s1["n_bearing_clamped"].item() > 0 and s1["n_odometry_clamped"].item() > 0
    assert len(plain_calls) == 1


def test_converged_50_iterations(plain_calls):
    """50 whole steps (fused_step="force") on generate_sequence(301, 141,
    seed=3) land on the JAX package's unfused optimum at rel 1e-5."""
    g, gj = _graphs(301, 141, 3)
    _, st = opt.solve(g, SolverConfig(linear_solver="schur", fused_step="force", iters=50))
    _, stj = opt_jax.solve(gj, SolverConfigJax(linear_solver="schur", fused_step="off", iters=50))
    assert len(plain_calls) == 50
    c, cj = st["chi2_robust"].numpy(), np.asarray(stj["chi2_robust"])
    np.testing.assert_allclose(c[0], cj[0], rtol=1e-5)
    assert abs(c[-1] - cj[-1]) / cj[-1] < 1e-5
    assert st["spd_ok"].all() and st["chi2_robust"].shape == (50,)
    assert st["n_bearing_clamped"].dtype == torch.int64


def test_routing_on_cpu(plain_calls):
    """On CPU tensors "auto" takes the unfused path and "force" the plain
    whole step; LM never takes it; the kernel is never launched."""
    g, _ = _graphs(60, 30, 3)
    launches = gs.fused_gn_step.launches
    cfg = SolverConfig(linear_solver="schur")
    g_auto, s_auto = opt.gn_step(g, cfg)
    g_off, s_off = opt.gn_step(g, cfg.replace(fused_step="off"))
    assert not plain_calls
    assert torch.equal(g_auto.poses, g_off.poses) and torch.equal(g_auto.landmarks, g_off.landmarks)
    g_force, _ = opt.gn_step(g, cfg.replace(fused_step="force"))
    g_direct, _ = gs.fused_gn_step(g, cfg)
    assert len(plain_calls) == 2
    assert torch.equal(g_force.poses, g_direct.poses)
    opt.solve(g, cfg.replace(fused_step="force", optimizer="lm", iters=2))
    opt.solve(g, cfg.replace(fused_step="force", linear_solver="dense", iters=1))
    assert len(plain_calls) == 2
    opt.solve(g, cfg.replace(fused_step="force", iters=3))
    assert len(plain_calls) == 5
    assert gs.fused_gn_step.launches == launches


@pytest.mark.parametrize("sizes", [
    (60, 30, 420, 59), (301, 141, 2079, 300), (301, 141, 2079, 304), (512, 277, 3584, 511),
    (513, 200, 3591, 512), (100, 200, 700, 99), (300, 20, 100, 299), (300, 20, 100, 1300),
    (128, 128, 10_000, 127), (100_000, 40_000, 700_000, 100_000),
])
def test_fits_gate_matches_jax(sizes):
    """The port's gate admits exactly the graphs the JAX gate admits:
    (512, 277) at the cap is in, (513, 200) is out."""
    assert gs.fused_gn_fits(*sizes) == pgs.fused_gn_fits(*sizes)


@pytest.mark.parametrize("fused_step", ["auto", "force"])
def test_force_passes_the_gate_first(fused_step):
    """A graph outside fused_gn_fits takes the unfused path under "force"
    too, as in the JAX package."""
    big = types.SimpleNamespace(n_poses=513, n_landmarks=200, n_bearing=3591, n_odometry=512,
                                poses=torch.zeros(513, 3))
    assert not gs.fused_gn_fits(513, 200, 3591, 512)
    cfg = SolverConfig(linear_solver="schur", fused_step=fused_step)
    assert not opt._fused_step_applicable(big, cfg)
    small = types.SimpleNamespace(n_poses=301, n_landmarks=141, n_bearing=2079, n_odometry=300,
                                  poses=torch.zeros(301, 3))
    assert opt._fused_step_applicable(small, cfg) == (fused_step == "force")


CHUNK_SEEDS = range(8)


@functools.cache
def _chunk_case(seed):
    """One plain whole step on the seed's graph with the bearing edges of
    every tenth pose, beside the JAX Schur and dense steps; returns the
    graph's sizes, the plain steps taken, and for poses and landmarks the
    step's size and the distances of the plain and the JAX steps from the
    same step solved in f64."""
    g, gj = _graphs(301, 141, seed, bearing_every=10)
    cfg = SolverConfig(linear_solver="schur", fused_step="force")
    with mock.patch.object(gs, "fused_gn_step_plain", wraps=gs.fused_gn_step_plain) as plain:
        g1, s1 = opt.gn_step(g, cfg, gs.tile_band(g))
    cfg_j = SolverConfigJax(linear_solver="schur", fused_step="off")
    gjs, sjs = jax.jit(lambda x: opt_jax.gn_step(x, cfg_j))(gj)
    gjd, _ = jax.jit(lambda x: opt_jax.gn_step(x, cfg_j.replace(linear_solver="dense")))(gj)
    _check_stats(s1, sjs)
    assert bool(s1["spd_ok"]) and bool(np.asarray(sjs["spd_ok"]))
    x64, _ = opt.gn_step(_f64(g), cfg.replace(linear_solver="dense", fused_step="off"))
    dist = {}
    for k in ("poses", "landmarks"):
        ref = getattr(x64, k).numpy()
        dist[k] = (np.abs(ref - getattr(g, k).numpy()).max(),
                   np.abs(getattr(g1, k).numpy() - ref).max(),
                   max(np.abs(np.asarray(getattr(j, k)) - ref).max() for j in (gjs, gjd)))
    sizes = (g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry)
    return sizes, plain.call_count, dist


@pytest.mark.parametrize("seed", CHUNK_SEEDS)
def test_more_odometry_than_bearing_chunk(seed):
    """300 odometry edges (384 padded) and the bearing edges of every tenth
    pose (one 256-row chunk): the JAX gate admits the graph and the TPU
    kernel cannot run it (its odometry block does not fit the chunk).  The
    port has no chunk and runs it: its statistics match the JAX unfused
    step's, and the JAX steps lie a small part of the step from the f64
    step.  How far the plain step lies is held over all seeds at once in
    test_more_odometry_than_bearing_chunk_accuracy."""
    (n_poses, n_landmarks, n_bearing, n_odometry), calls, dist = _chunk_case(seed)
    assert 128 < n_bearing <= 256 and n_odometry == 300
    assert gs.fused_gn_fits(n_poses, n_landmarks, n_bearing, n_odometry)
    assert calls == 1
    for k, (step, err, err_j) in dist.items():
        assert 0.0 < err_j < 1e-2 * max(step, 1.0), (k, err_j, step)
        assert np.isfinite(err), k


def test_more_odometry_than_bearing_chunk_accuracy():
    """On this family the f32 steps scatter widely about the f64 step, each
    in its own direction: over seeds 0-7 the ratio of the plain step's
    distance to the farthest JAX step's runs from 0.2 to 2.4, and every
    summation order tried exceeds 2 on some seed (PERF.md).  One seed is
    one draw of that ratio, so the plain step is held on the geometric mean
    over the seeds: no farther from the f64 step than the farthest JAX
    step, for poses and for landmarks."""
    for k in ("poses", "landmarks"):
        ratios = np.array([_chunk_case(s)[2][k][1] / _chunk_case(s)[2][k][2]
                           for s in CHUNK_SEEDS])
        print(k, "plain / farthest JAX:", np.array2string(ratios, precision=3))
        assert np.exp(np.log(ratios).mean()) <= 1.0, (k, ratios)


def test_repeated_and_reversed_edges(plain_calls):
    """Edges that share an owner: ten bearing edges repeated on the same
    (pose, landmark) pairs, an odometry edge 6 -> 5 beside the chain's
    5 -> 6, and an odometry edge from pose 7 to itself, against the
    unfused step, which sums them by index."""
    g, gj = _graphs(120, 50, 3, loop_closures=3)
    arrays = _arrays(gj)
    dx, dy, dth = arrays["o_meas"][5]
    c, s = np.cos(dth), np.sin(dth)
    odd = {
        "b_pose": arrays["b_pose"][:10], "b_lm": arrays["b_lm"][:10],
        "b_meas": arrays["b_meas"][:10] + 0.01, "b_omega": arrays["b_omega"][:10],
        "o_src": np.array([6, 7]), "o_dst": np.array([5, 7]),
        "o_meas": np.array([[-c * dx - s * dy, s * dx - c * dy, -dth], [0.1, 0.0, 0.05]]),
        "o_omega": arrays["o_omega"][:2],
    }
    assert arrays["o_src"][5] == 5 and arrays["o_dst"][5] == 6
    for k, v in odd.items():
        arrays[k] = np.concatenate([arrays[k], v.astype(arrays[k].dtype)])
    gj = type(gj)(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    g = FactorGraph.from_numpy(arrays, device="cpu")
    _vs_unfused(g, gj)
    assert len(plain_calls) == 1


def test_zero_damping_is_finite(plain_calls):
    """At damping 0 the padding landmark lanes are never inverted, so the
    step is finite (the TPU kernel gives NaN there and then a no-op) and
    agrees with the unfused step.  Undamped, the f32 steps of most graphs
    scatter widely around the f64 step (at 301 poses by the step's own
    size); on this one every solver lands within 2e-3 of it."""
    g, gj = _graphs(60, 30, 0)
    g1, s1 = _vs_unfused(g, gj, damping=0.0)
    assert torch.isfinite(g1.poses).all() and torch.isfinite(g1.landmarks).all()
    assert s1["delta_norm"].item() > 0 and s1["damping"].item() == 0.0
    assert len(plain_calls) == 1


def test_prep_lists():
    """The ownership lists: every contribution once, runs contiguous."""
    g, _ = _graphs(120, 50, 3, loop_closures=3)
    p = gs.prep_static(g)
    NB, NO = g.n_bearing, g.n_odometry
    assert sorted(p.pose_order.tolist()) == list(range(NB + 2 * NO))
    keys = torch.cat([g.b_pose, g.o_src, g.o_dst])[p.pose_order.long()]
    off = p.pose_off.long()
    for q in range(g.n_poses):
        assert (keys[off[q]:off[q + 1]] == q).all()
    assert off[-1] == NB + 2 * NO
    assert (g.b_lm[p.lm_order.long()].diff() >= 0).all() and p.lm_off[-1] == NB
    assert torch.equal(p.u_key.long(), (g.b_pose * g.n_landmarks + g.b_lm)[p.u_order.long()])
    assert (p.c_key.diff() >= 0).all()
    assert p.mask.shape == (p.Np,) and p.mask.sum().item() == 3 * (g.n_poses - 1)


def test_cli_schur_on_cpu(tmp_path, plain_calls):
    """``solve --linear-solver schur --device cpu`` takes the unfused path
    ("auto" on the CPU); the whole step's plain version is reached through
    the API with ``fused_step="force"``, on the same file."""
    from boslam_torch.cli import main
    from boslam_torch.graph.build import build_graph
    from boslam_torch.io.g2o import parse_g2o

    path = str(tmp_path / "s.g2o")
    assert main(["synth", "--poses", "40", "--landmarks", "20", "--out", path]) == 0
    args = ["solve", path, "--linear-solver", "schur", "--iters", "2", "--device", "cpu"]
    assert main(args) == 0
    assert not plain_calls
    g, _ = build_graph(parse_g2o(path), init="auto", device="cpu")
    _, st = opt.solve(g, SolverConfig(linear_solver="schur", fused_step="force", iters=2))
    assert len(plain_calls) == 2 and bool(st["spd_ok"].all())
