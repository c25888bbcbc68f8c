"""The packed path on a walk that closes loops, on the CPU: the odometry a
chain prefix and loop-closure edges past it, at the density of Olson's
M3500 (1,954 loop closures on 3,500 poses: 335 on 600).

The packing lists the loop closures per pose (``graph/packed.LoopRows``),
each edge twice in a fixed order; the fused body's rule admits such a
system; the fused body's plain twin (``schur_packed.plain_cg_body``) is
``pcg``'s own body over ``packed_s_matvec`` to the bit; and a packed solve
with CG run to convergence takes the float64 reference's exact GN steps
(``benchmark/reference/slam.py``).  The card's tests of the kernel's loop
rows are in ``tests/test_torch_cuda.py``."""

import dataclasses
import functools
import logging

import numpy as np
import pytest
import torch

from benchmark.reference import slam
from boslam_torch.config import SolverConfig
from boslam_torch.graph.build import build_graph
from boslam_torch.graph.packed import loop_rows, pack_edges
from boslam_torch.solver import schur
from boslam_torch.solver import schur_packed as sp
from boslam_torch.solver.optimizer import solve_packed
from boslam_torch.synth import generate_sequence
from boslam_torch.utils import roofline

logging.getLogger("boslam_torch").setLevel(logging.ERROR)

POSES, LANDMARKS, LOOPS = 600, 240, 335  # M3500's 0.558 loop closures a pose

# the benchmark's solver (benchmark/configs/walk_10k_loops.json with the
# traffic's block-Jacobi), CG run to convergence in place of the cap of 100
CFG = SolverConfig(optimizer="gn", iters=5, damping=0.01, robust="threshold",
                   kernel_threshold=1.0, reference_kernel_quirk=True, linear_solver="schur_cg",
                   cg_iters=2000, cg_tol=1e-9, preconditioner="block_jacobi")

# Against the f64 reference's exact GN steps, CG converged (700-1,100
# iterations an outer): the f32 solve's robust chi2 at the five
# linearisation points stays within 2.8e-5 of the reference's and its
# final cost within 1.5e-5 (seeds 3, 0 and 1; f32 residuals, assembly and
# boxplus against f64).  The bounds leave about four and seven times
# that; the same solve capped at 100 CG iterations reads 5.7e-4 to 1.8e-3
# (chi2) and 1.2e-3 to 1.7e-3 (cost), and a matvec without the loop
# closures' couplings misses by more.
CHI2_STEP_RTOL = 1e-4
FINAL_COST_RTOL = 1e-4


@pytest.fixture(scope="module")
def looped():
    torch.manual_seed(0)
    parsed, _ = generate_sequence(POSES, LANDMARKS, seed=3, loop_closures=LOOPS)
    g = build_graph(parsed, init="triangulate", device="cpu")[0]
    return parsed, g


def _system(g):
    """(blocks, pk, mask, precond, rhs) of the packed system at the graph's
    state under block-Jacobi, with a random right-hand side."""
    pk, _ = pack_edges(g)
    blocks, _ = sp.build_packed_blocks(g, pk, CFG, CFG.damping)
    mask = sp._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    precond = sp._packed_preconditioner(blocks, pk, CFG, mask)
    rhs = torch.from_numpy(np.random.default_rng(5).standard_normal((g.n_poses, 3))
                           .astype(np.float32)) * mask
    return blocks, pk, mask, precond, rhs


def test_loop_rows_of_a_hand_worked_odometry():
    """Four chain edges, then 0 -> 3, 4 -> 1, a self edge 2 -> 2 and
    3 -> 0: each row's entries by edge index, the source's as e, the
    destination's as ~e, a self edge's source entry first."""
    src = np.array([0, 1, 2, 3, 0, 4, 2, 3])
    dst = np.array([1, 2, 3, 4, 3, 1, 2, 0])
    start, edge, nbr = loop_rows(src, dst, 4, 5)
    assert start.tolist() == [0, 2, 3, 5, 7, 8]
    assert edge.tolist() == [4, ~7, ~5, 6, ~6, ~4, 7, 5]
    assert nbr.tolist() == [3, 3, 4, 2, 2, 0, 0, 1]
    assert start.dtype == edge.dtype == nbr.dtype == np.int32


@pytest.mark.parametrize("bad", [(4, 5), (4, -1), (5, 1), (-2, 1)])
def test_loop_rows_refuse_a_pose_out_of_range(bad):
    """The fused body reads the list unchecked, so a loop closure whose
    source or destination is no pose is refused when the list is built;
    the chain prefix is not the list's and is not read."""
    src = np.array([0, 1, 2, 3, bad[0]])
    dst = np.array([1, 2, 3, 4, bad[1]])
    with pytest.raises(ValueError, match="loop closures join poses"):
        loop_rows(src, dst, 4, 5)
    assert loop_rows(src[:4], dst[:4], 4, 5)[0].tolist() == [0] * 6


def test_loop_rows_hold_each_loop_edge_twice_in_a_fixed_order(looped):
    _, g = looped
    pk, _ = pack_edges(g)
    NO, nc = g.n_odometry, pk.chain_len
    assert nc == POSES - 1 and NO == nc + LOOPS and not pk.odometry_is_chain
    start, edge, nbr = (t.numpy() for t in pk.loops)
    assert start[0] == 0 and start[-1] == len(edge) == 2 * LOOPS
    assert (np.diff(start) >= 0).all()
    src, dst = g.o_src.numpy(), g.o_dst.numpy()
    seen = {}
    for i in range(POSES):
        row = edge[start[i]:start[i + 1]]
        ids = np.where(row >= 0, row, ~row)
        assert (np.diff(ids) >= 0).all()  # by edge index
        for code, n in zip(row, nbr[start[i]:start[i + 1]]):
            e = int(code if code >= 0 else ~code)
            assert nc <= e < NO
            want = (src[e], dst[e]) if code >= 0 else (dst[e], src[e])
            assert (i, n) == want
            seen.setdefault(e, []).append(bool(code >= 0))
    assert sorted(seen) == list(range(nc, NO))
    assert all(sorted(v) == [False, True] for v in seen.values())
    again, _ = pack_edges(g)
    assert all(torch.equal(a, b) for a, b in zip(pk.loops, again.loops))
    chain = build_graph(generate_sequence(POSES, LANDMARKS, seed=3)[0], init="triangulate",
                        device="cpu")[0]
    assert pack_edges(chain)[0].loops is None


def test_fused_body_rule_admits_loop_closures(looped):
    """A chain prefix and listed loop closures take the fused body under
    block-Jacobi with f32 blocks; a mesh, btridiag, two_level, bband, bf16
    blocks, row chunks and loop closures the packing did not list keep
    ``pcg``'s body."""
    blocks, pk, _, _, _ = _system(looped[1])
    rule = sp.fused_body_rule
    assert pk.loops is not None and rule(blocks, pk, "block_jacobi", 0, None)
    assert not rule(blocks, pk, "block_jacobi", 0, object())
    for which in ("btridiag", "two_level", "bband"):
        assert not rule(blocks, pk, which, 0, None), which
    bf16 = blocks._replace(Bp=blocks.Bp.to(torch.bfloat16), Bl=blocks.Bl.to(torch.bfloat16))
    assert not rule(bf16, pk, "block_jacobi", 0, None)
    assert not rule(blocks, pk, "block_jacobi", 64, None)
    assert not rule(blocks, dataclasses.replace(pk, loops=None), "block_jacobi", 0, None)


def test_twin_is_pcgs_own_body_on_loop_closures(looped):
    """The fused body's plain twin against ``pcg``'s own body over
    ``packed_s_matvec``, on the loop-closing walk: one body from the start
    state, and ``pcg`` over one body and a short loop, give the same bits
    of every tensor, the same host counts and events, every body fused."""
    blocks, pk, mask, precond, rhs = _system(looped[1])
    mv = lambda x: sp.packed_s_matvec(blocks, pk, x, mask)  # noqa: E731
    b2 = torch.sum(rhs * rhs)
    cond = schur.cg_cond(b2, 1e-10, 3, 50)
    z = torch.einsum("pij,pj->pi", precond, rhs)
    s = schur.CGState(torch.zeros_like(rhs), rhs, z, z, torch.sum(rhs * z), b2,
                      torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32),
                      torch.zeros_like(rhs), b2, torch.ones((), dtype=torch.bool))
    own = schur.cg_step(s, mv(s.p), lambda r: torch.einsum("pij,pj->pi", precond, r),
                        lambda u, v: torch.sum(u * v), cond)
    twin = sp.plain_cg_body(blocks, pk, mask, precond, b2, 1e-10, 3, 50)
    for a, b in zip(own, twin(s)):
        assert torch.equal(a, b)
    make = functools.partial(sp.plain_cg_body, blocks, pk, mask, precond)
    for cap in (1, 25):
        want = schur.pcg(mv, rhs, precond, cap, 1e-12, restarts=3)
        got = schur.pcg(mv, rhs, precond, cap, 1e-12, restarts=3, make_body=make)
        for g_, w_ in zip(got[:4], want[:4]):
            assert torch.equal(g_, w_)
        info, info_w = dict(got[4]), dict(want[4])
        assert torch.equal(info.pop("events"), info_w.pop("events"))
        assert info == {**info_w, "fused_bodies": info_w["matvecs"]}


def test_loop_closures_reach_the_matvec(looped):
    """``packed_s_matvec`` against the float64 reference's S (the same
    assembly, the loop closures' couplings included) on one vector, and a
    matvec that drops the loop closures' couplings is far from it."""
    parsed, g = looped
    blocks, pk, mask, _, rhs = _system(g)
    pb = slam.problem(parsed, torch.float64)
    keep = mask.double().repeat_interleave(3).bool()
    want = _reference_s(pb, g) @ rhs.double().reshape(-1)[keep]
    got = sp.packed_s_matvec(blocks, pk, rhs, mask).double().reshape(-1)[keep]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    chain_only = blocks._replace(Ho_sd=torch.cat([blocks.Ho_sd[:pk.chain_len],
                                                  torch.zeros_like(blocks.Ho_sd[pk.chain_len:])]))
    dropped = sp.packed_s_matvec(chain_only, pk, rhs, mask).double().reshape(-1)[keep]
    assert float((dropped - want).abs().max()) > 1e-2 * scale


def _reference_s(pb, g):
    """The reference's damped reduced system S at the graph's state, the
    fixed pose's rows and columns left out (its ``gn_step`` assembly, in
    float64, as it reaches the Cholesky factorisation)."""
    captured = {}
    real = torch.linalg.cholesky_ex

    def spy(A, *a, **k):
        captured["S"] = A
        return real(A, *a, **k)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.linalg, "cholesky_ex", spy)
        slam.gn_step(pb, g.poses.double(), g.landmarks.double(), CFG.damping,
                     CFG.kernel_threshold)
    return captured["S"]


def test_solve_packed_with_loop_closures_takes_the_reference_steps(looped):
    parsed, g = looped
    out, stats = solve_packed(g, CFG)
    assert (stats["cg_iters"] < CFG.cg_iters).all()  # converged, not capped
    pb = slam.problem(parsed, torch.float64)
    kt = CFG.kernel_threshold
    sol = slam.solve(pb, CFG.iters, CFG.damping, kt)
    assert sol.failed_steps == 0
    chi2 = stats["chi2_robust"].double()
    ref = torch.tensor(sol.chi2, dtype=torch.float64)
    chi2_gap = float(((chi2 - ref).abs() / ref).max())
    cost = float(slam.robust_cost(pb, out.poses.double(), out.landmarks.double(), kt))
    cost_gap = abs(cost - sol.cost) / sol.cost
    assert chi2_gap <= CHI2_STEP_RTOL and cost_gap <= FINAL_COST_RTOL, (chi2_gap, cost_gap)
    assert sol.chi2[-1] < sol.chi2[0]


def test_pcg_body_work_counts_the_loop_closures():
    """Each loop closure adds its two 3x3 products (18 FMAs) and its block
    and two pose indices (44 bytes) to a body's work; a chain adds none."""
    base = roofline.pcg_body_work(10000, 3887, 6192, 7, 16, 9999, True)
    assert roofline.pcg_body_work(10000, 3887, 6192, 7, 16, 9999, True, 0) == base
    fmas, nbytes = roofline.pcg_body_work(10000, 3887, 6192, 7, 16, 9999, True, 5583)
    assert (fmas - base[0], nbytes - base[1]) == (18 * 5583, 44 * 5583)


@pytest.mark.parametrize("fused, loop_rows, want", [(500, True, 500), (500, False, 0),
                                                    (0, True, 0), (0, False, 0)])
def test_loop_fused_bodies_are_the_fused_bodies_with_loop_rows(fused, loop_rows, want):
    """``schur.cg_stats`` charges "cg.loop_fused_bodies" with the fused
    bodies of a system that carries loop-closure rows, and 0 otherwise,
    beside "cg.fused_bodies"; replays are bodies of ``pcg``'s count, so a
    replay charges both."""
    from boslam_torch.utils import spans

    info = {"matvecs": 500, "polls": 125, "graph_bodies": 499, "fused_bodies": fused,
            "events": torch.zeros((), dtype=torch.int32)}
    with spans.span("loop_fused_probe"):
        schur.cg_stats(torch.tensor(100), torch.tensor(1e-6), torch.tensor(False), info,
                       torch.device("cpu"), loop_rows=loop_rows)
    rec = [r for r in spans.records() if r.name == "loop_fused_probe"][-1]
    assert rec.counters["cg.fused_bodies"] == fused
    assert rec.counters["cg.loop_fused_bodies"] == want
