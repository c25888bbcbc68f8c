"""The fused block-Jacobi CG body (``boslam_torch/ops/pcg_body.py``) against
its plain twin and against the body it fuses, on the card.

On the benchmark's three 10k graphs, ``generate_sequence(n, 2n/5, seed)`` as
a walk (split landmark rows, plain gathers), as a corridor (relabeled,
both grids through their windows) and as the walk with M3500's density of
loop closures (``LOOPS_PER_POSE``: the odometry a chain prefix and
loop-closure rows), at the first GN outer's packed system under
block-Jacobi (``cg_tol`` 1e-5, cap 100):

  one body      the kernel against the twin from the start state and from
                the twin's state after ``--advance`` bodies, with a fixed
                pose mid-chain in the second: the largest gap of A p, x, r,
                z, p and x_best, each over the largest entry of the twin's,
                and of the three scalars, and the gaps of both to the twin
                run in float64 ("f64": the largest, and for a vector the
                99.9th percentile; ``one_body_misses`` holds them to
                bounds); a frozen state kept to the bit
  replay        one captured kernel body replayed twice from one state:
                the same bits
  pcg           ``pcg`` to the cap with the fused body (captured) against
                ``pcg`` with its own body (eager): the iterate's gap over
                its largest entry, both relative residuals, both counts
  time          one body alone, ms by CUDA events over CUDA-graph replays
                of 20 bodies (median of 5 rounds): the kernel and the twin

One JSON line per graph on stdout.  ``--device cpu`` runs what a CPU can
(the twin stands for the kernel there, nothing is timed) at small sizes.

    python tools/port_pcg_body_probe.py [--poses 10000] [--seed 0] [--advance 10]
        [--graphs walk corridor loops] [--device cuda]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# loop closures per pose of Olson's M3500 (3,500 poses, 5,453 edges): 1,954
# edges beside the chain; 5,583 on 10k poses
LOOPS_PER_POSE = 1954 / 3500
GRAPHS = ("walk", "corridor", "loops")


def graph_kw(kind: str, n_poses: int) -> dict:
    """``generate_sequence``'s keywords of ``kind`` beside its sizes."""
    if kind == "corridor":
        return {"turn_every": 10**9}
    if kind == "loops":
        return {"loop_closures": round(LOOPS_PER_POSE * n_poses)}
    return {}


def packed_system(kind: str, n_poses: int, seed: int, device: str):
    """(blocks, pk, mask, precond, rhs, graph) of the first outer's packed
    system of ``kind`` (one of ``GRAPHS``), taken from ``solve_packed`` as
    it runs."""
    from unittest import mock

    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.solver import schur_packed as sp
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(n_poses, n_poses * 2 // 5, seed=seed, **graph_kw(kind, n_poses))
    g = build_graph(ig, init="triangulate", device=device)[0]
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=1,
                       cg_iters=100, cg_tol=1e-5,
                       gather="windowed" if kind == "corridor" else "auto")
    seen = {}
    pcg = sp.pcg

    def spy_pcg(matvec, rhs, precond, *a, **k):
        seen.setdefault("rhs", rhs)
        return pcg(matvec, rhs, precond, *a, **k)

    def spy_build(*a, **k):
        out = build(*a, **k)
        seen.setdefault("blocks", out[0])
        return out

    def spy_pre(blocks, pk, cfg_, mask, mesh=None):
        out = pre(blocks, pk, cfg_, mask, mesh)
        seen.setdefault("system", (pk, mask, out))
        return out

    build, pre = sp.build_packed_blocks, sp._packed_preconditioner
    with mock.patch.object(sp, "pcg", spy_pcg), \
            mock.patch.object(sp, "build_packed_blocks", spy_build), \
            mock.patch.object(sp, "_packed_preconditioner", spy_pre):
        solve_packed(g, cfg)
    pk, mask, precond = seen["system"]
    return seen["blocks"], pk, mask, precond, seen["rhs"], g


def start_state(precond, rhs):
    """``pcg``'s state before its first body, without a warm start."""
    import torch

    from boslam_torch.solver.schur import CGState

    z = torch.einsum("pij,pj->pi", precond, rhs)
    rz, rr = torch.sum(rhs * z), torch.sum(rhs * rhs)
    i0 = torch.zeros((), dtype=torch.int32, device=rhs.device)
    return CGState(torch.zeros_like(rhs), rhs, z, z.clone(), rz, rr, i0, i0.clone(),
                   torch.zeros_like(rhs), rr.clone(), torch.ones((), dtype=torch.bool,
                                                                 device=rhs.device))


def _wide(blocks, pk):
    """The blocks and the packing in float64 on the CPU, gathering plainly
    (every valid slot lies in its window, the padding's blocks are 0)."""
    import dataclasses as dc

    from boslam_torch.solver.schur_packed import PackedBlocks

    return PackedBlocks(*(_f64(t) for t in blocks)), dc.replace(
        pk, p_plan=None, l_plan=None,
        **{f: _f64(getattr(pk, f)) for f in ("p_lm", "l_pose", "l_virt")
           if getattr(pk, f) is not None})


def bind(blocks, pk, mask, precond, rhs, max_iters=100, tol=1e-5, restarts=0):
    """The fused body of this system as ``pcg`` binds it: (the kernel's
    ``PCGSystem``, None on the CPU; the plain twin,
    ``schur_packed.plain_cg_body``; the twin in float64 on the CPU)."""
    import torch

    from boslam_torch.ops.pcg_body import PCGSystem
    from boslam_torch.solver.schur_packed import plain_cg_body

    b2 = torch.clamp(torch.sum(rhs * rhs), min=torch.finfo(rhs.dtype).tiny)
    loop = (tol * tol, restarts, max_iters)
    twin = plain_cg_body(blocks, pk, mask, precond, b2, *loop)
    wide = plain_cg_body(*_wide(blocks, pk), _f64(mask), _f64(precond), _f64(b2), *loop)
    system = (PCGSystem(blocks.Hpp_diag, precond, blocks.Ho_sd, mask, blocks.Hll_inv, blocks.Bp,
                        pk.p_lm, blocks.Bl, pk.l_pose, pk.l_virt, pk.p_plan, pk.l_plan, b2,
                        *loop, loops=pk.loops) if rhs.is_cuda else None)
    return system, twin, wide


def gap(a, b, q: float = 1.0) -> float:
    """The ``q``-quantile of |a - b| over max |b| (``q`` 1: the largest; 0
    where both are 0)."""
    import torch

    d = (a.double() - b.double()).abs().flatten()
    d = float(d.max() if q >= 1.0 else torch.quantile(d, q))
    m = float(b.double().abs().max())
    return d / m if m else d


# One body of the kernel against the twin in float64, per vector of the
# state and A p, each gap over the vector's largest entry: the bulk (the
# 99.9th percentile of the entries' gaps) no further than BULK times the
# f32 twin's, the farthest entry no further than WORST times the twin's
# farthest, and either allowed FLOOR ulps of float32 however close the twin
# came; per scalar (r^T z, r^T r, the best r^T r) within SCALAR of the
# float64 value.  Both sum in f32 in other orders, so the twin's gap is the
# system's rounding (A p cancels: S is far smaller than Hpp and
# B Hll^-1 B^T, and its worst entries, where both paths err most, part by
# a factor of 4 on the corridor, PERF.md section 6), but where the twin
# lands within an ulp or two by luck, a factor of it is no bound: the
# kernel's x read 3 ulps against the twin's 0.25 on a walk.  FLOOR is
# 64 ulps (7.6e-6); a wrong index or a dropped term puts whole terms,
# 1e-3 to 1e-1 of the largest entry, into the gap
BULK, WORST, FLOOR, SCALAR = 2.0, 10.0, 64 * 2.0**-23, 1e-3


def one_body_misses(rec: dict) -> list:
    """The tensors of ``one_body``'s record outside the bounds above."""
    out = []
    for name, g in rec["f64"].items():
        if len(g) == 4:
            kernel, twin, kernel_bulk, twin_bulk = g
            if kernel_bulk > max(BULK * twin_bulk, FLOOR) or kernel > max(WORST * twin, FLOOR):
                out.append(name)
        elif g[0] > SCALAR:
            out.append(name)
    return out


def _f64(t):
    """``t`` on the CPU, widened to float64 if it is a float."""
    return t.cpu().double() if t.is_floating_point() else t.cpu()


def one_body(bound, s, blocks, pk, mask) -> dict:
    """The kernel's body against the twin's from ``s`` (the twin stands for
    the kernel on the CPU), each tensor's gap (A p's from the kernel's
    workspace against ``packed_s_matvec``), and both against the twin in
    float64 ("f64": [kernel, twin] per tensor)."""
    from boslam_torch.ops.pcg_body import pcg_body
    from boslam_torch.solver.schur import CGState
    from boslam_torch.solver.schur_packed import packed_s_matvec

    system, twin, wide = bound
    want = twin(s)
    got = want if system is None else pcg_body(system, s)
    names = CGState._fields
    floats = [i for i, n in enumerate(names) if n not in ("nbrk", "k", "active")]
    out = {names[i]: gap(got[i], want[i]) for i in floats}
    out["same_counts"] = all(bool((got[i] == want[i]).all()) for i in (6, 7, 10))
    ref = [t.to(s.x.device) for t in wide(CGState(*(_f64(t) for t in s)))]

    def to_f64(a, b, r):  # [kernel, twin] (and their bulks, for a vector)
        pair = [gap(a, r), gap(b, r)]
        return pair + [gap(a, r, 0.999), gap(b, r, 0.999)] if r.dim() else pair

    out["f64"] = {names[i]: to_f64(got[i], want[i], ref[i]) for i in floats}
    if system is not None:
        ap64 = packed_s_matvec(*_wide(blocks, pk), _f64(s.p), _f64(mask)).to(s.p.device)
        ap, ap_twin = system.kernel._keep["ap"], packed_s_matvec(blocks, pk, s.p, mask)
        out["Ap"] = gap(ap, ap_twin)
        out["f64"]["Ap"] = to_f64(ap, ap_twin, ap64)
    return out


def run_graph(kind: str, n_poses: int, seed: int, device: str, advance: int = 10) -> dict:
    import torch

    from boslam_torch.ops.pcg_body import pcg_body
    from boslam_torch.solver import schur
    from boslam_torch.solver import schur_packed as sp

    blocks, pk, mask, precond, rhs, g = packed_system(kind, n_poses, seed, device)
    rec = dict(graph=kind, poses=g.n_poses, landmarks=g.n_landmarks, bearing=g.n_bearing,
               slots=[pk.K, pk.K2], landmark_rows=pk.l_pose.shape[0],
               split_rows=pk.l_virt is not None, chain=pk.chain_len,
               loop_closures=g.n_odometry - pk.chain_len,
               plans=[None if p is None else [p.window, p.tile_rows] for p in (pk.p_plan,
                                                                                pk.l_plan)])
    cuda = rhs.is_cuda
    s0 = start_state(precond, rhs)
    rec["start"] = one_body(bind(blocks, pk, mask, precond, rhs), s0, blocks, pk, mask)
    # a fixed pose mid-chain, the twin's state after ``advance`` bodies
    mid = torch.ones_like(mask)
    mid[g.n_poses // 2] = 0.0
    rhs_m = rhs * mid
    bound = bind(blocks, pk, mid, precond, rhs_m)
    system_m, twin_m = bound[:2]
    s = start_state(precond, rhs_m)
    for _ in range(advance):
        s = twin_m(s)
    rec["mid_chain"] = one_body(bound, s, blocks, pk, mid)
    frozen = s._replace(active=torch.zeros_like(s.active))
    out = schur.CGState(*(t.clone() for t in frozen))
    kept = twin_m(frozen, out) if system_m is None else pcg_body(system_m, frozen, out)
    rec["frozen_kept"] = all(torch.equal(a, b) for a, b in zip(kept, frozen))
    if cuda:
        state = schur.CGState(*(t.clone() for t in s))
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin()
            pcg_body(system_m, state, state)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        outs = []
        for _ in range(2):
            for t, t0 in zip(state, s):
                t.copy_(t0)
            graph.replay()
            outs.append([t.clone() for t in state])
        rec["replays_bitwise"] = all(torch.equal(a, b) for a, b in zip(*outs))
    # pcg to the cap: fused (captured on the card; the twin on the CPU)
    # against its own body, eager
    mv = lambda x: sp.packed_s_matvec(blocks, pk, x, mask)  # noqa: E731
    fused_body = sp.fused_cg_body if cuda else sp.plain_cg_body
    a = schur.pcg(mv, rhs, precond, 100, 1e-5, _eager=True)
    b = schur.pcg(mv, rhs, precond, 100, 1e-5,
                  make_body=functools.partial(fused_body, blocks, pk, mask, precond))
    rec["pcg"] = dict(x=gap(b[0], a[0]), rel_res2=[float(a[2]), float(b[2])],
                      iters=[int(a[1]), int(b[1])], breakdown=[bool(a[3]), bool(b[3])],
                      fused_bodies=b[4]["fused_bodies"], graph_bodies=b[4]["graph_bodies"])
    if cuda:
        from boslam_torch.utils.profiling import time_ms

        st_k = schur.CGState(*(t.clone() for t in s))
        st_p = schur.CGState(*(t.clone() for t in s))
        launches = pcg_body.launches
        ms = time_ms({"kernel": lambda: pcg_body(system_m, st_k, st_k),
                      "twin": lambda: twin_m(st_p, st_p)}, graph=True)
        pcg_body.launches = launches
        rec["ms_alone"] = ms
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--advance", type=int, default=10)
    ap.add_argument("--graphs", nargs="+", choices=GRAPHS, default=["walk", "corridor"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import logging

    import boslam_torch  # noqa: F401  (full-f32 matmul precision)

    logging.getLogger("boslam_torch.init").setLevel(logging.ERROR)
    for kind in args.graphs:
        print(json.dumps(run_graph(kind, args.poses, args.seed, args.device, args.advance)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
