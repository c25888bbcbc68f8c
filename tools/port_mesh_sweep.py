"""Rank-count sweep of the edge-sharded packed Schur+PCG solve on the PyTorch
port (port of ``tools/mesh_scaling_bench.py``).

Each point runs the sharded packed solve (``parallel/sharded_packed.py``)
on D ranks of one ``torch.distributed`` group, spawned by
``parallel/mesh.spawn``: gloo ranks on the CPU, NCCL on the card.  It
reports what decides scaling on real hardware, as the JAX tool does:

- the slot work per rank, which falls as 1/D;
- the all-reduce bytes of one packed build and of one CG matvec, counted
  by ``utils/collectives.collective_bytes`` on the build and the
  build + matvec (the JAX tool's ``_hlo_collectives``), beside the
  analytic model (per matvec 4 (2 NL + 3 NP), per build 4 (9 NP + 4 NL +
  3 NP + 2 NL)) and beside the bytes the whole solve moved;
- the chi2 trace, against D = 1 in a sweep.

Ranks on one host share its cores, so the times are no speedup.  On the
card there is one H100 here, so only D = 1 runs there (NCCL).

    python tools/port_mesh_sweep.py [--device cpu]     # D = 1 2 4 on the CPU, 1 on the card
    python tools/port_mesh_sweep.py --devices 1 2 [--poses N] [--iters N] [--cg-iters N]

The records carry the JAX tool's keys; ``psum_mb_per_solve_hlo`` and the
``hlo_*`` keys hold the port's run-time counts under the JAX names.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---- the functions a rank runs (module level, so they pickle) ----


def flat_build(gs, cfg, mesh):
    """The edge-sharded flat normal-equation build: H, b and the stats."""
    from boslam_torch.solver.normal_eq import assemble_dense, chi2_stats

    H, b, terms = assemble_dense(gs, cfg, mesh=mesh)
    return H, b, chi2_stats(terms, cfg, mesh)


def packed_build(gs, pks, cfg, mesh):
    """One build of the sharded packed blocks."""
    from boslam_torch.solver import schur_packed

    return schur_packed.build_packed_blocks(gs, pks, cfg, cfg.damping, mesh=mesh)


def packed_build_plus_matvec(gs, pks, cfg, mesh):
    """One build and one S matvec at x = 1."""
    import torch

    from boslam_torch.solver import schur, schur_packed

    blocks, _ = packed_build(gs, pks, cfg, mesh)
    mask = schur._pose_mask(gs.n_poses, gs.fixed_pose_ix, gs.poses.dtype)
    x = torch.ones((gs.n_poses, 3), dtype=gs.poses.dtype, device=gs.device)
    return schur_packed.packed_s_matvec(blocks, pks, x, mask, mesh=mesh)


def collectives_job(g, cfg, mesh):
    """``collective_bytes`` of the flat build, the packed build and the
    packed build + matvec on this rank's shards of ``g``."""
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.parallel.sharded import shard_graph
    from boslam_torch.parallel.sharded_packed import shard_packed
    from boslam_torch.utils.collectives import collective_bytes

    out = {"flat_build": collective_bytes(flat_build, shard_graph(g, mesh), cfg, mesh=mesh)}
    pk, _ = pack_edges(g)
    gs, pks = shard_packed(g, pk, mesh)
    out["packed_build"] = collective_bytes(packed_build, gs, pks, cfg, mesh=mesh)
    out["packed_build_plus_matvec"] = collective_bytes(packed_build_plus_matvec, gs, pks, cfg,
                                                       mesh=mesh)
    return out


def point_job(g, cfg, mesh):
    """One sweep point on this rank: a first solve, the best of 3, the
    collective bytes of a build and a matvec, the bytes of the whole
    solve."""
    from boslam_torch.bench import sync
    from boslam_torch.device import host_sync
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.parallel.sharded_packed import (make_sharded_packed_solve, pad_packed,
                                                      shard_packed)
    from boslam_torch.utils.collectives import collective_bytes

    pk, _ = pack_edges(g)
    gs, pks = shard_packed(g, pk, mesh)
    solve = make_sharded_packed_solve(mesh, cfg)
    t0 = time.perf_counter()
    solve(gs, pks)
    sync(mesh.device)
    first_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        mesh.reset_counts()
        sync(mesh.device)
        t0 = time.perf_counter()
        _, stats = solve(gs, pks)
        sync(mesh.device)
        best = min(best, time.perf_counter() - t0)
    solve_bytes = dict(mesh.bytes)
    with host_sync(mesh.device):
        chi2 = stats["chi2_robust"].double().cpu()
        cg_total = int(stats["cg_iters"].sum())
    b = collective_bytes(packed_build, gs, pks, cfg, mesh=mesh)
    bm = collective_bytes(packed_build_plus_matvec, gs, pks, cfg, mesh=mesh)
    padded = pad_packed(pk, mesh.size)
    return {
        "best_s": best, "first_s": first_s, "chi2": chi2, "cg_total": cg_total,
        "build_bytes": b["all-reduce"], "matvec_bytes": max(0, bm["all-reduce"] - b["all-reduce"]),
        "build_by_kind": b, "solve_bytes": solve_bytes,
        "slots": padded.K * g.n_poses + padded.K2 * g.n_landmarks,
        "shard_slots": pks.p_lm.numel() + pks.l_pose.numel(),
    }


# ---- the sweep ----


def make_problem(n_poses, iters, cg_iters):
    """(graph on the CPU, config): the JAX tool's problem."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(n_poses, max(8, n_poses * 2 // 5), seed=0,
                              loop_closures=n_poses // 100)
    graph, _ = build_graph(ig, init="triangulate", device="cpu")
    cfg = SolverConfig(linear_solver="schur_cg", iters=iters, cg_iters=cg_iters, cg_tol=1e-5,
                       preconditioner="btridiag", cg_warm_start=True)
    return graph, cfg


def run_point(n_devices, graph, cfg, device="cpu") -> dict:
    """The sweep record of one rank count (rank 0's numbers; every rank
    must end with the same chi2 trace)."""
    from boslam_torch.parallel.mesh import spawn

    with tempfile.TemporaryDirectory() as d:
        res = spawn([(point_job, (graph, cfg), {})], n_devices, os.path.join(d, "store"), device)
    r = res[0][0]
    for other in res[1:]:
        if not (other[0]["chi2"] == r["chi2"]).all():
            raise AssertionError(f"D={n_devices}: the ranks' chi2 traces differ")
    NP_, NL, iters, cg_total = graph.n_poses, graph.n_landmarks, cfg.iters, r["cg_total"]
    # per CG matvec z [NL,2] + y_partial [NP,3]; per build Hpp [NP,9] +
    # Hll [NL,4] + bp [NP,3] + bl [NL,2] (+ stats); f32
    psum_model = 4 * (cg_total * (2 * NL + 3 * NP_) + iters * (9 * NP_ + 4 * NL + 3 * NP_ + 2 * NL))
    psum_count = iters * r["build_bytes"] + cg_total * r["matvec_bytes"]
    return {
        "devices": n_devices,
        "backend": "nccl" if device == "cuda" else "gloo",
        "n_poses": NP_,
        "n_landmarks": NL,
        "slots_per_device": r["slots"] // n_devices,
        "slots_on_rank0": r["shard_slots"],
        "iters": iters,
        "cg_iters_total": cg_total,
        "time_per_outer_ms": round(r["best_s"] / iters * 1e3, 2),
        "compile_s": round(r["first_s"], 1),
        "psum_mb_per_solve_model": round(psum_model / 1e6, 2),
        "psum_mb_per_solve_hlo": round(psum_count / 1e6, 2),
        "psum_mb_per_solve_measured": round(r["solve_bytes"]["psum"] / 1e6, 2),
        "hlo_build_allreduce_bytes": r["build_bytes"],
        "hlo_matvec_allreduce_bytes": r["matvec_bytes"],
        "model_build_allreduce_bytes": 4 * (9 * NP_ + 4 * NL + 3 * NP_ + 2 * NL),
        "model_matvec_allreduce_bytes": 4 * (2 * NL + 3 * NP_),
        "chi2_initial": float(r["chi2"][0]),
        "chi2_final": float(r["chi2"][-1]),
        "chi2_trace": [float(c) for c in r["chi2"]],
    }


def sweep(device_counts, graph, cfg, device="cpu") -> list:
    results = []
    for d in device_counts:
        log(f"--- {d} rank(s) ---")
        rec = run_point(d, graph, cfg, device)
        log(json.dumps(rec))
        results.append(rec)
    base = results[0]
    for r in results:
        r["chi2_rel_vs_1dev"] = abs(r["chi2_final"] - base["chi2_final"]) / abs(base["chi2_final"])
        r["chi2_trace_max_rel_vs_1dev"] = max(
            abs(a - b) / abs(b) for a, b in zip(r["chi2_trace"], base["chi2_trace"]))
        r["work_fraction"] = r["slots_per_device"] / base["slots_per_device"]
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="rank counts (default: 1 2 4 on the CPU, 1 on the card)")
    ap.add_argument("--poses", type=int, default=5000)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cg-iters", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from boslam_torch.device import resolve_device

    resolve_device(args.device)
    counts = args.devices or ([1] if args.device == "cuda" else [1, 2, 4])
    if args.device == "cuda" and max(counts) > torch.cuda.device_count():
        ap.error(f"{max(counts)} ranks need as many cards; {torch.cuda.device_count()} here")
    graph, cfg = make_problem(args.poses, args.iters, args.cg_iters)
    results = sweep(counts, graph, cfg, args.device)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
