"""Scaling benchmark of the PyTorch port, BASELINE.json configs 1-5 (port of
``tools/scaling_bench.py``).  One JSON record per config on stdout, with
the JAX tool's keys; progress on stderr.

    python tools/port_scaling_bench.py [--configs 1 2 3 4 5] [--poses-override N]
        [--lm-split auto|0|N] [--coupling-dtype float32|bfloat16] [--device cuda|cpu]
        [--data-dir DIR]

  1  mini dataset GN solve: skipped, with the reason, when its file is absent
  2  full dataset: triangulation + GN 50, ATE against the ground truth
  3  LM + Huber on the full dataset
  4  10k-pose synthetic, packed Schur+PCG
  5  100k-pose synthetic, packed Schur+PCG

Configs 1-3 read the C++ reference's datasets (``mini_*.g2o`` and
``slam2D_bearing_only_*.g2o``, initial guess and ground truth) from
``--data-dir``, by default ``boslam_torch.bench.REFERENCE_DATA``, the
directory the JAX tool reads; for 2-3 they use ``generate_sequence(301,
141, seed=3)`` with its ground truth where those files are absent;
``graph`` says which.  They time the configured solve (best of 3 after a first run; the
JAX tool times ``gn_step`` steps even for config 3's LM, the port the LM
solve it reports).

Configs 4-5: ``generate_sequence(n, 2n/5, seed=0)``, packed GN for 5
outers with ``cg_iters`` 8, ``cg_tol`` 1e-4, ``preconditioner="auto"``
and warm start, plain gathers (``gather="auto"``), best of 2 after a first
run, and the tolerance-controlled companion run (``cg_iters`` 64,
``cg_tol`` 1e-2).  ``roofline`` is ``packed_outer_model`` with the mean CG
iterations of the best run against the card's ``chip_spec()`` (null on
the CPU); ``memory`` is ``torch.cuda.max_memory_allocated`` over the
config in place of XLA's memory analysis (empty on the CPU).  A config
that raises is recorded with ``failed``; the tool then exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUTERS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _mem_reset(device):
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def device_memory(device) -> dict:
    """Peak and limit of the card's allocator since the last reset; empty
    on the CPU."""
    import torch

    if device.type != "cuda":
        return {}
    return {"peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory)}


def _reference_inputs(which, data_dir):
    """(initial guess, ground truth, name of the graph) of configs 1-3, or
    None for config 1 without its file."""
    from boslam_torch.bench import SYNTH
    from boslam_torch.io.g2o import parse_g2o
    from boslam_torch.synth import generate_sequence

    stem = "mini" if which == 1 else "slam2D_bearing_only"
    ig_path = os.path.join(data_dir, f"{stem}_initial_guess.g2o")
    if os.path.exists(ig_path):
        return (parse_g2o(ig_path), parse_g2o(ig_path.replace("initial_guess", "ground_truth")),
                ig_path)
    if which == 1:
        return None
    n_poses, n_landmarks, seed = SYNTH
    ig, gt = generate_sequence(n_poses, n_landmarks, seed=seed)
    return ig, gt, f"generate_sequence({n_poses}, {n_landmarks}, seed={seed})"


def config_1_2_3(which, device, data_dir):
    from boslam_torch.bench import best_of, sync
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.metrics import ate_metrics, match_gt_poses
    from boslam_torch.solver.optimizer import solve

    inputs = _reference_inputs(which, data_dir)
    if inputs is None:
        mini = os.path.join(data_dir, "mini_initial_guess.g2o")
        return {"config": 1, "name": "mini_gn",
                "skipped": f"the mini dataset ({mini}) is absent; it has no synthetic stand-in"}
    ig, gt, source = inputs
    cfg, name = {1: (SolverConfig(iters=50), "mini_gn"),
                 2: (SolverConfig(iters=50), "full_gn"),
                 3: (SolverConfig(iters=50, optimizer="lm", robust="huber"),
                     "full_lm_huber")}[which]
    graph, meta = build_graph(ig, init="triangulate", device=device)
    final, stats = solve(graph, cfg)
    sync(device)
    best = min(best_of(lambda: solve(graph, cfg), device, repeats=3, stale_after=0, cap=3))
    chi2 = stats["chi2_robust"].cpu().numpy()
    m = ate_metrics(final.poses.cpu().numpy(), match_gt_poses(meta, gt))
    return {
        "config": which,
        "name": name,
        "graph": source,
        "n_poses": graph.n_poses,
        "iters": cfg.iters,
        "iters_per_s": round(cfg.iters / best, 2),
        "chi2_initial": float(chi2[0]),
        "chi2_final": float(chi2[-1]),
        "ate_rmse": round(m["ate_rmse"], 4),
        "ate_rmse_aligned": round(m["ate_rmse_aligned"], 4),
    }


def timed_packed(graph, pk, cfg, repeats=2):
    """A first run, then the best of ``repeats`` runs of ``cfg.iters``
    packed outers.  Returns (best seconds, final graph, CG iterations per
    outer of the best run), the counts read after the timed window."""
    from boslam_torch.bench import sync
    from boslam_torch.device import host_sync
    from boslam_torch.solver.optimizer import packed_solve_loop

    packed_solve_loop(graph, pk, cfg)
    best, final, cg = float("inf"), None, None
    for _ in range(repeats):
        sync(graph.device)
        t0 = time.perf_counter()
        g, st = packed_solve_loop(graph, pk, cfg)
        sync(graph.device)
        dt = time.perf_counter() - t0
        if dt < best:
            best, final, cg = dt, g, st["cg_iters"]
    with host_sync(graph.device):
        return best, final, [int(c) for c in cg.cpu()]


def config_4_5(which, device, poses_override=None, lm_split="auto", coupling_dtype="float32",
               spec=None):
    import numpy as np

    from boslam_torch.bench import final_chi2
    from boslam_torch.config import SolverConfig
    from boslam_torch.device import host_sync
    from boslam_torch.graph.build import build_graph
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.synth import generate_sequence
    from boslam_torch.utils.roofline import packed_outer_model, roofline_report

    n = poses_override or (10_000 if which == 4 else 100_000)
    log(f"generating {n}-pose synthetic sequence...")
    ig, _ = generate_sequence(n, max(8, n * 2 // 5), seed=0)
    _mem_reset(device)
    graph, _ = build_graph(ig, init="triangulate", device=device)
    # cg cap 8: the JAX records' best chi2 per matvec at 10k and 100k;
    # "auto": btridiag up to 32768 poses, block-Jacobi above
    cfg = SolverConfig(linear_solver="schur_cg", iters=OUTERS, cg_iters=8, cg_tol=1e-4,
                       preconditioner="auto", cg_warm_start=True, coupling_dtype=coupling_dtype,
                       lm_split=lm_split)
    with host_sync(device):
        pk, pmeta = pack_edges(graph, split_lm=lm_split)
    log(f"packed: K={pk.K} K2={pk.K2} rows={pk.l_pose.shape[0]} "
        f"fill={pmeta.fill_pose:.2f}/{pmeta.fill_lm:.2f} split_cap={pmeta.lm_split_cap}")
    best, final, cg = timed_packed(graph, pk, cfg)
    cg_mean = float(np.mean(cg))
    flops, bytes_ = packed_outer_model(
        graph.n_poses, graph.n_landmarks, pk.K, pk.K2, graph.n_odometry, cg_mean,
        lm_rows=pk.l_pose.shape[0], coupling_bytes=2.0 if coupling_dtype == "bfloat16" else 4.0)
    rec = {
        "config": which,
        "name": f"synthetic_{n}_packed_schur_cg",
        "n_poses": graph.n_poses,
        "n_landmarks": graph.n_landmarks,
        "n_edges": graph.n_bearing + graph.n_odometry,
        "iters_per_s": round(OUTERS / best, 3),
        "poses_optimized_per_s": round(graph.n_poses * OUTERS / best, 0),
        "cg_iters_mean": cg_mean,
        "roofline": None if spec is None else roofline_report(flops, bytes_, best / OUTERS, spec),
        "chi2_initial": final_chi2(graph, cfg),
        "chi2_after": final_chi2(final, cfg),
    }

    # tolerance-controlled companion run: a fixed inexact-Newton forcing
    # tolerance (eta 1e-2, generous cap), so poses optimized per second
    # compare at equal per-step solve quality
    tcfg = cfg.replace(cg_iters=64, cg_tol=1e-2)
    t_best, t_final, t_cg = timed_packed(graph, pk, tcfg)
    rec["tol_controlled"] = {
        "cg_tol": tcfg.cg_tol,
        "cg_cap": tcfg.cg_iters,
        "iters_per_s": round(OUTERS / t_best, 3),
        "poses_optimized_per_s": round(graph.n_poses * OUTERS / t_best, 0),
        "cg_iters_mean": float(np.mean(t_cg)),
        "chi2_after": final_chi2(t_final, tcfg),
    }
    rec["memory"] = device_memory(device)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", type=int, nargs="+", choices=[1, 2, 3, 4, 5], default=[1, 2, 3, 4])
    ap.add_argument("--poses-override", type=int, default=None)

    def lm_split_arg(v):
        if v == "auto":
            return v
        try:
            return int(v)
        except ValueError:
            ap.error(f"--lm-split: expected 'auto' or an int, got {v!r}")

    ap.add_argument("--lm-split", default="auto", type=lm_split_arg,
                    help="landmark-grid slot cap ('auto' | 0 = off | int)")
    ap.add_argument("--coupling-dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--data-dir", default=None,
                    help="directory of the reference datasets of configs 1-3 "
                         "(default: boslam_torch.bench.REFERENCE_DATA)")
    args = ap.parse_args(argv)

    import torch

    import boslam_torch  # noqa: F401  (full-f32 matmul precision)
    from boslam_torch.bench import REFERENCE_DATA
    from boslam_torch.device import resolve_device
    from boslam_torch.utils.roofline import chip_spec

    dev = resolve_device(args.device)
    spec = chip_spec() if dev.type == "cuda" else None
    log(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")
    failed = 0
    for c in args.configs:
        t0 = time.time()
        try:
            if c <= 3:
                rec = config_1_2_3(c, dev, args.data_dir or REFERENCE_DATA)
            else:
                rec = config_4_5(c, dev, args.poses_override, args.lm_split, args.coupling_dtype,
                                 spec)
        except Exception as exc:  # noqa: BLE001 -- the scale boundary is a record, not a crash
            log(f"config {c} failed: {exc!r}")
            rec = {"config": c, "poses_override": args.poses_override,
                   "failed": repr(exc)[:400], "memory": device_memory(dev)}
            failed += 1
        rec["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
