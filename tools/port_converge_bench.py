"""Convergence to an optimum at survey scale, on the PyTorch port.

The port's counterpart of ``tools/converge_bench.py``: it runs packed LM
with tolerance-controlled CG (inexact Newton) in chunks until the chi2
trace plateaus, and records

  - the decimated chi2 trace and the plateau verdict,
  - the final aligned ATE and landmark errors against the synthetic ground
    truth,
  - the CG matvecs spent,
  - at <= --crosscheck-max poses, a tight-tolerance flat schur_cg LM solve
    to its own plateau and the packed solve started from its optimum.

Options as in the JAX tool: ``--pgo-init`` (``init/pose_graph.py``) before
the solve, a coarse ladder (``solver/coarse.py``) over segment sizes from
``--coarse-seg`` up, a coarse correction every ``--coarse-every`` outer
iterations, GNC (``--gnc-kt0``, ``--gnc-iters``), and the eta ladder
(cg_tol, /10, /100) on each plateau.

Usage (from the repository root; the card by default, ``--device cpu`` for
a small rehearsal):
  python tools/port_converge_bench.py [--poses 10000 100000] [--max-outer 200]
      [--cg-tol 1e-3] [--cg-iters 100] [--chunk 10] [--out runs.jsonl]

One JSON line per configuration on stdout (and appended to --out), with
the JAX tool's keys; ``compile_s`` is the first chunk's wall time (the
port builds its kernels before, on first use).
"""

import argparse
import json
import logging
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_packed_to_plateau(graph, cfg, max_outer, chunk, plateau_rel, coarse_every=0,
                          coarse_seg=64, coarse_rounds=3):
    """Chunked packed LM until the chi2 trace flattens.

    Returns (final graph, trace dict).  Plateau: relative chi2 improvement
    over the last ``chunk`` iterations below ``plateau_rel``; on a plateau
    the CG tolerance tightens 10x (twice), and "converged" means the plateau
    persists at the tightest rung.
    """
    import numpy as np
    import torch

    from boslam_torch.device import host_sync
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.solver.optimizer import packed_solve_loop

    dev, dtype = graph.device, graph.poses.dtype
    with host_sync(dev):
        pk, pmeta = pack_edges(graph, split_lm=cfg.lm_split)
    log(f"packed: K={pk.K} K2={pk.K2} rows={pk.l_pose.shape[0]} "
        f"fill={pmeta.fill_pose:.2f}/{pmeta.fill_lm:.2f}")
    tol_ladder = [cfg.cg_tol, cfg.cg_tol / 10.0, cfg.cg_tol / 100.0]
    rung = 0
    ccfg = cfg.replace(iters=chunk)

    def fresh():
        return (torch.full((), cfg.lm_lambda0, dtype=dtype, device=dev),
                torch.zeros((graph.n_poses, 3), dtype=dtype, device=dev))

    g = graph
    lam, dp = fresh()
    chi2s, cg_iters, accepted = [], [], []
    t0 = time.perf_counter()
    compile_wall = None
    converged = False
    n_outer = n_coarse = 0
    while n_outer < max_outer:
        if coarse_every and n_outer % coarse_every == 0:
            # the rigid-segment coarse correction moves the long-wavelength
            # bending modes that the damped f32 fine iteration cannot; kt
            # follows the GNC schedule
            from boslam_torch.solver.coarse import coarse_correct

            ktv = cfg.kt_at(n_outer)
            ktf = float(ktv) if ktv is not None else (
                cfg.kernel_threshold if cfg.robust != "none" else None)
            tc0 = time.perf_counter()
            g, cinfo = coarse_correct(g, seg=coarse_seg, rounds=coarse_rounds, kt=ktf)
            n_coarse += 1
            log(f"  coarse @{n_outer}: cost {cinfo['cost_trace'][0]:.1f} -> "
                f"{cinfo['cost_trace'][-1]:.1f} ({time.perf_counter() - tc0:.1f}s)")
            # the nonlinear jump invalidates the CG warm start and the LM trust
            lam, dp = fresh()
        g, stats = packed_solve_loop(g, pk, ccfg, lam0=lam, dp0=dp, start_iter=n_outer)
        with host_sync(dev):
            chunk_chi2 = stats["chi2_robust"].cpu().numpy().astype(np.float64)
            chunk_cg = stats["cg_iters"].cpu().numpy()
            chunk_acc = stats["accepted"].cpu().numpy()
        if compile_wall is None:
            compile_wall = time.perf_counter() - t0
        chi2s.extend(chunk_chi2.tolist())
        cg_iters.extend(chunk_cg.tolist())
        accepted.extend(chunk_acc.tolist())
        lam, dp = stats["lam_final"], stats["dp_final"]
        n_outer += chunk
        log(f"  outer {n_outer}: chi2 {chunk_chi2[-1]:.2f} (cg {int(chunk_cg.sum())} this chunk, "
            f"eta {ccfg.cg_tol:g})")
        # chi2_robust is recorded at the start of each iteration; while the
        # GNC threshold anneals the objective itself moves, so the plateau
        # test starts after the schedule
        if n_outer < cfg.gnc_anneal_iters:
            continue
        if len(chi2s) > chunk:
            prev, last = chi2s[-chunk - 1], chi2s[-1]
            if prev - last < plateau_rel * max(last, 1e-30):
                if rung + 1 < len(tol_ladder):
                    rung += 1
                    ccfg = ccfg.replace(cg_tol=tol_ladder[rung])
                    # a stalled lambda is pinned near lm_lambda_max: restart it
                    lam = fresh()[0]
                    log(f"  plateau -> tightening eta to {ccfg.cg_tol:g}")
                else:
                    converged = True
                    break
    _sync(dev)
    wall = time.perf_counter() - t0
    return g, {
        "n_coarse_corrections": n_coarse,
        "final_cg_tol": ccfg.cg_tol,
        "outer_iters": n_outer,
        "converged": converged,
        "chi2_initial": chi2s[0],
        "chi2_final": chi2s[-1],
        "chi2_trace": [round(c, 4) for c in _decimate(chi2s, 60)],
        "cg_matvecs_total": int(sum(cg_iters)),
        "cg_iters_mean": round(float(np.mean(cg_iters)), 2),
        "accept_rate": round(float(np.mean(accepted)), 3),
        "wall_s": round(wall, 1),
        "compile_s": round(compile_wall, 1),
        "iters_per_s_steady": round((n_outer - chunk) / max(wall - compile_wall, 1e-9), 3)
        if n_outer > chunk else None,
    }


def _decimate(xs, n):
    if len(xs) <= n:
        return xs
    import numpy as np

    ix = np.unique(np.linspace(0, len(xs) - 1, n).astype(int))
    return [xs[i] for i in ix]


def flat_crosscheck(graph, cfg, max_outer, plateau_rel, chunk=20):
    """Tight-tolerance flat schur_cg LM to its own plateau: an optimum from
    other assembly, matvec and preconditioner code than the packed path."""
    from boslam_torch.device import host_sync
    from boslam_torch.solver.optimizer import solve

    fcfg = cfg.replace(iters=chunk, linear_solver="schur_cg", cg_iters=300, cg_tol=1e-5,
                       cg_warm_start=False, preconditioner="auto", lm_split=0, gnc_kt0=0.0,
                       gnc_anneal_iters=0)
    g, lam = graph, None
    chi2s = []
    for _ in range(max_outer // chunk):
        g, stats = solve(g, fcfg, lam0=lam)
        with host_sync(graph.device):
            chi2s.extend(stats["chi2_robust"].cpu().double().numpy().tolist())
            lam = float(stats["lam_final"])  # the next trial's damping
        log(f"  flat outer {len(chi2s)}: chi2 {chi2s[-1]:.2f}")
        if len(chi2s) > chunk:
            prev, last = chi2s[-chunk - 1], chi2s[-1]
            if prev - last < plateau_rel * max(last, 1e-30):
                break
    return g, chi2s[-1]


def run_config(n_poses, args):
    import numpy as np

    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.metrics import (ate_metrics, match_gt_landmarks, match_gt_poses,
                                      rigid_align_2d)
    from boslam_torch.solver.normal_eq import chi2_stats, edge_terms
    from boslam_torch.synth import generate_sequence

    log(f"generating {n_poses}-pose synthetic (seed 0)...")
    ig, gt = generate_sequence(n_poses, max(8, n_poses * 2 // 5), seed=0,
                               loop_closures=args.loop_closures)
    graph, meta = build_graph(ig, init="triangulate", device=args.device)
    timings = {}
    if args.pgo_init:
        from boslam_torch.init.pose_graph import pgo_initialize

        t0 = time.time()
        graph = pgo_initialize(graph, landmark_rounds=args.pgo_lm_rounds)
        timings["pgo_init_s"] = time.time() - t0
        log(f"pgo init (+{args.pgo_lm_rounds} landmark rounds): {timings['pgo_init_s']:.1f}s")
    if args.coarse_every:
        # multi-scale ladder at the start: each rung a quarter of the last
        # segment scale, down to --coarse-seg
        from boslam_torch.solver.coarse import coarse_correct

        seg, ladder = args.coarse_seg, []
        while seg <= max(args.coarse_seg, graph.n_poses // 16):
            ladder.append(seg)
            seg *= 4
        t_ladder = time.time()
        for seg in reversed(ladder):
            t0 = time.time()
            graph, cinfo = coarse_correct(graph, seg=seg, rounds=args.coarse_rounds, kt=None)
            log(f"  coarse ladder seg={seg}: cost {cinfo['cost_trace'][0]:.1f} -> "
                f"{cinfo['cost_trace'][-1]:.1f} ({time.time() - t0:.0f}s)")
        timings["coarse_ladder_s"] = time.time() - t_ladder
    cfg = SolverConfig(
        optimizer="lm",
        linear_solver="schur_cg",
        kernel_threshold=args.kernel_threshold,
        cg_iters=args.cg_iters,
        cg_tol=args.cg_tol,
        preconditioner=args.preconditioner,
        cg_warm_start=True,
        lm_up=args.lm_up,
        lm_down=args.lm_down,
        gnc_kt0=args.gnc_kt0,
        gnc_anneal_iters=args.gnc_iters,
    )
    final, trace = run_packed_to_plateau(
        graph, cfg, args.max_outer, args.chunk, args.plateau_rel,
        coarse_every=args.coarse_every, coarse_seg=args.coarse_seg,
        coarse_rounds=args.coarse_rounds,
    )
    for k, v in timings.items():
        log(f"{k}: {v:.1f}")

    # landmark errors over landmarks seen at least twice (the others cannot
    # be located); the median as the robust location-quality number
    b_lm = graph.b_lm.cpu().numpy()
    obs_count = np.bincount(b_lm, minlength=graph.n_landmarks)
    gt_lms = match_gt_landmarks(meta, gt)
    gt_lms[obs_count < 2] = np.nan
    poses_f, lms_f = final.poses.cpu().numpy(), final.landmarks.cpu().numpy()
    gt_poses = match_gt_poses(meta, gt)
    m = ate_metrics(poses_f, gt_poses, lms_f, gt_lms)
    lm_err = np.linalg.norm(lms_f - gt_lms, axis=1)
    lm_err = lm_err[np.isfinite(lm_err)]
    m["lm_err_median"] = float(np.median(lm_err)) if lm_err.size else None
    R_, t_ = rigid_align_2d(poses_f[:, :2].astype(np.float64), gt_poses[:, :2].astype(np.float64))
    lma = np.linalg.norm(lms_f.astype(np.float64) @ R_.T + t_ - gt_lms, axis=1)
    lma = lma[np.isfinite(lma)]
    m["lm_err_median_aligned"] = float(np.median(lma)) if lma.size else None
    rec = {
        "config": "converge",
        "name": f"synthetic_{n_poses}_packed_lm_to_plateau"
        + (f"_lc{args.loop_closures}" if args.loop_closures else "")
        + ("_pgo" if args.pgo_init else "")
        + (f"_coarse{args.coarse_every}s{args.coarse_seg}" if args.coarse_every else "")
        + (f"_gnc{args.gnc_kt0:g}x{args.gnc_iters}" if args.gnc_kt0 else ""),
        "pgo_init": bool(args.pgo_init),
        "pgo_lm_rounds": args.pgo_lm_rounds,
        "gnc_kt0": args.gnc_kt0,
        "gnc_iters": args.gnc_iters,
        "loop_closures": args.loop_closures,
        "n_poses": graph.n_poses,
        "n_landmarks": graph.n_landmarks,
        "n_edges": graph.n_bearing + graph.n_odometry,
        "cg_tol": args.cg_tol,
        "cg_cap": args.cg_iters,
        "kernel_threshold": args.kernel_threshold,
        "preconditioner": args.preconditioner,
        "lm_up": args.lm_up,
        **trace,
        **{k: round(v, 4) for k, v in m.items() if v is not None},
    }

    if n_poses <= args.crosscheck_max:
        from boslam_torch.solver.optimizer import solve_packed

        log("flat schur_cg cross-check (independent path, tight tol)...")
        gf, flat_chi2 = flat_crosscheck(graph, cfg, args.max_outer, args.plateau_rel)

        def chi2_of(x):
            return float(chi2_stats(edge_terms(x, cfg), cfg)["chi2_robust"])

        packed_chi2 = chi2_of(final)
        rel = abs(packed_chi2 - flat_chi2) / max(abs(flat_chi2), 1e-30)
        mf = ate_metrics(gf.poses.cpu().numpy(), gt_poses)
        # the two outer trajectories can land in different local optima;
        # the two-sided operator check is fixed-point consistency: the
        # packed solver started from the flat optimum stays there
        pcfg = cfg.replace(iters=10, cg_iters=300, cg_tol=1e-5, lm_split=0, cg_warm_start=False)
        packed_at_flat = chi2_of(solve_packed(gf, pcfg)[0])
        fp_rel = abs(packed_at_flat - flat_chi2) / max(abs(flat_chi2), 1e-30)
        rec["flat_crosscheck"] = {
            "flat_chi2_final": flat_chi2,
            "packed_chi2_final": packed_chi2,
            "rel_diff": rel,
            "flat_ate_rmse_aligned": round(mf["ate_rmse_aligned"], 4),
            "agrees_1e3": bool(rel < 1e-3),
            "packed_not_worse": bool(packed_chi2 <= flat_chi2 * 1.001),
            "packed_from_flat_chi2": packed_at_flat,
            "fixed_point_rel": fp_rel,
            "fixed_point_agrees_1e3": bool(packed_at_flat <= flat_chi2 * (1 + 1e-3)),
        }
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--poses", type=int, nargs="+", default=[10_000, 100_000])
    ap.add_argument("--max-outer", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--cg-tol", type=float, default=1e-3)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--preconditioner", default="auto")
    ap.add_argument("--plateau-rel", type=float, default=1e-4)
    ap.add_argument("--lm-up", type=float, default=10.0)
    ap.add_argument("--lm-down", type=float, default=0.1)
    ap.add_argument("--loop-closures", type=int, default=0,
                    help="extra odometry loop-closure edges in the synthetic")
    ap.add_argument("--pgo-init", action="store_true",
                    help="rotation-averaging + linear-translation init before the solve")
    ap.add_argument("--pgo-lm-rounds", type=int, default=2,
                    help="virtual-closure (landmark re-observation) rounds of the linear init")
    ap.add_argument("--gnc-kt0", type=float, default=0.0,
                    help="graduated non-convexity initial threshold (0 = off)")
    ap.add_argument("--gnc-iters", type=int, default=0)
    ap.add_argument("--kernel-threshold", type=float, default=1.0)
    ap.add_argument("--coarse-every", type=int, default=0,
                    help="rigid-segment coarse correction every N outers (0 = off)")
    ap.add_argument("--coarse-seg", type=int, default=64)
    ap.add_argument("--coarse-rounds", type=int, default=3)
    ap.add_argument("--crosscheck-max", type=int, default=10_000)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    import boslam_torch  # noqa: F401  (full-f32 matmul precision)

    logging.getLogger("boslam_torch.init").setLevel(logging.ERROR)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            log("error: --device cuda, but torch.cuda.is_available() is False")
            return 2
        log(f"device: {torch.cuda.get_device_name(0)}")
    for n in args.poses:
        t0 = time.time()
        rec = run_config(n, args)
        rec["total_wall_s"] = round(time.time() - t0, 1)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
