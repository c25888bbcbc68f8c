"""Command-line interface of the PyTorch port (mirrors ``boslam/cli.py``).

Usage:
  python -m boslam_torch solve <dataset.g2o> [--gt ground_truth.g2o]
      [--linear-solver dense|schur] [--optimizer gn|lm] [--iters N]
      [--device cuda|cpu]
  python -m boslam_torch synth --poses 300 --out /tmp/synth.g2o

The solve prints a per-iteration chi2 table.  ``--device`` defaults to
``cuda`` and fails on a machine without it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_solve(args) -> int:
    import numpy as np
    import torch

    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.io.g2o import parse_g2o, write_g2o
    from boslam_torch.metrics import ate_metrics, match_gt_landmarks, match_gt_poses
    from boslam_torch.solver.optimizer import solve

    parsed = parse_g2o(args.dataset)
    graph, meta = build_graph(parsed, init=args.init, device=args.device)
    cfg = SolverConfig(
        iters=args.iters,
        optimizer=args.optimizer,
        robust=args.robust,
        kernel_threshold=args.kernel_threshold,
        damping=args.damping,
        linear_solver=args.linear_solver,
        reference_kernel_quirk=not args.textbook_kernel,
    )
    print(
        f"loaded {graph.n_poses} poses, {graph.n_landmarks} landmarks, "
        f"{graph.n_bearing} bearing + {graph.n_odometry} odometry edges; "
        f"gauge pose id {meta.fixed_pose_id}; device {graph.device}",
        file=sys.stderr,
    )
    t0 = time.perf_counter()
    g2, stats = solve(graph, cfg)
    if graph.device.type == "cuda":
        torch.cuda.synchronize(graph.device)
    wall = time.perf_counter() - t0

    st = {k: v.cpu().numpy() for k, v in stats.items()}
    print("iter  chi2_robust  chi2_bearing  chi2_odom  damping  accepted")
    for i in range(cfg.iters):
        print(
            f"{i:4d}  {st['chi2_robust'][i]:11.6f}  {st['chi2_bearing'][i]:12.6f}"
            f"  {st['chi2_odometry'][i]:9.6f}  {st['damping'][i]:.2e}  {bool(st['accepted'][i])}"
        )
    print(f"solved {cfg.iters} iterations in {wall:.3f}s", file=sys.stderr)
    if cfg.iters and not st["spd_ok"].all():
        print("warning: non-SPD system encountered in some iterations", file=sys.stderr)

    poses = g2.poses.cpu().numpy()
    landmarks = g2.landmarks.cpu().numpy()
    if args.gt:
        gt = parse_g2o(args.gt)
        m = ate_metrics(poses, match_gt_poses(meta, gt), landmarks, match_gt_landmarks(meta, gt))
        print("ATE vs ground truth: " + json.dumps(m))
    if args.out:
        write_g2o(args.out, meta.pose_ids, poses, meta.lm_ids, np.asarray(landmarks),
                  parsed=parsed, fixed_pose_id=meta.fixed_pose_id)
        print(f"optimized state written to {args.out}", file=sys.stderr)
    return 0


def cmd_synth(args) -> int:
    from boslam_torch.io.g2o import write_g2o
    from boslam_torch.synth import generate_sequence

    ig, gt = generate_sequence(
        args.poses, args.landmarks, seed=args.seed, loop_closures=args.loop_closures
    )
    for parsed, suffix in ((ig, ""), (gt, "_ground_truth")):
        path = args.out.replace(".g2o", f"{suffix}.g2o") if suffix else args.out
        write_g2o(path, parsed.pose_ids, parsed.pose_xyt, parsed.lm_ids, parsed.lm_xy,
                  parsed=parsed, fixed_pose_id=parsed.fixed_pose_id)
        print(f"wrote {path}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="boslam_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="optimize a g2o pose graph")
    ps.add_argument("dataset")
    ps.add_argument("--gt", default=None, help="ground-truth g2o for ATE")
    ps.add_argument("--init", choices=["auto", "triangulate", "file"], default="auto")
    ps.add_argument("--out", default=None, help="write optimized g2o")
    ps.add_argument("--iters", type=int, default=50)
    ps.add_argument("--optimizer", choices=["gn", "lm"], default="gn")
    ps.add_argument("--robust", choices=["threshold", "huber", "none"], default="threshold")
    ps.add_argument("--kernel-threshold", type=float, default=1.0)
    ps.add_argument("--damping", type=float, default=0.01)
    ps.add_argument("--linear-solver", choices=["dense", "schur"], default="dense")
    ps.add_argument("--textbook-kernel", action="store_true",
                    help="weight H by the robust weight too (no b-side-only quirk)")
    ps.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ps.set_defaults(fn=cmd_solve)

    pg = sub.add_parser("synth", help="generate a synthetic sequence")
    pg.add_argument("--poses", type=int, default=10000)
    pg.add_argument("--landmarks", type=int, default=None)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--loop-closures", type=int, default=0)
    pg.add_argument("--out", required=True)
    pg.set_defaults(fn=cmd_synth)

    args = ap.parse_args(argv)
    return args.fn(args)
