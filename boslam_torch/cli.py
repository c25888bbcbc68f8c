"""Command-line interface of the PyTorch port (mirrors ``boslam/cli.py``).

Usage:
  python -m boslam_torch solve <dataset.g2o> [--gt ground_truth.g2o]
      [--linear-solver dense|schur|schur_cg] [--packed] [--optimizer gn|lm]
      [--pgo-init [--pgo-lm-rounds 2]] [--save state.npz] [--resume state.npz]
      [--render out.png] [--print-state] [--profile DIR] [--interactive]
      [--iters N] [--device cuda|cpu]
  python -m boslam_torch synth --poses 300 --out /tmp/synth.g2o
  python -m boslam_torch bench <dataset.g2o> [--iters 50] [--device cuda|cpu]

The solve prints a per-iteration chi2 table.  ``--device`` defaults to
``cuda`` and fails on a machine without it.  GN under ``--linear-solver
schur`` takes the whole-step kernel on the card, the unfused path on the
CPU.  ``--linear-solver schur_cg`` runs the flat Schur+PCG path;
``--packed`` the dual-packed Schur+PCG scale path (``solve_packed``), which
reads the CG, preconditioner (``--band-width``/``--band-group`` for
bband), GNC, ``--coupling-dtype`` and ``--lm-split`` flags.  The windowed
gather, ``two_level_cycle`` and ``cholesky_backend`` are set through the
API (``SolverConfig(gather="windowed")``), as in the JAX package.
``--render`` writes PNGs of the initial and final states and
``--interactive`` steps the solve from the keyboard; both need matplotlib.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the solve.
``bench`` times three solves after a first one and prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _lm_split_arg(value: str):
    if value == "auto":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected 'auto' or an integer slot cap, got {value!r}")


def _add_solver_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--optimizer", choices=["gn", "lm"], default="gn")
    p.add_argument("--robust", choices=["threshold", "huber", "none"], default="threshold")
    p.add_argument("--kernel-threshold", type=float, default=1.0)
    p.add_argument("--damping", type=float, default=0.01)
    p.add_argument("--linear-solver", choices=["dense", "schur", "schur_cg"], default="dense")
    p.add_argument("--packed", action="store_true",
                   help="dual-packed Schur+PCG layout (the large-scale path)")
    p.add_argument("--cg-iters", type=int, default=100)
    p.add_argument("--cg-tol", type=float, default=1e-5)
    p.add_argument("--cg-restarts", type=int, default=8,
                   help="Krylov restarts absorbed per CG solve on f32 breakdown events")
    p.add_argument("--cg-warm-start", action="store_true",
                   help="warm-start CG from the previous outer delta (packed)")
    p.add_argument("--preconditioner", choices=["auto", "block_jacobi", "btridiag", "bband",
                                                "two_level"], default="auto",
                   help="PCG preconditioner (bband: packed path)")
    p.add_argument("--coarse-q", type=int, default=0,
                   help="two_level: poses per coarse aggregate (0 = auto)")
    p.add_argument("--band-width", type=int, default=8,
                   help="bband: S offsets 1..w kept exactly")
    p.add_argument("--band-group", type=int, default=0,
                   help="bband: poses per super-node (0 = band width)")
    p.add_argument("--gnc-kt0", type=float, default=0.0,
                   help="graduated non-convexity: initial robust threshold (0 = off), "
                        "annealed to --kernel-threshold over --gnc-iters outers (packed)")
    p.add_argument("--gnc-iters", type=int, default=0)
    p.add_argument("--lm-split", default="auto", type=_lm_split_arg,
                   help="packed path: landmark-grid slot cap ('auto' | 0 = off | int cap)")
    p.add_argument("--textbook-kernel", action="store_true",
                   help="weight H by the robust weight too (no b-side-only quirk)")
    p.add_argument("--autodiff-jacobians", action="store_true",
                   help="Jacobians by torch.func.jacfwd instead of the closed forms "
                        "(the reference's numerical-Jacobian verification mode)")
    p.add_argument("--coupling-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="packed path: storage dtype of the Schur coupling blocks "
                        "(bfloat16 halves their bytes; f32 sums)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def _cfg_from_args(args):
    from boslam_torch.config import SolverConfig

    return SolverConfig(
        iters=args.iters,
        optimizer=args.optimizer,
        robust=args.robust,
        kernel_threshold=args.kernel_threshold,
        damping=args.damping,
        linear_solver=args.linear_solver,
        cg_iters=args.cg_iters,
        cg_tol=args.cg_tol,
        cg_restarts=args.cg_restarts,
        cg_warm_start=args.cg_warm_start,
        preconditioner=args.preconditioner,
        band_width=args.band_width,
        band_group=args.band_group,
        coarse_q=args.coarse_q,
        gnc_kt0=args.gnc_kt0,
        gnc_anneal_iters=args.gnc_iters,
        reference_kernel_quirk=not args.textbook_kernel,
        use_autodiff_jacobians=args.autodiff_jacobians,
        lm_split=args.lm_split,
        coupling_dtype=args.coupling_dtype,
    )


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _have_matplotlib(flag: str) -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"error: {flag} needs matplotlib, which is not installed", file=sys.stderr)
        return False
    return True


def cmd_solve(args) -> int:
    import numpy as np

    from boslam_torch.graph.build import build_graph
    from boslam_torch.io.g2o import parse_g2o, write_g2o
    from boslam_torch.metrics import ate_metrics, match_gt_landmarks, match_gt_poses
    from boslam_torch.solver.optimizer import solve, solve_packed

    if args.render and not _have_matplotlib("--render"):
        return 2
    if args.interactive and not _have_matplotlib("--interactive"):
        return 2
    parsed = parse_g2o(args.dataset)
    graph, meta = build_graph(parsed, init=args.init, device=args.device)
    cfg = _cfg_from_args(args)
    print(
        f"loaded {graph.n_poses} poses, {graph.n_landmarks} landmarks, "
        f"{graph.n_bearing} bearing + {graph.n_odometry} odometry edges; "
        f"gauge pose id {meta.fixed_pose_id}; device {graph.device}",
        file=sys.stderr,
    )
    if args.pgo_init:
        from boslam_torch.init.pose_graph import pgo_initialize

        graph = pgo_initialize(graph, landmark_rounds=args.pgo_lm_rounds)
        print("pose-graph init applied (rotation averaging + linear "
              "translation + re-triangulation)", file=sys.stderr)

    start_iter, lam0, dp0 = 0, None, None
    if args.resume:
        from boslam_torch.io.checkpoint import load_npz

        try:
            graph, meta, start_iter, lam0, dp0 = load_npz(args.resume, graph, meta)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        remaining = max(0, args.iters - start_iter)
        print(
            f"resumed from {args.resume} at iteration {start_iter}"
            + (f" (lm lambda {lam0:g})" if lam0 is not None else "")
            + f"; {remaining} iterations remain",
            file=sys.stderr,
        )
        cfg = cfg.replace(iters=remaining)
        if remaining == 0:
            print("checkpoint already past --iters; nothing to do", file=sys.stderr)

    if args.render:
        from boslam_torch.viz.draw import save_render

        save_render(
            args.render.replace(".png", "_initial.png"),
            graph.poses.cpu().numpy(),
            graph.landmarks.cpu().numpy(),
            bound=meta.bound,
            bearings=(graph.b_pose.cpu().numpy(), graph.b_meas.cpu().numpy()),
            odometries=(graph.o_src.cpu().numpy(), graph.o_meas.cpu().numpy()),
            iteration=0,
            max_iterations=cfg.iters,
        )

    if args.interactive:
        return _interactive_loop(graph, meta, cfg)

    profiling = contextlib.nullcontext()
    if args.profile:
        from boslam_torch.utils.profiling import trace

        profiling = trace(args.profile)
    t0 = time.perf_counter()
    with profiling:
        if args.packed:
            g2, stats = solve_packed(graph, cfg, lam0=lam0, dp0=dp0, start_iter=start_iter)
        else:
            g2, stats = solve(graph, cfg, lam0=lam0)
        _sync(graph.device)
    wall = time.perf_counter() - t0
    if args.profile:
        print(f"profile trace written to {args.profile}", file=sys.stderr)

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
    if args.print_state:
        from boslam_torch.graph.data import print_full_state

        print_full_state(poses, landmarks)
    if args.gt:
        gt = parse_g2o(args.gt)
        m = ate_metrics(poses, match_gt_poses(meta, gt), landmarks, match_gt_landmarks(meta, gt))
        print("ATE vs ground truth: " + json.dumps(m))
    if args.render:
        from boslam_torch.viz.draw import save_render

        save_render(args.render, poses, landmarks, bound=meta.bound, iteration=cfg.iters,
                    max_iterations=cfg.iters)
        print(f"renders written to {args.render}", file=sys.stderr)
    if args.out:
        write_g2o(args.out, meta.pose_ids, poses, meta.lm_ids, np.asarray(landmarks),
                  parsed=parsed, fixed_pose_id=meta.fixed_pose_id)
        print(f"optimized state written to {args.out}", file=sys.stderr)
    if args.save:
        from boslam_torch.io.checkpoint import save_npz

        # the damping of the next LM trial, so that a resumed run repeats
        # the uninterrupted one; the packed path's last outer delta makes a
        # resumed cg_warm_start run iteration-exact
        lam_final = float(st["lam_final"]) if cfg.optimizer == "lm" else None
        save_npz(args.save, g2, meta, iteration=start_iter + cfg.iters, lm_lambda=lam_final,
                 dp=st.get("dp_final"))
        print(f"checkpoint written to {args.save}", file=sys.stderr)
    return 0


# The reference's startup banner (executables/bearing_only_slam.cpp:76-79).
_BANNER = r"""
 ______  _______ _______  ______ _____ __   _  ______      _____  __   _        __   __      _______        _______ _______
 |_____] |______ |_____| |_____/   |   | \  | |  ____ ___ |     | | \  | |        \_/        |______ |      |_____| |  |  |
 |_____] |______ |     | |    \_ __|__ |  \_| |_____|     |_____| |  \_| |_____    |         ______| |_____ |     | |  |  |
"""


def _interactive_loop(graph, meta, cfg) -> int:
    """The reference's keyboard loop (bearing_only_slam.cpp:88-113) in a
    matplotlib window: any key = 1 step, Tab/PgDn/Shift = 50 steps, b/o
    toggle the bearing/odometry overlays, Esc quits.  Refuses, non-zero,
    where only a non-interactive backend is available."""
    import os

    import matplotlib

    # Agg and the other file backends render to nothing; GUI backends
    # (TkAgg, QtAgg, ...) also end in "agg" and are left alone
    backend = matplotlib.get_backend().lower()
    headless = {"agg", "pdf", "svg", "ps", "pgf", "cairo", "template"}
    if backend in headless or (backend.startswith("module://")
                               and not any(k in backend for k in ("ipympl", "webagg", "widget"))):
        if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
            print(
                "error: --interactive needs a GUI matplotlib backend, but "
                f"only {matplotlib.get_backend()!r} is available (no DISPLAY). "
                "Run on a machine with a display, set MPLBACKEND to an "
                "interactive backend, or drop --interactive for the "
                "headless solve (--render writes PNGs).",
                file=sys.stderr,
            )
            return 2
        try:  # a display exists: try the stock interactive backend
            matplotlib.use("TkAgg")
        except Exception as exc:
            print(f"error: no usable interactive matplotlib backend ({exc}); "
                  "set MPLBACKEND or drop --interactive.", file=sys.stderr)
            return 2
    import matplotlib.pyplot as plt
    import torch

    from boslam_torch.solver.optimizer import gn_step, lm_step
    from boslam_torch.viz.draw import render_state

    print(_BANNER)
    print("Any key other than the specified ones: advance one iteration")
    print("Tab/PgDn/Shift: advance many iterations")
    print("B: toggle bearing observation display")
    print("O: toggle odometry observation display")
    print("Esc: close")

    state = {"g": graph, "it": 0, "show_b": False, "show_o": False,
             "lam": torch.full((), cfg.lm_lambda0, dtype=graph.poses.dtype, device=graph.device)}
    fig, ax = plt.subplots(figsize=(8, 8))

    def step_n(n):
        for _ in range(n):
            if cfg.optimizer == "lm":
                g2, state["lam"], stats = lm_step(state["g"], state["lam"], cfg)
            else:
                g2, stats = gn_step(state["g"], cfg)
            state["g"] = g2
            state["it"] += 1
        print(f"iter {state['it']}: chi2_robust={float(stats['chi2_robust']):.6f}")

    def redraw():
        ax.clear()
        g = state["g"]
        render_state(
            g.poses.cpu().numpy(),
            g.landmarks.cpu().numpy(),
            bound=meta.bound,
            bearings=(g.b_pose.cpu().numpy(), g.b_meas.cpu().numpy()) if state["show_b"] else None,
            odometries=(g.o_src.cpu().numpy(), g.o_meas.cpu().numpy()) if state["show_o"] else None,
            iteration=state["it"],
            max_iterations=max(cfg.iters, state["it"] + 1),
            ax=ax,
        )
        fig.canvas.draw_idle()

    def on_key(event):
        # Tab, PgDn and Shift run the 50-step batch (bearing_only_slam.cpp:95)
        if event.key == "escape":
            plt.close(fig)
            return
        if event.key in ("tab", "pagedown", "shift"):
            print("Occhio che ci metto un po'")  # bearing_only_slam.cpp:96
            step_n(50)
            print("Fatto!")  # bearing_only_slam.cpp:99
        elif event.key == "b":
            state["show_b"] = not state["show_b"]
        elif event.key == "o":
            state["show_o"] = not state["show_o"]
        else:
            step_n(1)
        redraw()

    fig.canvas.mpl_connect("key_press_event", on_key)
    redraw()
    plt.show()
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


def cmd_bench(args) -> int:
    """One ``solve`` (kernel build and first run), then the best of three,
    each ending in a wait for the card; one JSON line with the JAX CLI's
    keys.  As in the JAX CLI, the flat ``solve`` runs (``--packed`` is not
    read here)."""
    import numpy as np

    from boslam_torch.graph.build import build_graph
    from boslam_torch.io.g2o import parse_g2o
    from boslam_torch.solver.optimizer import solve

    parsed = parse_g2o(args.dataset)
    graph, _ = build_graph(parsed, init=args.init, device=args.device)
    cfg = _cfg_from_args(args)
    t0 = time.perf_counter()
    _, stats = solve(graph, cfg)
    _sync(graph.device)
    first_wall = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve(graph, cfg)
        _sync(graph.device)
        times.append(time.perf_counter() - t0)
    print(json.dumps({
        "n_poses": graph.n_poses,
        "n_landmarks": graph.n_landmarks,
        "n_edges": graph.n_bearing + graph.n_odometry,
        "iters": cfg.iters,
        "compile_plus_run_s": round(first_wall, 4),
        "best_run_s": round(min(times), 4),
        "iters_per_s": round(cfg.iters / min(times), 2),
        "final_chi2": float(np.asarray(stats["chi2_robust"].cpu())[-1]),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="boslam_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="optimize a g2o pose graph")
    ps.add_argument("dataset")
    ps.add_argument("--gt", default=None, help="ground-truth g2o for ATE")
    ps.add_argument("--init", choices=["auto", "triangulate", "file"], default="auto")
    ps.add_argument("--pgo-init", action="store_true",
                    help="rotation-averaging + linear-translation pose-graph "
                         "initialization before the solve (re-triangulates "
                         "landmarks; boslam_torch/init/pose_graph.py)")
    ps.add_argument("--pgo-lm-rounds", type=int, default=0,
                    help="virtual-closure (landmark re-observation) rounds "
                         "of the linear init (scale problems: 2)")
    ps.add_argument("--out", default=None, help="write optimized g2o")
    ps.add_argument("--save", default=None, help="write npz checkpoint")
    ps.add_argument("--resume", default=None,
                    help="resume from an npz checkpoint: restores the state, "
                         "the iteration counter (runs the remaining --iters), "
                         "and the LM damping")
    ps.add_argument("--render", default=None,
                    help="write PNG renders of the final state and <name>_initial.png")
    ps.add_argument("--profile", default=None,
                    help="write a torch.profiler Chrome trace of the solve into this directory")
    ps.add_argument("--interactive", action="store_true",
                    help="step the solve from the keyboard in a matplotlib window")
    ps.add_argument("--print-state", action="store_true",
                    help="dump the packed [3NP|2NL] state vector (State::print_full_vector)")
    _add_solver_args(ps)
    ps.set_defaults(fn=cmd_solve)

    pg = sub.add_parser("synth", help="generate a synthetic sequence")
    pg.add_argument("--poses", type=int, default=10000)
    pg.add_argument("--landmarks", type=int, default=None)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--loop-closures", type=int, default=0)
    pg.add_argument("--out", required=True)
    pg.set_defaults(fn=cmd_synth)

    pb = sub.add_parser("bench", help="time a solve")
    pb.add_argument("dataset")
    pb.add_argument("--init", choices=["auto", "triangulate", "file"], default="auto")
    _add_solver_args(pb)
    pb.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)
