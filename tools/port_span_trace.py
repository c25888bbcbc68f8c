"""Where the device's idle time goes in one whole solve, by program span,
and what the spans' profiler annotations cost.

On ``generate_sequence(n, 2n/5, seed=0)`` (the 10k walk by default), one
whole solve as a user runs it: ``build_graph`` with triangulation,
``solve_packed`` (5 GN outers, block-Jacobi PCG capped at 100) and the
final state copied to the host.  ``--corridor`` lays the same graph out
as the benchmark's corridor, a straight line (``turn_every=10**9``),
solved with windowed gathers.  After two warm solves, ``--rounds``
rounds each profile the solve twice: once bare (``_profile_once``, no
annotation) and once through ``utils/profiling.device_time_by_kernel``,
which annotates the program's spans.  The wall times of the two, on the
host's clock around the profiled call, give the annotations' cost.

The last annotated trace's ``by_span`` is printed as a table: for each
program span, the device's busy ms, the operations it launched and the
idle ms before them, ranked by idle time; then the idle time summed over
the spans against the window's (window less busy time).

    python tools/port_span_trace.py [--poses N] [--corridor] [--rounds R]
                                   [--device cuda|cpu] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=10000)
    ap.add_argument("--corridor", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import logging

    import torch

    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.synth import generate_sequence
    from boslam_torch.utils import profiling

    # the build warns once per landmark with a single observation
    logging.getLogger("boslam_torch").setLevel(logging.ERROR)
    dev = torch.device(args.device)
    layout = {"turn_every": 10**9} if args.corridor else {}
    parsed, _ = generate_sequence(args.poses, args.poses * 2 // 5, seed=0, **layout)
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=5,
                       cg_iters=100, cg_tol=1e-5,
                       gather="windowed" if args.corridor else "auto")

    def whole_solve():
        g, _ = build_graph(parsed, init="triangulate", device=dev)
        out, _ = solve_packed(g, cfg)
        return out.poses.cpu(), out.landmarks.cpu()

    for _ in range(2):
        whole_solve()
    off, on, tr = [], [], None
    for _ in range(args.rounds):
        off.append(profiling._profile_once(whole_solve, dev)[1])
        tr = profiling.device_time_by_kernel(whole_solve, dev)
        on.append(tr.wall_ms)
    rows = sorted(tr.by_span.items(), key=lambda kv: -kv[1][2])
    idle_ms = sum(i for _, _, i in tr.by_span.values()) * 1e3
    window_idle_ms = tr.window_ms - tr.busy_ms
    print(f"{'span':<32} {'busy ms':>10} {'ops':>7} {'idle ms':>10} {'idle %':>7}")
    for path, (busy, n, idle) in rows:
        print(f"{path:<32} {busy * 1e3:>10.3f} {n:>7d} {idle * 1e3:>10.3f} "
              f"{100 * idle * 1e3 / idle_ms:>7.2f}")
    print(f"idle summed by span {idle_ms:.3f} ms; window {tr.window_ms:.3f} ms less busy "
          f"{tr.busy_ms:.3f} ms = {window_idle_ms:.3f} ms "
          f"({100 * (idle_ms / window_idle_ms - 1):+.3f}%)")
    print(f"wall of the profiled solve, ms: bare {off}, annotated {on}; medians "
          f"{statistics.median(off):.3f} and {statistics.median(on):.3f}")
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "poses": args.poses, "corridor": args.corridor, "n_ops": tr.n_ops, "busy_ms": tr.busy_ms,
           "window_ms": tr.window_ms, "idle_summed_ms": idle_ms,
           "window_idle_ms": window_idle_ms,
           "by_span": {k: list(v) for k, v in tr.by_span.items()},
           "wall_ms_bare": off, "wall_ms_annotated": on}
    print(json.dumps(out))
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
