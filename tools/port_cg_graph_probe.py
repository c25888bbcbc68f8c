"""What the CG loop's CUDA graph costs and saves, solve by solve, on the card.

On ``generate_sequence(n, 2n/5, seed=0)`` (the 10k walk by default), the
packed solve (``solve_packed``, 5 GN outers) under a set of CG budgets:

  cell        the benchmark cell's: block-Jacobi, cap 100, ``cg_tol`` 1e-5
  cap<k>      block-Jacobi run to a cap of k (``cg_tol`` 1e-12), k = 2 ... 16
  config4     ``tools/port_scaling_bench.py`` config 4: "auto", cap 8,
              ``cg_tol`` 1e-4, warm start
  config4_tol its tolerance-controlled companion: cap 64, ``cg_tol`` 1e-2

each in the modes asked for: ``default`` (the program as it is) and
``eager`` (``pcg`` with its graph turned off; a program without one is its
``default``).  After one warm solve, ``--reps`` solves are timed on the
host's clock, the final state copied back; the program's spans give the
loop's own host time (``solve_packed/step/pcg`` less its polls) and the
polls' waits per outer.  One JSON line per case and mode on stdout.

``--memory``: instead, the 100k corridor of ``chip_smoke.py``'s scale phase
(``generate_sequence(100000, 39000, seed=3)`` without turns, windowed
gathers, block-Jacobi under "auto", 5 outers): the allocator's peak
allocated and reserved bytes over a first solve, and the reserved bytes
after each of ``--reps`` more.

    python tools/port_cg_graph_probe.py [--cases cell cap2 ...] [--modes default eager]
        [--poses N] [--reps R] [--memory]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CASES = ("cell", "cap2", "cap3", "cap4", "cap6", "cap8", "cap16", "config4", "config4_tol")


def _cfg(case):
    from boslam_torch.config import SolverConfig

    cell = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=5,
                        cg_iters=100, cg_tol=1e-5)
    if case == "cell":
        return cell
    if case.startswith("cap"):
        return cell.replace(cg_iters=int(case[3:]), cg_tol=1e-12)
    c4 = SolverConfig(linear_solver="schur_cg", iters=5, cg_iters=8, cg_tol=1e-4,
                      preconditioner="auto", cg_warm_start=True)
    return {"config4": c4, "config4_tol": c4.replace(cg_iters=64, cg_tol=1e-2)}[case]


def _eager_patch(mode):
    """A context that runs ``pcg`` eagerly in mode "eager", else nothing."""
    import contextlib
    import functools
    import inspect

    from boslam_torch.solver import schur, schur_packed

    @contextlib.contextmanager
    def patched():
        keep = schur_packed.pcg
        if mode == "eager" and "_eager" in inspect.signature(schur.pcg).parameters:
            schur_packed.pcg = functools.partial(schur.pcg, _eager=True)
        try:
            yield
        finally:
            schur_packed.pcg = keep

    return patched()


def _timed(torch, g, cfg, reps):
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.utils import spans

    out, st = solve_packed(g, cfg)
    out.poses.cpu()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out, st = solve_packed(g, cfg)
        out.poses.cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    roots = [r for r in spans.records() if r.name == "solve_packed"][-reps:]
    per_outer = cfg.iters * reps

    def ms(path):
        return sum(r.paths.get(path, (0, 0))[1] for r in roots) / 1e6 / per_outer

    poll = ms("solve_packed/step/pcg/poll")
    return dict(
        solve_ms=statistics.median(walls), solve_ms_all=[round(w, 3) for w in walls],
        pcg_self_ms_per_outer=ms("solve_packed/step/pcg") - poll, poll_ms_per_outer=poll,
        bodies_per_outer=sum(r.counters.get("cg.bodies", 0) for r in roots) / per_outer,
        graph_bodies_per_outer=sum(r.counters.get("cg.graph_bodies", 0) for r in roots)
        / per_outer,
        cg_iters=st["cg_iters"].tolist(), breakdown=st["cg_breakdown"].tolist())


def _memory(torch, dev, modes, reps):
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(100000, 39000, seed=3, turn_every=10**9)
    g, _ = build_graph(ig, init="triangulate", device=dev)
    cfg = SolverConfig(linear_solver="schur_cg", gather="windowed", iters=5)
    mib = 2**20
    for mode in modes:
        with _eager_patch(mode):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, st = solve_packed(g, cfg)
            out.poses.cpu()
            first_s = time.perf_counter() - t0
            del out, st
            torch.cuda.synchronize()
            rec = dict(mode=mode, case="100k_corridor", first_solve_s=first_s,
                       before_mib=[base[0] / mib, base[1] / mib],
                       peak_allocated_mib=torch.cuda.max_memory_allocated() / mib,
                       peak_reserved_mib=torch.cuda.max_memory_reserved() / mib,
                       allocated_after_mib=torch.cuda.memory_allocated() / mib,
                       reserved_after_mib=[torch.cuda.memory_reserved() / mib])
            for _ in range(reps):
                out, st = solve_packed(g, cfg)
                out.poses.cpu()
                del out, st
                torch.cuda.synchronize()
                rec["reserved_after_mib"].append(torch.cuda.memory_reserved() / mib)
            rec["allocated_end_mib"] = torch.cuda.memory_allocated() / mib
        print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES), choices=CASES)
    ap.add_argument("--modes", nargs="+", default=["default", "eager"],
                    choices=["default", "eager"])
    ap.add_argument("--poses", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--memory", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import logging

    import torch

    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence

    logging.getLogger("boslam_torch").setLevel(logging.ERROR)
    dev = torch.device(args.device)
    if args.memory:
        _memory(torch, dev, args.modes, args.reps)
        return 0
    ig, _ = generate_sequence(args.poses, args.poses * 2 // 5, seed=0)
    g, _ = build_graph(ig, init="triangulate", device=dev)
    for case in args.cases:
        cfg = _cfg(case)
        for mode in args.modes:
            with _eager_patch(mode):
                rec = _timed(torch, g, cfg, args.reps)
            print(json.dumps(dict(case=case, mode=mode, **rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
