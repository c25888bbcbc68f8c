"""A/B of every solver path of the PyTorch port at reference size (port of
``tools/headline_ab.py``).

Every path runs under one protocol: 50 GN iterations through the solver's
own loop, a first run (kernel build included, excluded from the times),
then ``--repeats`` timed runs, each ending in ``torch.cuda.synchronize()``,
best of them.  ``--no-cg-warmup`` skips the first run of the three CG
paths, which build no kernel (their ``compile_s`` is then null), for a
caller that has run the port's code already.  Each record carries the JAX tool's keys: model and
useful-FLOP utilization and the converged chi2, here held against the
port's CPU run of the same path on the same graph (rel < 1e-4), and
against the C++ optimum where the reference dataset is present.  The
utilizations use ``boslam_torch/utils/roofline.py`` with the JAX tool's
models and arguments against the card's ``chip_spec()``:
``dense_step_model`` for dense, ``packed_outer_model`` for every other
path, which at 0 CG iterations (the direct Schur paths) counts the packed
build only.

    python tools/port_headline_ab.py [--repeats 5] [--device cuda|cpu]
        [--g2o PATH] [--paths dense schur ...] [--no-cg-warmup] [--json-out FILE]

Paths (the JAX tool's ``schur_fused_scan`` is ``schur_fused`` here: one C
call per iteration, not one compiled scan):

  dense        GN, dense H, the Cholesky kernel
  schur        GN, exact Schur, whole-step kernel off: the Schur-solve kernel
  schur_fused  GN, exact Schur, fused_step "auto": the whole-step kernel
  schur_cg     flat Schur + block-Jacobi PCG (150, 1e-6)
  packed_bj    dual-packed Schur + block-Jacobi PCG (150, 1e-6)
  packed_bt    dual-packed Schur + btridiag PCG (150, 1e-4) + CG warm start

The graph is ``--g2o``, else the reference dataset where it exists, else
``generate_sequence(301, 141, seed=3)`` (``boslam_torch.bench``'s rule).
On the CPU (``--device cpu``, a rehearsal) no card's peaks apply and the
utilizations are null.  Prints one JSON object; exits 1 if a path failed
or missed its chi2 bound.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ITERS = 50
CPU_RTOL = 1e-4
REF_RTOL = 1e-3
# name -> (SolverConfig overrides, packed layout, CG iterations for the models)
PATHS = {
    "dense": (dict(), False, None),
    "schur": (dict(linear_solver="schur", fused_step="off"), False, None),
    "schur_fused": (dict(linear_solver="schur"), False, None),
    "schur_cg": (dict(linear_solver="schur_cg", cg_iters=150, cg_tol=1e-6,
                      preconditioner="block_jacobi"), False, 150),
    "packed_bj": (dict(linear_solver="schur_cg", cg_iters=150, cg_tol=1e-6,
                       preconditioner="block_jacobi"), True, 150),
    # tol 1e-4, not tighter: the JAX tool's choice (1e-6 sits below the f32
    # matvec noise floor, where the CG iteration count is decided by roundoff)
    "packed_bt": (dict(linear_solver="schur_cg", cg_iters=150, cg_tol=1e-4,
                       preconditioner="btridiag", cg_warm_start=True), True, 150),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def path_config(name):
    from boslam_torch.config import SolverConfig

    return SolverConfig(iters=ITERS).replace(**PATHS[name][0])


def make_runner(name, graph):
    """() -> (final graph, stats) of one 50-iteration run of path ``name``
    on ``graph``; the packed paths pack the edges here, once."""
    from boslam_torch.device import host_sync
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.solver.optimizer import packed_solve_loop, solve

    cfg = path_config(name)
    if not PATHS[name][1]:
        return lambda: solve(graph, cfg)
    with host_sync(graph.device):
        pk, _ = pack_edges(graph, split_lm=cfg.lm_split)
    return lambda: packed_solve_loop(graph, pk, cfg)


def _launch_counters():
    from boslam_torch.ops import cholesky, gn_step, schur_solve, windowed_gather

    return {"cholesky": cholesky.cholesky_solve_padded,
            "schur": schur_solve.fused_schur_solve_blocks,
            "gn_step": gn_step.fused_gn_step, "windowed_take": windowed_gather.windowed_take}


def measure(run, device, repeats, warmup=True):
    """First run (excluded; skipped without ``warmup``), then ``repeats``
    timed runs.  Returns (final graph, stats, best seconds, first-run
    seconds or None, times, kernel launches of the last run)."""
    from boslam_torch.bench import sync

    first_s = None
    if warmup:
        sync(device)
        t0 = time.perf_counter()
        run()
        sync(device)
        first_s = time.perf_counter() - t0
    counters, times = _launch_counters(), []
    for _ in range(repeats):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        g, st = run()
        sync(device)
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    return g, st, min(times), first_s, times, launches


def cpu_reference(name, graph_cpu) -> float:
    """Converged chi2 of path ``name`` on the CPU graph."""
    from boslam_torch.bench import final_chi2

    g, _ = make_runner(name, graph_cpu)()
    return final_chi2(g, path_config("dense"))


def path_record(name, graph, spec, repeats, chi2_cpu, ref_chi2=None, cg_warmup=True) -> dict:
    """One path's record: the JAX tool's keys, plus the CPU check, the mean
    CG iterations and the kernel launches of the last timed run.  Without
    ``cg_warmup`` a CG path (no kernel to build) skips its first run."""
    from boslam_torch.bench import final_chi2
    from boslam_torch.device import host_sync
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.utils.roofline import (dense_step_model, packed_outer_model,
                                             roofline_report, useful_step_flops)

    NP_, NL, NB, NO = graph.n_poses, graph.n_landmarks, graph.n_bearing, graph.n_odometry
    cg_hint = PATHS[name][2]
    g, st, best, first_s, times, launches = measure(make_runner(name, graph), graph.device,
                                                    repeats, cg_warmup or cg_hint is None)
    base = path_config("dense")  # chi2 under the default robust kernel, as the JAX tool
    chi2 = final_chi2(g, base)
    with host_sync(graph.device):
        cg_mean = float(st["cg_iters"].float().mean()) if "cg_iters" in st else None
    per_iter = best / ITERS
    model_util = useful_util = None
    if spec is not None:
        if name == "dense":
            mf, mb = dense_step_model(NP_, NL, NB, NO)
        else:
            with host_sync(graph.device):
                pk, _ = pack_edges(graph)
            mf, mb = packed_outer_model(NP_, NL, pk.K, pk.K2, NO, cg_hint or 0)
        model_util = roofline_report(mf, mb, per_iter, spec)["roofline_util"]
        useful_util = round(useful_step_flops(NP_, NL, NB, NO, cg_iters=cg_hint or 0)
                            / per_iter / spec.peak_flops_f32, 6)
    rel_cpu = abs(chi2 - chi2_cpu) / chi2_cpu
    rel_cpp = None if ref_chi2 is None else abs(chi2 - ref_chi2) / ref_chi2
    return {
        "iters_per_s": round(ITERS / best, 1),
        "per_iter_ms": round(per_iter * 1e3, 3),
        "compile_s": None if first_s is None else round(first_s, 1),
        "times_ms": [round(t * 1e3, 1) for t in times],
        "chi2": chi2,
        "chi2_rel_vs_cpp": rel_cpp,
        "converged": rel_cpu < CPU_RTOL if rel_cpp is None else rel_cpp < REF_RTOL,
        "model_util": model_util,
        "useful_flops_util": useful_util,
        "chi2_cpu": chi2_cpu,
        "chi2_rel_vs_cpu": rel_cpu,
        "cg_iters_mean": cg_mean,
        "model": "dense_step_model" if name == "dense" else "packed_outer_model",
        "launches": launches,
    }


def run_paths(graph, graph_cpu, names=tuple(PATHS), repeats=5, spec=None, ref_chi2=None,
              chi2_cpu=None, cg_warmup=True) -> dict:
    """{path: record} for each of ``names``; a path that raises gets
    ``{"error": ...}`` and the others still run.  ``chi2_cpu`` gives CPU
    references already computed, by path name; ``cg_warmup`` as in
    ``path_record``."""
    results = {}
    for name in names:
        try:
            c = (chi2_cpu or {}).get(name)
            if c is None:
                c = cpu_reference(name, graph_cpu)
            results[name] = path_record(name, graph, spec, repeats, c, ref_chi2, cg_warmup)
        except Exception as exc:  # noqa: BLE001 -- recorded, and the other paths run
            log(f"{name}: FAILED\n{traceback.format_exc()}")
            results[name] = {"error": repr(exc)[:300]}
            continue
        log(f"{name}: {results[name]}")
    return results


def failures(results) -> list:
    """Paths that failed or missed their chi2 bound."""
    return [k for k, r in results.items() if "error" in r or not r["converged"]
            or not r["chi2_rel_vs_cpu"] < CPU_RTOL]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--g2o", default=None)
    ap.add_argument("--paths", nargs="+", choices=list(PATHS), default=list(PATHS))
    ap.add_argument("--no-cg-warmup", action="store_true",
                    help="skip the untimed first run of the CG paths (they build no kernel)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import torch

    import boslam_torch  # noqa: F401  (full-f32 matmul precision)
    from boslam_torch.bench import DATASET, REF_CHI2, load_graph
    from boslam_torch.device import resolve_device
    from boslam_torch.graph.build import build_graph
    from boslam_torch.utils.roofline import chip_spec

    dev = resolve_device(args.device)
    spec = chip_spec() if dev.type == "cuda" else None
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {dev} ({card})")
    parsed, source = load_graph(args.g2o)
    graph, _ = build_graph(parsed, init="triangulate", device=dev)
    graph_cpu, _ = build_graph(parsed, init="triangulate", device="cpu")
    results = run_paths(graph, graph_cpu, args.paths, args.repeats, spec,
                        REF_CHI2 if source == DATASET else None,
                        cg_warmup=not args.no_cg_warmup)
    out = {"dataset": source, "iters": ITERS, "chip": None if spec is None else spec.name,
           "device": card, "repeats": args.repeats, "results": results}
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    bad = failures(results)
    if bad:
        log(f"failed or off their chi2 bound: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
