"""The headline benchmark of the port (port of the JAX repository's root
``bench.py``): GN iterations per second at the reference dataset's size.

    python -m boslam_torch.bench [--device cuda|cpu] [--g2o PATH]

Prints one JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``roofline_util``, ``roofline``) and a few of
its own (the card, the graph, the chi2 check, the first run).

Graph: ``--g2o``, else the C++ reference's dataset at ``DATASET``, the
fixed path the JAX ``bench.py`` reads (read only), when it exists, else
``generate_sequence(301, 141, seed=3)``, which has its dimensions.

Solve: ``SolverConfig(iters=50, linear_solver="schur")`` through
``optimizer.solve``; on the card that is the whole-step kernel, one C call
per GN iteration, on the band route at this size.

Correctness, before any timing: on the reference dataset the converged
chi2 against the C++ optimum (rel < 1e-3, as ``bench.py``); on any other
graph against the port's own CPU solve of the same graph (rel < 1e-4).

Timing: ``bench.py``'s adaptive best-of (at least 5 runs, stop after 3
that do not improve on the best, at most 20), each run one 50-iteration
solve ending in ``torch.cuda.synchronize()``.  The kernel build and the
first run are excluded and reported.

Baseline: the C++ reference solver (``tools/refbench``), run live only
when both its binary and the reference dataset exist, else the recorded
figure in ``tools/refbench/baseline.json``.

Roofline: ``utils/roofline.schur_step_model`` and ``useful_step_flops``
(the JAX headline's models, which count a dense factorization of S; the
band route factors only its envelope) against the card's
``chip_spec()``.  On the CPU no card's peaks apply: ``roofline`` and
``roofline_util`` are null unless a spec is passed to ``run``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the C++ reference's datasets, where the JAX package's bench.py and tests
# read them; nothing is looked for anywhere else (``--g2o`` overrides)
REFERENCE_DATA = "/root/reference/data"
DATASET = os.path.join(REFERENCE_DATA, "slam2D_bearing_only_initial_guess.g2o")
SYNTH = (301, 141, 3)  # generate_sequence(301, 141, seed=3): the dataset's dimensions
ITERS = 50
REPEATS = 5
REF_CHI2 = 5.882782  # the C++ solver's optimum, tools/refbench/baseline.json
REF_RTOL = 1e-3  # against the C++ optimum, as bench.py
CPU_RTOL = 1e-4  # against the port's CPU solve of the same graph
KEYS = ("metric", "value", "unit", "vs_baseline", "roofline_util", "roofline")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def final_chi2(g, cfg) -> float:
    """chi2_robust at the graph's state (after the last step)."""
    from boslam_torch.solver.normal_eq import chi2_stats, edge_terms

    return float(chi2_stats(edge_terms(g, cfg), cfg)["chi2_robust"].cpu())


def best_of(run, device, repeats=REPEATS, stale_after=3, cap=20) -> list:
    """``bench.py``'s adaptive repeats: the seconds of each run of
    ``run()``, at least ``repeats`` runs, then until the best has not
    improved for ``stale_after`` runs in a row, at most ``cap``."""
    times, stale = [], 0
    while len(times) < cap and (len(times) < repeats or stale < stale_after):
        sync(device)
        t0 = time.perf_counter()
        run()
        sync(device)
        t = time.perf_counter() - t0
        stale = stale + 1 if times and t >= min(times) else 0
        times.append(t)
    return times


def reference_baseline() -> float:
    """C++ reference iterations/s: a live run of ``tools/refbench`` when
    its binary and the reference dataset both exist, else the recorded
    figure."""
    bin_path = os.path.join(REPO, "tools", "refbench", "refbench")
    if os.path.exists(bin_path) and os.path.exists(DATASET):
        try:
            out = subprocess.run([bin_path, DATASET, str(ITERS)], capture_output=True,
                                 text=True, timeout=600, check=True)
            val = float(json.loads(out.stdout.strip().splitlines()[-1])["iters_per_s"])
            log(f"refbench live: {val:.3f} iters/s")
            return val
        except (OSError, subprocess.SubprocessError, ValueError, KeyError, IndexError) as exc:
            log(f"refbench live run failed ({exc!r}); using the recorded baseline")
    path = os.path.join(REPO, "tools", "refbench", "baseline.json")
    with open(path) as f:
        val = float(json.load(f)["iters_per_s"])
    log(f"baseline: {val} iters/s, the recorded C++ reference figure ({path}) on a CPU host, "
        "not re-run here")
    return val


def load_graph(g2o=None):
    """(parsed input, its name): ``g2o``, else the reference dataset where
    it exists, else the synthetic graph with its dimensions."""
    from boslam_torch.io.g2o import parse_g2o
    from boslam_torch.synth import generate_sequence

    path = g2o or (DATASET if os.path.exists(DATASET) else None)
    if path is not None:
        return parse_g2o(path), path
    n_poses, n_landmarks, seed = SYNTH
    parsed, _ = generate_sequence(n_poses, n_landmarks, seed=seed)
    return parsed, f"generate_sequence({n_poses}, {n_landmarks}, seed={seed})"


def headline_roofline(graph, seconds_per_iter: float, spec) -> dict:
    """``bench.py``'s roofline block: ``schur_step_model`` against the
    card's peaks, with ``useful_flops_util`` from ``useful_step_flops``."""
    from boslam_torch.utils.roofline import roofline_report, schur_step_model, useful_step_flops

    dims = (graph.n_poses, graph.n_landmarks, graph.n_bearing, graph.n_odometry)
    flops, bytes_ = schur_step_model(*dims)
    roof = roofline_report(flops, bytes_, seconds_per_iter, spec)
    roof["useful_flops_util"] = round(
        useful_step_flops(*dims) / seconds_per_iter / spec.peak_flops_f32, 6)
    return roof


def run(device=None, g2o=None, spec=None) -> tuple[dict, dict]:
    """The headline on ``device`` (default ``cuda``; raises without it).

    Returns (the JSON record, details: the best seconds, every run's
    seconds, the final graph).  ``spec`` (a ``roofline.ChipSpec``) sets
    the peaks the roofline reads; on the card it defaults to
    ``chip_spec()``, on the CPU there is none and the roofline is null.
    Raises ``AssertionError`` when the converged chi2 misses its
    reference."""
    import torch

    import boslam_torch  # noqa: F401  (full-f32 matmul precision)
    from boslam_torch.config import SolverConfig
    from boslam_torch.device import resolve_device
    from boslam_torch.graph.build import build_graph
    from boslam_torch.solver.optimizer import _fused_step_applicable, solve
    from boslam_torch.utils.roofline import chip_spec

    dev = resolve_device(device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {dev} ({card})")
    parsed, source = load_graph(g2o)
    graph, _ = build_graph(parsed, init="triangulate", device=dev)
    cfg = SolverConfig(iters=ITERS, linear_solver="schur")
    log(f"graph: {source}, {graph.n_poses} poses, {graph.n_landmarks} landmarks; "
        f"whole-step kernel: {_fused_step_applicable(graph, cfg)}")

    # the kernel build and first run, excluded
    t0 = time.perf_counter()
    out, _ = solve(graph, cfg)
    sync(dev)
    first_s = time.perf_counter() - t0
    log(f"first run (kernel build included): {first_s:.2f} s")

    chi2 = final_chi2(out, cfg)
    if source == DATASET:
        ref, ref_name, rtol = REF_CHI2, "C++ reference optimum", REF_RTOL
    else:
        graph_cpu, _ = build_graph(parsed, init="triangulate", device="cpu")
        ref, ref_name, rtol = final_chi2(solve(graph_cpu, cfg)[0], cfg), "port CPU solve", CPU_RTOL
    rel = abs(chi2 - ref) / ref
    log(f"converged chi2_robust: {chi2:.6f} ({ref_name}: {ref:.6f}, rel {rel:.2e})")
    if not rel < rtol:
        raise AssertionError(f"converged chi2 {chi2} misses the {ref_name} {ref} "
                             f"(rel {rel:.2e} >= {rtol})")

    times = best_of(lambda: solve(graph, cfg), dev)
    best = min(times)
    iters_per_s = ITERS / best
    log(f"timed runs: {[f'{t * 1e3:.2f}ms' for t in times]} -> {iters_per_s:.0f} iters/s")

    if spec is None and dev.type == "cuda":
        spec = chip_spec()
    roof = None if spec is None else headline_roofline(graph, best / ITERS, spec)
    log(f"roofline: {roof}")
    baseline = reference_baseline()
    rec = {
        "metric": "ba_gn_iterations_per_second_full_dataset",
        "value": round(iters_per_s, 1),
        "unit": "iters/s",
        "vs_baseline": round(iters_per_s / baseline, 1),
        "roofline_util": None if roof is None else roof["roofline_util"],
        "roofline": roof,
        "device": card,
        "graph": source,
        "chi2_check": {"chi2": chi2, "reference": ref, "reference_is": ref_name, "rel": rel,
                       "bound": rtol, "passed": True},
        "first_run_s": round(first_s, 4),
    }
    return rec, {"best_s": best, "times_s": times, "graph": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m boslam_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--g2o", default=None, help="a g2o file in place of the reference dataset")
    args = ap.parse_args(argv)
    rec, _ = run(args.device, args.g2o)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
