"""How reproducible the packed and flat CG traces are under a change of
summation order, on the CPU: the port's runs of one graph in two orderings
of the same sums, and (``--jax``) the JAX package's own runs beside them.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/port_packed_scan.py [--jax] [--what ...]

``corridor``: generate_sequence(10000, 3900, seed, turn_every=10**9) for
seeds 0-6 (``--seeds``), GN packed 10 iterations, "auto" (btridiag) or
``--preconditioner`` (with ``--two-level-cycle``; "bband" at its default
width 8), with f32 or ``--coupling-dtype bfloat16`` blocks: windowed against
take (the windowed path relabels the landmarks, so every landmark-keyed
sum runs in another order).  ``big``: the 100k corridor, 5 iterations,
"auto" (block-Jacobi), windowed against take, and the CG breakdown flags.
``walk``: the default walk at 10k, seed 3, GN and LM packed with and
without hot-landmark splitting, flat schur_cg against packed.  ``lm``: the
600-pose corridor of tests/test_torch_packed.py, 5 LM trials, windowed
against take.  ``--jax`` adds the JAX package's runs (its windowed gather
in Pallas interpret mode, so ``lm`` only; take at 10k and 100k).

Prints one line per comparison: the relative chi2 gap per iteration.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np
import torch


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.array2string(np.abs(a - b) / np.abs(b), max_line_width=200,
                           formatter={"float_kind": lambda x: f"{x:.1e}"})


def _graph(n, nl, seed, **kw):
    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(n, nl, seed=seed, **kw)
    return build_graph(ig, init="triangulate", device="cpu")[0]


def _jax_graph(g):
    import jax.numpy as jnp

    from boslam.graph.data import FactorGraph as FactorGraphJax

    return FactorGraphJax(**{
        f.name: jnp.asarray(getattr(g, f.name).numpy().astype(
            np.int32 if getattr(g, f.name).dtype == torch.int64 else np.float32))
        for f in dataclasses.fields(g)})


def _packed(g, **kw):
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver.optimizer import solve_packed

    st = solve_packed(g, SolverConfig(linear_solver="schur_cg", **kw))[1]
    return {k: v.numpy() for k, v in st.items()}


def _packed_jax(g, **kw):
    from boslam.config import SolverConfig as SolverConfigJax
    from boslam.solver.optimizer import solve_packed as solve_packed_jax

    st = solve_packed_jax(_jax_graph(g), SolverConfigJax(linear_solver="schur_cg", **kw))[1]
    return {k: np.asarray(v) for k, v in st.items()}


def corridor(jax, seeds=range(7), **kw):
    for seed in seeds:
        g = _graph(10000, 3900, seed, turn_every=10**9)
        w = _packed(g, gather="windowed", iters=10, **kw)
        t = _packed(g, gather="take", iters=10, **kw)
        print(f"corridor 10k seed {seed} {kw}: windowed vs take {_rel(w['chi2_robust'], t['chi2_robust'])}; "
              f"cg_iters {w['cg_iters'].tolist()}, rel res^2 "
              f"{np.array2string(w['cg_rel_res2'], precision=1, max_line_width=200)}", flush=True)
        if jax and seed in (2, 3):
            j = _packed_jax(g, gather="take", iters=10)
            print(f"  JAX take vs port take {_rel(t['chi2_robust'], j['chi2_robust'])}; JAX rel res^2 "
                  f"{np.array2string(j['cg_rel_res2'], precision=1, max_line_width=200)}", flush=True)


def big(jax, seeds=None, **kw):
    g = _graph(100000, 39000, 3, turn_every=10**9)
    w, t = _packed(g, gather="windowed", iters=5, **kw), _packed(g, gather="take", iters=5, **kw)
    print(f"corridor 100k seed 3 {kw}: windowed vs take {_rel(w['chi2_robust'], t['chi2_robust'])}; "
          f"cg_iters {w['cg_iters'].tolist()} / {t['cg_iters'].tolist()}, breakdown "
          f"{w['cg_breakdown'].astype(int).tolist()} / {t['cg_breakdown'].astype(int).tolist()}",
          flush=True)
    if jax:
        j = _packed_jax(g, gather="take", iters=5)
        print(f"  JAX take vs port take {_rel(t['chi2_robust'], j['chi2_robust'])}; JAX cg_iters "
              f"{np.asarray(j['cg_iters']).tolist()}, breakdown "
              f"{np.asarray(j['cg_breakdown']).astype(int).tolist()}", flush=True)


def walk(jax, seeds=None, **kw):
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver.optimizer import solve

    g = _graph(10000, 3900, 3)
    for opt in ("gn", "lm"):
        a = _packed(g, optimizer=opt, iters=10)
        b = _packed(g, optimizer=opt, iters=10, lm_split=0)
        print(f"walk 10k seed 3 {opt}: split vs unsplit {_rel(a['chi2_robust'], b['chi2_robust'])}",
              flush=True)
        if opt == "gn":
            f = {k: v.numpy() for k, v in solve(g, SolverConfig(linear_solver="schur_cg",
                                                                iters=10))[1].items()}
            print(f"walk 10k seed 3 gn: flat vs packed {_rel(f['chi2_robust'], a['chi2_robust'])}",
                  flush=True)


def lm(jax, seeds=None, **kw):
    g = _graph(600, 240, 3, turn_every=10**9)
    w, t = _packed(g, gather="windowed", optimizer="lm", iters=5), _packed(g, gather="take",
                                                                           optimizer="lm", iters=5)
    print(f"corridor 600 LM: port windowed vs take {_rel(w['chi2_robust'], t['chi2_robust'])}",
          flush=True)
    if jax:
        jw = _packed_jax(g, gather="windowed", optimizer="lm", iters=5)
        jt = _packed_jax(g, gather="take", optimizer="lm", iters=5)
        print(f"  JAX windowed vs JAX take {_rel(jw['chi2_robust'], jt['chi2_robust'])}; "
              f"port vs JAX, take {_rel(t['chi2_robust'], jt['chi2_robust'])}, windowed "
              f"{_rel(w['chi2_robust'], jw['chi2_robust'])}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--what", nargs="+", default=["lm", "corridor", "big", "walk"],
                    choices=["lm", "corridor", "big", "walk"])
    ap.add_argument("--jax", action="store_true", help="run the JAX package beside the port")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(7)),
                    help="corridor: the seeds to scan")
    ap.add_argument("--preconditioner", default="auto",
                    help="corridor, big: the PCG preconditioner")
    ap.add_argument("--two-level-cycle", default="additive")
    ap.add_argument("--coupling-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="corridor, big: the coupling blocks' storage")
    args = ap.parse_args()
    logging.disable(logging.WARNING)
    kw = {}
    if args.preconditioner != "auto":
        kw = dict(preconditioner=args.preconditioner, two_level_cycle=args.two_level_cycle)
    if args.coupling_dtype != "float32":
        kw["coupling_dtype"] = args.coupling_dtype
    for what in args.what:
        globals()[what](args.jax, seeds=args.seeds, **kw)


if __name__ == "__main__":
    main()
