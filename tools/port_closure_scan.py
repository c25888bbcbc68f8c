#!/usr/bin/env python3
"""Which loop-closure graphs the port's GN converges on, on the CPU.

    PYTHONPATH=. python tools/port_closure_scan.py [--seeds 30] [--iters 50] [--probe SEED]
    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/port_closure_scan.py --jax-kernel SEED [--iters 50]

For each seed of ``generate_sequence(301, 141, seed, loop_closures=4)``
runs ``--iters`` GN iterations of the exact-Schur path twice with the
PyTorch port: the whole step (``fused_step="force"``, its plain version)
and the unfused path (``fused_step="off"``).  Prints one line per seed:
both final chi2_robust values, their relative gap, the relative change
of the last iteration, whether every step was finite (spd_ok) and the
first failed iteration.  ``--probe SEED`` steps three GN runs of that
seed side by side up to the whole step's first failed iteration: the
whole step, the unfused path, and the dense path on f64 tensors; it
prints each one's spd_ok and delta_norm per iteration, then the least
and largest eigenvalue of the reduced matrix S at the failed iterate,
formed in f64 from the f32 inputs the step solves, and the largest entry
of Hll^-1.  ``--jax-kernel SEED`` steps the JAX package's whole-step
kernel (interpret mode) beside the port's whole step on that seed's graph
and, where the port's step first fails, runs the JAX kernel from the
port's state too; it needs JAX.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.build import build_graph
from boslam_torch.solver import optimizer, schur
from boslam_torch.solver.normal_eq import edge_terms
from boslam_torch.synth import generate_sequence


def _graph(seed):
    ig, _ = generate_sequence(301, 141, seed=seed, loop_closures=4)
    return build_graph(ig, init="triangulate", device="cpu")[0]


def scan(seeds, iters):
    cfg = SolverConfig(linear_solver="schur", iters=iters)
    for seed in range(seeds):
        g = _graph(seed)
        _, sf = optimizer.solve(g, cfg.replace(fused_step="force"))
        _, su = optimizer.solve(g, cfg.replace(fused_step="off"))
        cf, cu = sf["chi2_robust"].numpy(), su["chi2_robust"].numpy()
        ok = sf["spd_ok"].numpy()
        first_fail = int(np.argmin(ok)) if not ok.all() else None
        print(f"seed {seed}: whole step {cf[-1]:.7f}, unfused {cu[-1]:.7f}, "
              f"rel {abs(cf[-1] - cu[-1]) / cu[-1]:.2e}, last change "
              f"{abs(cf[-1] - cf[-2]) / cf[-1]:.2e}, spd_ok whole/unfused "
              f"{bool(ok.all())}/{bool(su['spd_ok'].all())}, first failed step {first_fail}",
              flush=True)


def probe(seed, iters):
    cfg = SolverConfig(linear_solver="schur", fused_step="force")
    g = _graph(seed)
    g64 = dataclasses.replace(g, **{f.name: getattr(g, f.name).double()
                                    for f in dataclasses.fields(g)
                                    if getattr(g, f.name).is_floating_point()})
    runs = {"whole step": (g, cfg), "unfused": (g, cfg.replace(fused_step="off")),
            "f64 dense": (g64, cfg.replace(linear_solver="dense", fused_step="off"))}
    for i in range(iters):
        line = []
        for name, (gi, ci) in runs.items():
            g2, st = optimizer.gn_step(gi, ci)
            runs[name] = (g2, ci)
            line.append(f"{name} spd_ok {bool(st['spd_ok'])} delta_norm "
                        f"{float(st['delta_norm']):.4f}")
            if name == "whole step":
                failed, chi2 = not bool(st["spd_ok"]), float(st["chi2_robust"])
        print(f"seed {seed} iteration {i}: " + "; ".join(line))
        if failed:
            break
    else:
        print(f"seed {seed}: no failed step in {iters} iterations")
        return
    g = runs["whole step"][0]  # a failed step keeps the state
    terms = edge_terms(g, cfg)
    mask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    Hpp, U, Hb, bp, bl, m = (t.double() for t in
                             schur.fused_schur_inputs(g, cfg, cfg.damping, terms, mask))
    S = (Hpp - U @ torch.block_diag(*Hb) @ U.T) * (m[:, None] * m[None, :]) + torch.diag(1 - m)
    ev = torch.linalg.eigvalsh(S)
    print(f"seed {seed}: first failed step {i}, chi2_robust {chi2:.7f}; "
          f"S in f64 from the f32 inputs: least eigenvalue {ev[0].item():.4e}, "
          f"largest {ev[-1].item():.4e}; max |Hll^-1| {Hb.abs().max().item():.2f}")


def against_jax_kernel(seed, iters):
    """The JAX package's whole-step kernel (Pallas, interpret mode, about a
    minute a step at this size) and the port's whole step (plain version),
    side by side from the same graph built by the JAX package.  Where the
    port's step first fails, the JAX kernel also takes one step from the
    port's state.  Needs JAX; the port itself never imports it."""
    import time

    import jax.numpy as jnp

    from boslam.config import SolverConfig as SolverConfigJax
    from boslam.graph.build import build_graph as build_graph_jax
    from boslam.ops import pallas_gn_step
    from boslam.synth import generate_sequence as generate_sequence_jax
    from boslam_torch.graph.data import FactorGraph

    ig, _ = generate_sequence_jax(301, 141, seed=seed, loop_closures=4)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    cfg = SolverConfig(linear_solver="schur", fused_step="force")
    cfg_j = SolverConfigJax(linear_solver="schur")

    def jax_step(gj_):
        t0 = time.perf_counter()
        gj2, st = pallas_gn_step.fused_gn_step(gj_, cfg_j, interpret=True)
        return gj2, st, time.perf_counter() - t0

    gj_start, port_failed, jax_failed = gj, False, 0
    for i in range(iters):
        line = [f"seed {seed} iteration {i}:"]
        if jax_failed < 2:
            gj, st, secs = jax_step(gj)
            jax_failed = 0 if bool(st["spd_ok"]) else jax_failed + 1
            line.append(f"JAX kernel spd_ok {bool(st['spd_ok'])} chi2_robust "
                        f"{float(st['chi2_robust']):.7f} delta_norm "
                        f"{float(st['delta_norm']):.4f} ({secs:.0f} s);")
        else:  # failed twice from the same kept state: it repeats from here on
            line.append("JAX kernel: its state is kept;")
        g2, st = optimizer.gn_step(g, cfg)
        line.append(f"port whole step spd_ok {bool(st['spd_ok'])} chi2_robust "
                    f"{float(st['chi2_robust']):.7f} delta_norm {float(st['delta_norm']):.4f}")
        if not (port_failed or bool(st["spd_ok"])):
            port_failed = True
            at = dataclasses.replace(gj_start, poses=jnp.asarray(g.poses.numpy()),
                                     landmarks=jnp.asarray(g.landmarks.numpy()))
            _, st_at, _ = jax_step(at)
            line.append(f"; the JAX kernel from the port's state: spd_ok "
                        f"{bool(st_at['spd_ok'])} delta_norm {float(st_at['delta_norm']):.4f}")
        g = g2
        print(" ".join(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=30)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--probe", type=int, default=None)
    ap.add_argument("--jax-kernel", type=int, default=None, metavar="SEED")
    args = ap.parse_args()
    if args.jax_kernel is not None:
        against_jax_kernel(args.jax_kernel, args.iters)
    elif args.probe is not None:
        probe(args.probe, args.iters)
    else:
        scan(args.seeds, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
