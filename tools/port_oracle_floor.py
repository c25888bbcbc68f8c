"""How far f32 rounding alone puts the dense GN from the f64 oracle, on the
CPU: the port's ``solve`` (GN, dense) from a triangulated start and from
starts whose landmarks differ from it by a few f32 ulps, each against
``tests/reference_oracle.py`` run from the same start, and (``--jax``) the
JAX package's ``solve`` beside it.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/port_oracle_floor.py [--jax] [--starts N]

The default graph is the 120x60-seed5-3lc case of
``tests/test_torch_reference_oracle.py`` (generate_sequence(120, 60,
seed=5, loop_closures=3), ``build_graph(init="triangulate")``, 10
iterations), whose pose bound is atol 2e-4.  Start 0 is the build's own;
start k > 0 adds to every landmark coordinate an integer number of f32
ulps drawn from [-2, 2] (``np.random.default_rng(0)``).  The port is also
run on the same start with every float field in f64 (``port_f64``): its
gap is the port's arithmetic against the oracle's, rounding aside.

Prints one line per start: the largest pose gap of each run, and at the
end how many starts each run keeps within ``--bound``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np
import torch


def _f64(g):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name).double()
                                     for f in dataclasses.fields(g)
                                     if getattr(g, f.name).is_floating_point()})


def _jax_poses(ig, landmarks, iters):
    import jax.numpy as jnp

    from boslam.config import SolverConfig as SolverConfigJax
    from boslam.graph.build import build_graph as build_graph_jax
    from boslam.solver.optimizer import solve as solve_jax

    gj, _ = build_graph_jax(ig, init="triangulate")
    gj = dataclasses.replace(gj, landmarks=jnp.asarray(landmarks))
    return np.asarray(solve_jax(gj, SolverConfigJax(iters=iters))[0].poses)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graph", type=int, nargs=4, default=[120, 60, 5, 3],
                    metavar=("POSES", "LANDMARKS", "SEED", "CLOSURES"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--starts", type=int, default=20)
    ap.add_argument("--bound", type=float, default=2e-4, help="the pose atol to count against")
    ap.add_argument("--jax", action="store_true", help="run the JAX package beside the port")
    args = ap.parse_args()
    logging.disable(logging.WARNING)

    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.solver.optimizer import solve
    from boslam_torch.synth import generate_sequence
    from tests.reference_oracle import oracle_gn_iterations

    n_poses, n_landmarks, seed, closures = args.graph
    ig, _ = generate_sequence(n_poses, n_landmarks, seed=seed, loop_closures=closures)
    g0, _ = build_graph(ig, init="triangulate", device="cpu")
    rng = np.random.default_rng(0)
    cfg = SolverConfig(iters=args.iters)
    within = {}
    for k in range(args.starts):
        lm = g0.landmarks.numpy()
        if k:
            ulps = rng.integers(-2, 3, lm.shape) * np.spacing(np.abs(lm))
            lm = (lm + ulps).astype(np.float32)
        g = dataclasses.replace(g0, landmarks=torch.from_numpy(lm))
        op, _, _ = oracle_gn_iterations(
            *(x.numpy() for x in (g.poses, g.landmarks, g.b_pose, g.b_lm, g.b_meas, g.b_omega,
                                  g.o_src, g.o_dst, g.o_meas, g.o_omega)),
            int(g.fixed_pose_ix), args.iters)
        runs = {"port": solve(g, cfg)[0].poses.numpy(),
                "port_f64": solve(_f64(g), cfg)[0].poses.numpy()}
        if args.jax:
            runs["jax"] = _jax_poses(ig, lm, args.iters)
        gaps = {name: float(np.abs(p - op).max()) for name, p in runs.items()}
        for name, gap in gaps.items():
            within[name] = within.get(name, 0) + (gap <= args.bound)
        print(f"start {k}: pose gap to the oracle " + " ".join(
            f"{name} {gap:.3e}" for name, gap in gaps.items()), flush=True)
    print(f"within {args.bound:g} in {args.starts} starts: " + " ".join(
        f"{name} {n}" for name, n in within.items()))


if __name__ == "__main__":
    main()
