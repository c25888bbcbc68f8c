#!/usr/bin/env python3
"""How far one whole GN step lands from the same step in f64, on the card.

    PYTHONPATH=. python tools/gn_step_accuracy.py [--seeds 10] [--closures 0]

For each seed of ``generate_sequence(301, 141, seed, loop_closures)``
(graph built on the CPU, so every run starts from the same bits) takes one
step from the initial state five ways: the whole-step kernel, its plain
version on the card and on the CPU, and the unfused Schur path on the card
and on the CPU.  Prints each one's largest distance from the f64 step (the
port's dense path on f64 tensors), and how far the kernel's and the card's
unfused path's f32 inputs of the Schur solve (Hpp, U, Hll^-1, bp, bl) lie
from the same inputs assembled in f64, each relative to its largest entry.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch


def _f64(g):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name).double()
                                     for f in dataclasses.fields(g)
                                     if getattr(g, f.name).is_floating_point()})


def _dist(a, b):
    return (a.double().cpu() - b.double().cpu()).abs().max().item()


def _rel(a, ref):
    return _dist(a, ref) / ref.abs().max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--closures", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import boslam_torch  # noqa: F401  (full-f32 matmul precision)
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.ops import gn_step as gs
    from boslam_torch.solver import schur
    from boslam_torch.solver.normal_eq import edge_terms
    from boslam_torch.solver.optimizer import gn_step
    from boslam_torch.synth import generate_sequence

    cfg = SolverConfig(linear_solver="schur")
    for seed in range(args.seeds):
        ig, _ = generate_sequence(301, 141, seed=seed, loop_closures=args.closures)
        g_cpu = build_graph(ig, init="triangulate", device="cpu")[0]
        g = g_cpu.to("cuda")
        x64, _ = gn_step(_f64(g_cpu), cfg.replace(linear_solver="dense", fused_step="off"))
        prep = gs.prep_static(g)
        poses, lms = g.poses.clone(), g.landmarks.clone()
        kern = gs.GNStepKernel(prep, poses, lms, cfg)
        kern.step(torch.zeros(gs.STATS_WIDTH, device="cuda"))
        steps = {"kernel": (poses, lms)}
        p, l, _ = gs.fused_gn_step_plain(prep, g.poses, g.landmarks, cfg)
        steps["plain card"] = (p, l)
        p, l, _ = gs.fused_gn_step_plain(gs.prep_static(g_cpu), g_cpu.poses, g_cpu.landmarks, cfg)
        steps["plain cpu"] = (p, l)
        for dev, gg in (("card", g), ("cpu", g_cpu)):
            gu, _ = gn_step(gg, cfg.replace(fused_step="off"))
            steps[f"unfused {dev}"] = (gu.poses, gu.landmarks)
        err = {k: max(_dist(P, x64.poses), _dist(L, x64.landmarks)) for k, (P, L) in steps.items()}

        # the inputs of the Schur solve: the kernel's buffers, the unfused
        # path's on the card, both against the f64 assembly
        def inputs(gg):
            mask = schur._pose_mask(gg.n_poses, gg.fixed_pose_ix, gg.poses.dtype)
            return schur.fused_schur_inputs(gg, cfg, cfg.damping, edge_terms(gg, cfg), mask)

        Hpp64, U64, Hb64, bp64, bl64, _ = inputs(_f64(g_cpu))
        k = kern._keep
        n3 = 3 * g.n_poses
        Hpp_k = k["Hpp"].clone()
        Hpp_k[:n3, :n3] += cfg.damping * torch.eye(n3, device="cuda")
        Hpp_u, U_u, Hb_u, bp_u, bl_u, _ = inputs(g)
        pieces = {
            "kernel": dict(Hpp=_rel(Hpp_k, Hpp64), U=_rel(k["U"], U64), Hb=_rel(k["Hb"], Hb64),
                           bp=_rel(k["bp"], bp64), bl=_rel(k["bl"], bl64)),
            "unfused card": dict(Hpp=_rel(Hpp_u, Hpp64), U=_rel(U_u, U64), Hb=_rel(Hb_u, Hb64),
                                 bp=_rel(bp_u, bp64), bl=_rel(bl_u, bl64)),
        }
        print(json.dumps(dict(seed=seed, closures=args.closures, err_vs_f64=err,
                              inputs_rel_err=pieces)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
