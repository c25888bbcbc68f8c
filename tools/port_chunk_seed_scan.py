#!/usr/bin/env python3
"""How far f32 whole steps land from the f64 step on the chunk-test family.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/port_chunk_seed_scan.py [--seeds 8]

The family of ``tests/test_torch_gn_step.py::test_more_odometry_than_bearing_chunk``:
``generate_sequence(301, 141, seed)`` triangulated by the JAX package, with
only the bearing edges of every tenth pose.  For each seed takes one GN
step (damping 1, robust threshold) with the JAX package's unfused Schur
and dense steps, the port's unfused Schur and dense steps, and the port's
plain whole step under several orders of the blocked Cholesky sums, and
prints each step's largest distance from the same step solved in f64 (the
port's dense path on f64 tensors), for poses and landmarks, then each
whole step's ratio to the farthest JAX step.  The orders: ``port``, the
plain version as it is (32-wide tiles, tile inverses by ``tri_inv``,
recursive to 8x8); ``t32_b32``, 32-wide tiles inverted by one 32-row
substitution (the kernel's order); ``t64_trsm``, 64-wide tiles inverted by
``solve_triangular``; ``t64_b32``; ``t128_b8``, the JAX kernel's tile and
inverse.  The JAX whole-step kernel cannot run this family (its odometry
block does not fit its bearing chunk).  Needs JAX; CPU only.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.ops import cholesky as chol
from boslam_torch.ops import schur_solve
from boslam_torch.solver import optimizer


def _tri_inv(L, base):
    """tri_inv with another base block (base == n: one substitution)."""
    n, h = L.shape[0], base
    Lb = chol._diag_blocks(L, h)
    X = torch.eye(h, dtype=L.dtype).repeat(Lb.shape[0], 1, 1)
    for j in range(h):
        X[:, j] /= Lb[:, j, j, None]
        X[:, j + 1:] -= Lb[:, j + 1:, j, None] * X[:, None, j]
    while h < n:
        A, C = X[0::2], X[1::2]
        Bl = chol._diag_blocks(L, 2 * h)[:, h:, :h]
        X = torch.cat([torch.cat([A, torch.zeros_like(A)], 2),
                       torch.cat([-(C @ (Bl @ A)), C], 2)], 1)
        h *= 2
    return X[0]


def _blocked_factor(tile, invert):
    """blocked_factor over ``tile``-wide tiles with ``invert`` for the tile inverse."""
    def factor(L):
        n, inverses = L.shape[0], []
        for k0 in range(0, n, tile):
            k1 = k0 + tile
            Lkk = chol._factor_tile(L[k0:k1, k0:k1])
            Linv = invert(Lkk)
            inverses.append(Linv)
            L[k0:k1, k0:k1] = Lkk
            if k1 < n:
                P = L[k1:, k0:k1] @ Linv.T
                L[k1:, k0:k1] = P
                L[k1:, k1:] -= P @ P.T
        return inverses
    return factor


def _trsm(L):
    return torch.linalg.solve_triangular(L, torch.eye(L.shape[0]), upper=False)


# name: (tile, factorization); blocked_substitute reads the tile from chol.TILE
ORDERS = {
    "port": (chol.TILE, chol.blocked_factor),
    "t32_b32": (32, _blocked_factor(32, lambda L: _tri_inv(L, 32))),
    "t64_trsm": (64, _blocked_factor(64, _trsm)),
    "t64_b32": (64, _blocked_factor(64, lambda L: _tri_inv(L, 32))),
    "t128_b8": (128, _blocked_factor(128, lambda L: _tri_inv(L, 8))),
}


def _graphs(seed):
    import jax

    from boslam.graph.build import build_graph as build_graph_jax
    from boslam.synth import generate_sequence

    ig, _ = generate_sequence(301, 141, seed=seed)
    gj, _ = build_graph_jax(ig, init="triangulate")
    arrays = {k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()}
    keep = arrays["b_pose"] % 10 == 0
    for k in ("b_pose", "b_lm", "b_meas", "b_omega"):
        arrays[k] = arrays[k][keep]
    gj = type(gj)(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    return FactorGraph.from_numpy(arrays, device="cpu"), gj


def _f64(g):
    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).double() for f in dataclasses.fields(g)
        if getattr(g, f.name).is_floating_point()})


def scan(seeds):
    import jax

    from boslam.config import SolverConfig as SolverConfigJax
    from boslam.solver import optimizer as optimizer_jax

    cfg = SolverConfig(linear_solver="schur", fused_step="force")
    cfg_j = SolverConfigJax(linear_solver="schur", fused_step="off")
    real = chol.TILE, schur_solve.blocked_factor
    for seed in range(seeds):
        g, gj = _graphs(seed)
        steps = {
            "jax_schur": jax.jit(lambda x: optimizer_jax.gn_step(x, cfg_j))(gj)[0],
            "jax_dense": jax.jit(lambda x: optimizer_jax.gn_step(
                x, cfg_j.replace(linear_solver="dense")))(gj)[0],
            "port_schur": optimizer.gn_step(g, cfg.replace(fused_step="off"))[0],
            "port_dense": optimizer.gn_step(
                g, cfg.replace(fused_step="off", linear_solver="dense"))[0],
        }
        try:
            for name, (chol.TILE, schur_solve.blocked_factor) in ORDERS.items():
                steps[name] = optimizer.gn_step(g, cfg)[0]
        finally:
            chol.TILE, schur_solve.blocked_factor = real
        x64 = optimizer.gn_step(_f64(g), cfg.replace(linear_solver="dense", fused_step="off"))[0]
        for k in ("poses", "landmarks"):
            ref = getattr(x64, k).numpy()
            d = {n: float(np.abs(np.asarray(getattr(s, k)) - ref).max()) for n, s in steps.items()}
            far = max(d["jax_schur"], d["jax_dense"])
            print(f"seed {seed} {k}: " + " ".join(f"{n} {v:.3e}" for n, v in d.items())
                  + " | / farthest JAX: " + " ".join(f"{n} {d[n] / far:.2f}" for n in ORDERS),
                  flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    torch.set_num_threads(2)  # as the tests run it
    scan(ap.parse_args().seeds)
