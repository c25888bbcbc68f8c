"""Data-parallel bundle adjustment: edges sharded over the ranks (port of
``boslam/parallel/sharded.py``).

Layout:

- the state (poses, landmarks) is replicated on every rank: it is small
  next to the edges, and every edge reads it at random;
- the edge arrays (measurements, indices, information) are split over the
  ranks along the edge axis, padded with zero-information dummies;
- the normal-equation sums are per-rank partials completed by ``psum``
  (``solver/normal_eq.py``, ``solver/schur.py``), after which the linear
  solve runs replicated on every rank (the Cholesky kernel on the card
  under ``linear_solver="dense"`` and ``"schur"``; the Schur and
  whole-step kernels are off under a mesh, as in the JAX package), and
  the boxplus update keeps the state replicated.

The JAX package runs the whole solve as one ``shard_map``-ed jit; here
each rank runs ``optimizer.solve_loop`` with the mesh.
"""

from __future__ import annotations

import dataclasses

import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.parallel.mesh import Mesh, make_mesh, put_sharded
from boslam_torch.solver.optimizer import solve_loop

EDGE_FIELDS = ("b_pose", "b_lm", "b_meas", "b_omega", "o_src", "o_dst", "o_meas", "o_omega")


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def pad_edges(g: FactorGraph, k: int) -> FactorGraph:
    """Pad the edge arrays to multiples of ``k`` with zero-information
    dummies at vertex 0: omega = 0, so they add exactly nothing to H, b or
    any chi2 statistic, and every shard has the same number of edges."""
    def up(n):
        return ((n + k - 1) // k) * k

    nb, no = up(g.n_bearing), up(g.n_odometry)
    return dataclasses.replace(g, **{
        f: _pad_rows(getattr(g, f), nb if f.startswith("b_") else no) for f in EDGE_FIELDS})


def shard_graph(g: FactorGraph, mesh: Mesh) -> FactorGraph:
    """This rank's graph: the state replicated, the padded edge arrays'
    block of rows, on the rank's device."""
    g = pad_edges(g, mesh.size)
    return FactorGraph(**{
        f.name: put_sharded(getattr(g, f.name), mesh) if f.name in EDGE_FIELDS
        else getattr(g, f.name).to(mesh.device)
        for f in dataclasses.fields(g)})


def make_sharded_solve(mesh: Mesh, cfg: SolverConfig, lam0: float | None = None):
    """The solve of a rank's graph (``shard_graph``): graph -> (graph', stats).

    Every collective is a psum of ``solve_loop(mesh=...)``.  ``lam0``
    restores the LM damping on resume.
    """
    def _solve(graph: FactorGraph):
        lam = None if lam0 is None else torch.full((), lam0, dtype=graph.poses.dtype,
                                                   device=graph.device)
        return solve_loop(graph, cfg, lam0=lam, mesh=mesh)

    return _solve


def sharded_solve(g: FactorGraph, cfg: SolverConfig, mesh: Mesh | None = None,
                  lam0: float | None = None):
    """One-shot: shard ``g`` over ``mesh`` (default: every rank of the
    group, or a one-rank group on ``g``'s device), solve, and return ``g``
    with the optimized state, the same on every rank, and the stats."""
    if mesh is None:
        mesh = make_mesh(g.device)
    out, stats = make_sharded_solve(mesh, cfg, lam0)(shard_graph(g, mesh))
    return g.with_state(out.poses.to(g.device), out.landmarks.to(g.device)), stats
