"""Data-parallel packed bundle adjustment: the scale path on several ranks
(port of ``boslam/parallel/sharded_packed.py``).

Layout:

- the state, the per-vertex blocks and the CG vectors are replicated;
- the pose-packed slot grid [NP, K] is split along its slot axis K (each
  rank holds K/D slots of every pose), so a per-pose sum over slots is a
  local partial and one psum; the landmark grid [NLV, K2] likewise along
  K2 (the virtual-row map ``l_virt`` is replicated);
- odometry edges are split along the edge axis and take the general
  gather/segment-sum path with global pose ids;
- each CG matvec completes the reduced-system products with two psums
  (``schur_packed.packed_s_matvec``).

The edges are packed without windowed-gather plans, as in the JAX package,
so the gather kernel is not used here.
"""

from __future__ import annotations

import dataclasses

import torch

from boslam_torch.config import SolverConfig
from boslam_torch.device import host_sync
from boslam_torch.graph.data import FactorGraph
from boslam_torch.graph.packed import PackedEdges, pack_edges
from boslam_torch.parallel.mesh import Mesh, make_mesh, put_sharded
from boslam_torch.parallel.sharded import shard_graph

_P_GRIDS = ("p_lm", "p_meas", "p_omega")
_L_GRIDS = ("l_pose", "l_meas", "l_omega")


def pad_packed(pk: PackedEdges, k: int) -> PackedEdges:
    """Pad both slot axes (K, K2) up to multiples of ``k``, and to at least
    ``k``: padding slots carry omega = 0 and index 0, so they add exactly
    zero, as the flat edge padding does."""
    def up(n):
        return max(k, ((n + k - 1) // k) * k)

    def pad_cols(x, n):
        return torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1]))], dim=1)

    K, K2 = up(pk.K), up(pk.K2)
    return dataclasses.replace(
        pk, **{f: pad_cols(getattr(pk, f), K) for f in _P_GRIDS},
        **{f: pad_cols(getattr(pk, f), K2) for f in _L_GRIDS})


def shard_packed(g: FactorGraph, pk: PackedEdges, mesh: Mesh):
    """This rank's (graph, packed edges): the graph as ``shard_graph``
    places it, the padded grids' block of slot columns, ``l_virt``
    replicated, on the rank's device."""
    if pk.p_plan is not None or pk.l_plan is not None:
        raise ValueError("the sharded packed layout gathers plainly; pack without windows")
    pk = pad_packed(pk, mesh.size)
    grids = {f: put_sharded(getattr(pk, f), mesh, dim=1) for f in _P_GRIDS + _L_GRIDS}
    virt = None if pk.l_virt is None else pk.l_virt.to(mesh.device)
    return shard_graph(g, mesh), dataclasses.replace(pk, **grids, l_virt=virt)


def make_sharded_packed_solve(mesh: Mesh, cfg: SolverConfig, lam0: float | None = None,
                              dp0=None, start_iter: int = 0):
    """The packed solve of a rank's (graph, packed edges), GN or LM through
    ``packed_solve_loop``: (graph, pk) -> (graph', stats).  LM's cost test
    psums over the ranks.  ``lam0`` restores the LM damping, ``dp0`` the
    warm-start delta [NP, 3] and ``start_iter`` the GNC schedule's offset
    on resume; ``stats["dp_final"]`` is the outgoing delta (replicated)."""
    from boslam_torch.solver.optimizer import packed_solve_loop

    def _solve(graph: FactorGraph, pk: PackedEdges):
        dt, dev = graph.poses.dtype, graph.device
        lam = None if lam0 is None else torch.full((), lam0, dtype=dt, device=dev)
        d0 = None if dp0 is None else torch.as_tensor(dp0, dtype=dt).to(dev)
        return packed_solve_loop(graph, pk, cfg, lam0=lam, dp0=d0, start_iter=start_iter,
                                 mesh=mesh)

    return _solve


def sharded_packed_solve(g: FactorGraph, cfg: SolverConfig, mesh: Mesh | None = None,
                         lam0: float | None = None, dp0=None, start_iter: int = 0):
    """One-shot: pack ``g`` on the host (``cfg.lm_split``; no windows),
    shard over ``mesh`` (default: every rank of the group, or a one-rank
    group on ``g``'s device), solve, and return ``g`` with the optimized
    state, the same on every rank, and the stats."""
    if mesh is None:
        mesh = make_mesh(g.device)
    with host_sync(g.device):
        pk, _ = pack_edges(g, split_lm=cfg.lm_split)
    out, stats = make_sharded_packed_solve(mesh, cfg, lam0, dp0, start_iter)(
        *shard_packed(g, pk, mesh))
    return g.with_state(out.poses.to(g.device), out.landmarks.to(g.device)), stats
