"""Outer optimization loops: constant-damping GN and Levenberg-Marquardt
(port of ``boslam/solver/optimizer.py``).

The loop stays on the device: no ``.item()`` and no host sync inside the
iterations, apart from the CG loop's polls (``schur.poll``).  Per-iteration
stats are tensors, stacked at the end into one tensor per key with a
leading ``iters`` axis.  GN under the exact Schur solve takes the
whole-step path (``ops/gn_step.py``) where ``_fused_step_applicable``
admits the graph, as the JAX package does.  ``solve_packed`` runs the
dual-packed Schur+PCG scale path (``schur_packed.py``).

``mesh`` (``parallel/mesh.py``) runs a step, a loop or the packed loop on
an edge-sharded graph: the state is replicated, the edges are the rank's
shard, and the sums are completed by collectives, as the JAX package's
``axis_name`` does.  The whole-step path is off under a mesh, as there.
"""

from __future__ import annotations

import torch

from boslam_torch.config import SolverConfig
from boslam_torch.device import host_sync
from boslam_torch.geometry.se2 import boxplus_state
from boslam_torch.graph.data import FactorGraph
from boslam_torch.solver import gauss_newton as GN
from boslam_torch.solver.normal_eq import chi2_stats, edge_terms
from boslam_torch.solver.robust import robust_cost
from boslam_torch.utils.spans import count, span


def _check_ported(cfg: SolverConfig) -> None:
    cfg.check_ported()
    if cfg.fused_step not in ("auto", "off", "force"):
        raise ValueError(f"unknown fused_step {cfg.fused_step!r}")


def _fused_step_applicable(g: FactorGraph, cfg: SolverConfig) -> bool:
    """Gate for the whole-step path (mirror of the JAX package's gate, with
    "the graph is on CUDA" for "the backend is a TPU").  ``"force"`` passes
    the same gate first, then takes the path on any device: the CUDA kernel
    for a CUDA graph, its plain version for a CPU graph."""
    if cfg.fused_step == "off" or cfg.linear_solver != "schur":
        return False
    if cfg.use_autodiff_jacobians or cfg.robust not in ("threshold", "huber", "none"):
        return False
    from boslam_torch.ops.gn_step import fused_gn_fits

    if not fused_gn_fits(g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry):
        return False
    return cfg.fused_step == "force" or g.poses.is_cuda


def _build_and_solve(g: FactorGraph, cfg: SolverConfig, damping, band_tiles=None, mesh=None):
    if cfg.linear_solver == "dense":
        return GN.gn_build_and_solve(g, cfg, damping, mesh=mesh)
    if cfg.linear_solver in ("schur", "schur_cg"):
        from boslam_torch.solver import schur

        return schur.schur_build_and_solve(g, cfg, damping, band_tiles=band_tiles, mesh=mesh)
    raise ValueError(f"unknown linear_solver {cfg.linear_solver!r}")


def gn_step(g: FactorGraph, cfg: SolverConfig, band_tiles: int | None = None, mesh=None):
    """One constant-damping GN iteration.  ``band_tiles`` picks the route
    of the Schur kernel (``schur.kernel_band``, computed once per solve by
    ``solve_loop``) or of the whole step (``gn_step.tile_band``); None
    takes the dense route."""
    _check_ported(cfg)
    if mesh is None and _fused_step_applicable(g, cfg):
        from boslam_torch.ops.gn_step import fused_gn_step

        return fused_gn_step(g, cfg, band_tiles)
    dp, dl, terms, spd_ok, extra = _build_and_solve(g, cfg, cfg.damping, band_tiles, mesh)
    poses, landmarks = boxplus_state(g.poses, g.landmarks, dp, dl)
    stats = chi2_stats(terms, cfg, mesh)
    stats.update(extra)
    stats["spd_ok"] = spd_ok
    stats["accepted"] = torch.ones((), dtype=torch.bool, device=g.device)
    stats["damping"] = torch.full((), cfg.damping, dtype=g.poses.dtype, device=g.device)
    stats["delta_norm"] = GN.delta_norm(dp, dl)
    return g.with_state(poses, landmarks), stats


def _robust_total(g: FactorGraph, cfg: SolverConfig, mesh=None) -> torch.Tensor:
    t = edge_terms(g, cfg)
    total = torch.sum(robust_cost(t.bchi2, cfg)) + torch.sum(robust_cost(t.ochi2, cfg))
    return total if mesh is None else mesh.psum(total)


def lm_step(g: FactorGraph, lam: torch.Tensor, cfg: SolverConfig,
            band_tiles: int | None = None, mesh=None):
    """One LM trial: solve with damping ``lam``, accept iff the robust cost
    decreases, and scale lam down (accept) or up (reject).  ``band_tiles``
    as in ``gn_step``.  Under a ``mesh`` both costs are psums, so every
    rank takes the same decision."""
    _check_ported(cfg)
    dp, dl, terms, spd_ok, extra = _build_and_solve(g, cfg, lam, band_tiles, mesh)
    cand_poses, cand_landmarks = boxplus_state(g.poses, g.landmarks, dp, dl)
    cand = g.with_state(cand_poses, cand_landmarks)

    cost_old = torch.sum(robust_cost(terms.bchi2, cfg)) + torch.sum(robust_cost(terms.ochi2, cfg))
    if mesh is not None:
        cost_old = mesh.psum(cost_old)
    cost_new = _robust_total(cand, cfg, mesh)
    accept = (cost_new < cost_old) & spd_ok

    poses = torch.where(accept, cand.poses, g.poses)
    landmarks = torch.where(accept, cand.landmarks, g.landmarks)
    new_lam = torch.where(
        accept,
        torch.clamp(lam * cfg.lm_down, min=cfg.lm_lambda_min),
        torch.clamp(lam * cfg.lm_up, max=cfg.lm_lambda_max),
    )

    stats = chi2_stats(terms, cfg, mesh)
    stats.update(extra)
    stats["spd_ok"] = spd_ok
    stats["accepted"] = accept
    stats["damping"] = lam
    stats["delta_norm"] = GN.delta_norm(dp, dl)
    return g.with_state(poses, landmarks), new_lam, stats


def _stack(per_iter: list) -> dict:
    if not per_iter:
        return {}
    return {k: torch.stack([s[k] for s in per_iter]) for k in per_iter[0]}


def solve_loop(graph: FactorGraph, cfg: SolverConfig, lam0: torch.Tensor | None = None,
               mesh=None):
    """Run ``cfg.iters`` optimizer iterations on the graph's device.

    Returns the optimized graph and per-iteration stats (each value a
    tensor with a leading ``iters`` axis; under LM also ``lam_final``, the
    next trial's damping, which a checkpoint saves).  ``lam0`` overrides
    the initial LM damping.  ``mesh``: the graph is the rank's edge shard.
    """
    _check_ported(cfg)
    per_iter = []
    g = graph
    if cfg.optimizer == "gn" and mesh is None and _fused_step_applicable(graph, cfg):
        from boslam_torch.ops.gn_step import fused_gn_solve

        return fused_gn_solve(graph, cfg)
    if cfg.optimizer not in ("gn", "lm"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    from boslam_torch.solver.schur import kernel_band

    # the Schur kernel's route, once per solve (no kernel under a mesh)
    band = None if mesh is not None else kernel_band(graph, cfg)
    if cfg.optimizer == "gn":
        for _ in range(cfg.iters):
            g, stats = gn_step(g, cfg, band, mesh)
            per_iter.append(stats)
        return g, _stack(per_iter)
    lam = lam0
    if lam is None:
        lam = torch.full((), cfg.lm_lambda0, dtype=graph.poses.dtype, device=graph.device)
    for _ in range(cfg.iters):
        g, lam, stats = lm_step(g, lam, cfg, band, mesh)
        per_iter.append(stats)
    stats = _stack(per_iter)
    stats["lam_final"] = lam
    return g, stats


def solve(graph: FactorGraph, cfg: SolverConfig, lam0: float | None = None):
    """Single-device entry point on the graph's device.

    ``lam0`` restores the LM damping (ignored under GN).
    """
    with span("solve"):
        lam = torch.full((), cfg.lm_lambda0 if lam0 is None else lam0,
                         dtype=graph.poses.dtype, device=graph.device)
        return solve_loop(graph, cfg, lam0=lam)


def packed_solve_loop(graph: FactorGraph, pk, cfg: SolverConfig, lam0: torch.Tensor | None = None,
                      dp0: torch.Tensor | None = None, start_iter: int = 0, mesh=None):
    """``cfg.iters`` packed optimizer steps (GN or LM) on the graph's device.

    ``lam0`` restores the LM damping and ``dp0`` the warm-start delta;
    ``start_iter`` offsets the GNC schedule, whose threshold ``kt_at`` is
    computed on the host from the iteration index.  ``stats["dp_final"]``
    is the last outer delta and, under LM, ``stats["lam_final"]`` the next
    trial's damping; every other stat has a leading ``iters`` axis.
    ``mesh``: the graph's edges and the grids' slot columns are the rank's
    shard.  Each outer charges the open root span "gn.outers" and its
    gathers by route, "gather.windowed" and "gather.plain"
    (``schur_packed.gather_counts``).
    """
    from boslam_torch.solver.schur_packed import gather_counts, packed_gn_step, packed_lm_step

    _check_ported(cfg)
    if cfg.optimizer not in ("gn", "lm"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    dev = graph.device
    dp = dp0 if dp0 is not None else torch.zeros((graph.n_poses, 3), dtype=graph.poses.dtype,
                                                    device=dev)
    lam = lam0 if lam0 is not None else torch.full((), cfg.lm_lambda0, dtype=graph.poses.dtype,
                                                    device=dev)
    g, per_iter = graph, []
    for i in range(cfg.iters):
        kt = cfg.kt_at(start_iter + i)
        with span("step"):
            count("gn.outers")
            windowed, plain = gather_counts()
            if cfg.optimizer == "gn":
                g, stats, dp = packed_gn_step(g, pk, cfg, dp, kt=kt, mesh=mesh)
            else:
                g, lam, stats, dp = packed_lm_step(g, pk, cfg, lam, dp, kt=kt, mesh=mesh)
            count("gather.windowed", gather_counts()[0] - windowed)
            count("gather.plain", gather_counts()[1] - plain)
        per_iter.append(stats)
    stats = _stack(per_iter)
    stats["dp_final"] = dp
    if cfg.optimizer == "lm":
        stats["lam_final"] = lam
    return g, stats


def solve_packed(graph: FactorGraph, cfg: SolverConfig, lam0: float | None = None,
                 dp0=None, start_iter: int = 0):
    """GN or LM on the dual-packed Schur+PCG layout, the large-scale path.

    Packs the edges on the host once (the one wait for the card outside the
    CG polls), then runs the packed steps on the graph's device.
    ``gather="windowed"`` relabels the landmarks by mean observing pose,
    plans windowed gathers for both slot grids and unmaps the landmark
    order on the way out; "auto" and "take" gather plainly.  ``lam0``
    restores the LM damping, ``dp0`` the warm-start delta, ``start_iter``
    the GNC schedule's offset.  The solve is the span "solve_packed", with
    "pack" (the host packing) and a "step" per outer under it.
    """
    from boslam_torch.graph.packed import pack_edges

    if cfg.gather not in ("auto", "take", "windowed"):
        raise ValueError(f"unknown gather {cfg.gather!r}")
    use_windows = cfg.gather == "windowed"
    dev, dtype = graph.device, graph.poses.dtype
    g_in, inv = graph, None
    with span("solve_packed"):
        with span("pack"), host_sync(dev):
            if use_windows:
                from boslam_torch.graph.reorder import reorder_landmarks_by_pose

                with span("reorder"):
                    g_in, _perm, inv_np = reorder_landmarks_by_pose(graph)
                    inv = torch.as_tensor(inv_np, device=dev)
            pk, _meta = pack_edges(g_in, windows=use_windows, split_lm=cfg.lm_split)
            if dp0 is not None:
                dp0 = torch.as_tensor(dp0, dtype=dtype, device=dev)
        lam = torch.full((), cfg.lm_lambda0 if lam0 is None else lam0, dtype=dtype, device=dev)
        final, stats = packed_solve_loop(g_in, pk, cfg, lam0=lam, dp0=dp0,
                                         start_iter=start_iter)
        if inv is not None:
            final = graph.with_state(final.poses, final.landmarks[inv])
    return final, stats
