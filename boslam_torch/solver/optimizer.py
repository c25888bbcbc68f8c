"""Outer optimization loops: constant-damping GN and Levenberg-Marquardt
(port of ``boslam/solver/optimizer.py``).

The loop stays on the device: no ``.item()`` and no host sync inside the
iterations.  Per-iteration stats are tensors, stacked at the end into one
tensor per key with a leading ``iters`` axis.
"""

from __future__ import annotations

import torch

from boslam_torch.config import SolverConfig
from boslam_torch.geometry.se2 import boxplus_state
from boslam_torch.graph.data import FactorGraph
from boslam_torch.solver import gauss_newton as GN
from boslam_torch.solver.normal_eq import chi2_stats, edge_terms
from boslam_torch.solver.robust import robust_cost


def _check_ported(cfg: SolverConfig) -> None:
    cfg.check_ported()
    # "auto" takes the unfused path; the whole-step kernel is not ported.
    if cfg.fused_step == "force":
        raise NotImplementedError(
            "fused_step='force' needs the whole-step GN kernel, which is not ported yet"
        )
    if cfg.fused_step not in ("auto", "off"):
        raise ValueError(f"unknown fused_step {cfg.fused_step!r}")


def _build_and_solve(g: FactorGraph, cfg: SolverConfig, damping):
    if cfg.linear_solver == "dense":
        return GN.gn_build_and_solve(g, cfg, damping)
    if cfg.linear_solver in ("schur", "schur_cg"):
        from boslam_torch.solver import schur

        return schur.schur_build_and_solve(g, cfg, damping)
    raise ValueError(f"unknown linear_solver {cfg.linear_solver!r}")


def _delta_norm(dp, dl):
    return torch.sqrt(torch.sum(dp * dp) + torch.sum(dl * dl))


def gn_step(g: FactorGraph, cfg: SolverConfig):
    """One constant-damping GN iteration."""
    _check_ported(cfg)
    dp, dl, terms, spd_ok, extra = _build_and_solve(g, cfg, cfg.damping)
    poses, landmarks = boxplus_state(g.poses, g.landmarks, dp, dl)
    stats = chi2_stats(terms, cfg)
    stats.update(extra)
    stats["spd_ok"] = spd_ok
    stats["accepted"] = torch.ones((), dtype=torch.bool, device=g.device)
    stats["damping"] = torch.full((), cfg.damping, dtype=g.poses.dtype, device=g.device)
    stats["delta_norm"] = _delta_norm(dp, dl)
    return g.with_state(poses, landmarks), stats


def _robust_total(g: FactorGraph, cfg: SolverConfig) -> torch.Tensor:
    t = edge_terms(g, cfg)
    return torch.sum(robust_cost(t.bchi2, cfg)) + torch.sum(robust_cost(t.ochi2, cfg))


def lm_step(g: FactorGraph, lam: torch.Tensor, cfg: SolverConfig):
    """One LM trial: solve with damping ``lam``, accept iff the robust cost
    decreases, and scale lam down (accept) or up (reject)."""
    _check_ported(cfg)
    dp, dl, terms, spd_ok, extra = _build_and_solve(g, cfg, lam)
    cand_poses, cand_landmarks = boxplus_state(g.poses, g.landmarks, dp, dl)
    cand = g.with_state(cand_poses, cand_landmarks)

    cost_old = torch.sum(robust_cost(terms.bchi2, cfg)) + torch.sum(robust_cost(terms.ochi2, cfg))
    cost_new = _robust_total(cand, cfg)
    accept = (cost_new < cost_old) & spd_ok

    poses = torch.where(accept, cand.poses, g.poses)
    landmarks = torch.where(accept, cand.landmarks, g.landmarks)
    new_lam = torch.where(
        accept,
        torch.clamp(lam * cfg.lm_down, min=cfg.lm_lambda_min),
        torch.clamp(lam * cfg.lm_up, max=cfg.lm_lambda_max),
    )

    stats = chi2_stats(terms, cfg)
    stats.update(extra)
    stats["spd_ok"] = spd_ok
    stats["accepted"] = accept
    stats["damping"] = lam
    stats["delta_norm"] = _delta_norm(dp, dl)
    return g.with_state(poses, landmarks), new_lam, stats


def _stack(per_iter: list) -> dict:
    if not per_iter:
        return {}
    return {k: torch.stack([s[k] for s in per_iter]) for k in per_iter[0]}


def solve_loop(graph: FactorGraph, cfg: SolverConfig, lam0: torch.Tensor | None = None):
    """Run ``cfg.iters`` optimizer iterations on the graph's device.

    Returns the optimized graph and per-iteration stats (each value a
    tensor with a leading ``iters`` axis).  ``lam0`` overrides the initial
    LM damping.
    """
    _check_ported(cfg)
    per_iter = []
    g = graph
    if cfg.optimizer == "gn":
        for _ in range(cfg.iters):
            g, stats = gn_step(g, cfg)
            per_iter.append(stats)
        return g, _stack(per_iter)
    if cfg.optimizer == "lm":
        lam = lam0
        if lam is None:
            lam = torch.full((), cfg.lm_lambda0, dtype=graph.poses.dtype, device=graph.device)
        for _ in range(cfg.iters):
            g, lam, stats = lm_step(g, lam, cfg)
            per_iter.append(stats)
        return g, _stack(per_iter)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def solve(graph: FactorGraph, cfg: SolverConfig, lam0: float | None = None):
    """Single-device entry point on the graph's device.

    ``lam0`` restores the LM damping (ignored under GN).
    """
    lam = torch.full((), cfg.lm_lambda0 if lam0 is None else lam0,
                     dtype=graph.poses.dtype, device=graph.device)
    return solve_loop(graph, cfg, lam0=lam)
