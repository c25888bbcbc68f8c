"""Normal-equation assembly: H = J^T Omega J, b = J^T Omega e, batched
(port of ``boslam/solver/normal_eq.py``).

Every edge's dense Jacobian blocks are computed at once
(``residuals.py``), weighted, and landed either by ``index_add_``
("scatter") or by products with one-hot design matrices ("matmul").  The
one-hot products are plain large matrix products, left to ``torch.matmul``
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.solver import residuals as R
from boslam_torch.solver.robust import robust_cost, robust_weights


class EdgeTerms(NamedTuple):
    """Per-edge residuals/Jacobians/weights shared by all assembly paths."""

    be: torch.Tensor  # f32[NB]
    bjp: torch.Tensor  # f32[NB, 3]
    bjl: torch.Tensor  # f32[NB, 2]
    bw_H: torch.Tensor
    bw_b: torch.Tensor
    bchi2: torch.Tensor
    oe: torch.Tensor  # f32[NO, 3]
    ojs: torch.Tensor  # f32[NO, 3, 3]
    ojd: torch.Tensor
    ow_H: torch.Tensor
    ow_b: torch.Tensor
    ochi2: torch.Tensor


def use_matmul_assembly(g: FactorGraph, cfg: SolverConfig) -> bool:
    """Pick the assembly strategy from the static shapes."""
    if cfg.assembly == "scatter":
        return False
    if cfg.assembly == "matmul":
        return True
    cost = (g.n_bearing + 3 * g.n_odometry) * g.state_dim
    return cost <= cfg.matmul_assembly_budget


def _one_hots(g: FactorGraph):
    dtype = g.poses.dtype
    Pb = F.one_hot(g.b_pose, g.n_poses).to(dtype)  # [NB, NP]
    Pl = F.one_hot(g.b_lm, g.n_landmarks).to(dtype)  # [NB, NL]
    Os = F.one_hot(g.o_src, g.n_poses).to(dtype)  # [NO, NP]
    Od = F.one_hot(g.o_dst, g.n_poses).to(dtype)  # [NO, NP]
    return Pb, Pl, Os, Od


def edge_terms(g: FactorGraph, cfg: SolverConfig) -> EdgeTerms:
    """Residuals, Jacobian blocks, robust weights and chi2 for all edges.

    Autodiff Jacobians take the index gathers, not the one-hot products,
    as in the JAX package (the assembly that follows is unchanged)."""
    if use_matmul_assembly(g, cfg) and not cfg.use_autodiff_jacobians:
        # one-hot gathers are exact: each output is 1.0 * value + zeros
        Pb, Pl, Os, Od = _one_hots(g)
        p_b, l_b = Pb @ g.poses, Pl @ g.landmarks
        p_s, p_d = Os @ g.poses, Od @ g.poses
    else:
        p_b, l_b = g.poses[g.b_pose], g.landmarks[g.b_lm]
        p_s, p_d = g.poses[g.o_src], g.poses[g.o_dst]
    be = R.bearing_error_from(p_b, l_b, g.b_meas)
    oe = R.odometry_error_from(p_s, p_d, g.o_meas)
    if cfg.use_autodiff_jacobians:
        bjp, bjl = R.bearing_jacobians_autodiff(g.poses, g.landmarks, g.b_pose, g.b_lm, g.b_meas)
        ojs, ojd = R.odometry_jacobians_autodiff(g.poses, g.o_src, g.o_dst, g.o_meas)
    else:
        bjp, bjl = R.bearing_jacobians_from(p_b, l_b)
        ojs, ojd = R.odometry_jacobians_from(p_s, p_d)

    bchi2 = g.b_omega * be * be
    ochi2 = torch.einsum("ei,eij,ej->e", oe, g.o_omega, oe)

    bw_H, bw_b = robust_weights(bchi2, cfg)
    ow_H, ow_b = robust_weights(ochi2, cfg)
    return EdgeTerms(be, bjp, bjl, bw_H, bw_b, bchi2, oe, ojs, ojd, ow_H, ow_b, ochi2)


def chi2_stats(t: EdgeTerms, cfg: SolverConfig) -> dict:
    """Per-iteration chi2 statistics, as tensors (no host sync)."""
    return {
        "chi2_bearing": torch.sum(t.bchi2),
        "chi2_odometry": torch.sum(t.ochi2),
        "chi2_robust": torch.sum(robust_cost(t.bchi2, cfg))
        + torch.sum(robust_cost(t.ochi2, cfg)),
        "n_bearing_clamped": torch.sum(t.bchi2 > cfg.kernel_threshold),
        "n_odometry_clamped": torch.sum(t.ochi2 > cfg.kernel_threshold),
    }


def _bearing_cols(g: FactorGraph) -> torch.Tensor:
    """Packed delta-vector columns of each bearing edge's 5 nonzeros."""
    p0 = 3 * g.b_pose
    l0 = 3 * g.n_poses + 2 * g.b_lm
    return torch.stack([p0, p0 + 1, p0 + 2, l0, l0 + 1], dim=-1)


def _odom_cols(g: FactorGraph) -> torch.Tensor:
    """Packed columns of each odometry edge's 6 nonzeros."""
    s0, d0 = 3 * g.o_src, 3 * g.o_dst
    return torch.stack([s0, s0 + 1, s0 + 2, d0, d0 + 1, d0 + 2], dim=-1)


def assemble_dense_matmul(g: FactorGraph, cfg: SolverConfig, terms: EdgeTerms | None = None):
    """Design-matrix formulation: H = A^T W A, b = A^T W e as products."""
    if terms is None:
        terms = edge_terms(g, cfg)
    NP_, NL = g.n_poses, g.n_landmarks
    NB, NO = g.n_bearing, g.n_odometry
    Pb, Pl, Os, Od = _one_hots(g)

    A_pose = torch.einsum("ep,ei->epi", Pb, terms.bjp).reshape(NB, 3 * NP_)
    A_lm = torch.einsum("el,ei->eli", Pl, terms.bjl).reshape(NB, 2 * NL)
    A_b = torch.cat([A_pose, A_lm], dim=1)
    wH_b = (g.b_omega * terms.bw_H)[:, None]
    H = A_b.T @ (wH_b * A_b)
    b = A_b.T @ (g.b_omega * terms.bw_b * terms.be)

    A_o = (
        torch.einsum("ep,erc->erpc", Os, terms.ojs)
        + torch.einsum("ep,erc->erpc", Od, terms.ojd)
    ).reshape(3 * NO, 3 * NP_)
    Om_w = g.o_omega * terms.ow_H[:, None, None]
    WA = (
        torch.einsum("ep,erc->erpc", Os, torch.einsum("eij,ejn->ein", Om_w, terms.ojs))
        + torch.einsum("ep,erc->erpc", Od, torch.einsum("eij,ejn->ein", Om_w, terms.ojd))
    ).reshape(3 * NO, 3 * NP_)
    H[: 3 * NP_, : 3 * NP_] += A_o.T @ WA
    e_w = torch.einsum("eij,ej->ei", g.o_omega, terms.ow_b[:, None] * terms.oe).reshape(3 * NO)
    b[: 3 * NP_] += A_o.T @ e_w
    return H, b, terms


def _scatter_blocks(M: torch.Tensor, cols: torch.Tensor, blocks: torch.Tensor) -> None:
    """M[cols[e, i], cols[e, j]] += blocks[e, i, j], in place."""
    n = M.shape[1]
    flat = (cols[:, :, None] * n + cols[:, None, :]).reshape(-1)
    M.view(-1).index_add_(0, flat, blocks.reshape(-1))


def assemble_dense(g: FactorGraph, cfg: SolverConfig, terms: EdgeTerms | None = None):
    """Full dense H f32[N,N] and b f32[N] (pre gauge-fix, pre damping).

    The robust quirk is preserved: w_H weights the H contribution, w_b the
    b contribution.  In scatter mode on CUDA, ``index_add_`` sums by
    atomics in an order that changes from run to run.
    """
    if use_matmul_assembly(g, cfg):
        return assemble_dense_matmul(g, cfg, terms)
    if terms is None:
        terms = edge_terms(g, cfg)
    N = g.state_dim
    H = torch.zeros((N, N), dtype=g.poses.dtype, device=g.device)
    b = torch.zeros((N,), dtype=g.poses.dtype, device=g.device)

    j5 = torch.cat([terms.bjp, terms.bjl], dim=-1)  # [NB, 5]
    cols = _bearing_cols(g)
    wH = (g.b_omega * terms.bw_H)[:, None, None]
    _scatter_blocks(H, cols, wH * j5[:, :, None] * j5[:, None, :])
    b.index_add_(0, cols.reshape(-1),
                 ((g.b_omega * terms.bw_b * terms.be)[:, None] * j5).reshape(-1))

    J = torch.cat([terms.ojs, terms.ojd], dim=-1)  # [NO, 3, 6]
    OJ = torch.einsum("eij,ejk->eik", g.o_omega, J)
    H6 = torch.einsum("eij,eik->ejk", J, OJ)
    b6 = torch.einsum("eij,ei->ej", OJ, terms.ow_b[:, None] * terms.oe)
    ocols = _odom_cols(g)
    _scatter_blocks(H, ocols, terms.ow_H[:, None, None] * H6)
    b.index_add_(0, ocols.reshape(-1), b6.reshape(-1))
    return H, b, terms
