"""Per-landmark Schur complement: the exact reduced-system path (port of
``boslam/solver/schur.py``, ``use_cg=False``).

Landmark blocks of H are 2x2 and block-diagonal, so eliminating them is a
batched closed-form 2x2 inverse.  The reduced pose system
S = Hpp - Hpl Hll^-1 Hlp (3*NP square) is solved by Cholesky: on a CUDA
tensor within ``fused_fits`` by the hand-written Schur kernel
(``ops/schur_solve.py``), otherwise by materializing S and the masked
solve of the dense path.  The matrix-free PCG path (``use_cg=True``) is
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.solver.normal_eq import EdgeTerms, edge_terms


class SchurBlocks(NamedTuple):
    """Block-sparse damped normal equations."""

    Hpp_diag: torch.Tensor  # f32[NP, 3, 3] per-pose diagonal blocks
    Ho_sd: torch.Tensor  # f32[NO, 3, 3] odometry src->dst coupling blocks
    Hll_inv: torch.Tensor  # f32[NL, 2, 2] inverse damped landmark blocks
    Hpl: torch.Tensor  # f32[NB, 3, 2] per-bearing-edge pose-landmark blocks
    bp: torch.Tensor  # f32[NP, 3]
    bl: torch.Tensor  # f32[NL, 2]


def _inv2x2(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 inverse."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack(
        [
            torch.stack([d * inv_det, -b * inv_det], dim=-1),
            torch.stack([-c * inv_det, a * inv_det], dim=-1),
        ],
        dim=-2,
    )


def _segment_sum(v: torch.Tensor, ix: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    return out.index_add_(0, ix, v)


def build_blocks(g: FactorGraph, cfg: SolverConfig, damping, terms: EdgeTerms | None = None):
    """Assemble the block-sparse damped H and b by segment sums."""
    if terms is None:
        terms = edge_terms(g, cfg)
    NP_, NL = g.n_poses, g.n_landmarks
    dtype, dev = g.poses.dtype, g.device

    wH_b = (g.b_omega * terms.bw_H)[:, None, None]
    jp, jl = terms.bjp, terms.bjl
    NB, NO = jp.shape[0], terms.ojs.shape[0]
    Hpp_b = wH_b * jp[:, :, None] * jp[:, None, :]
    Hll_b = wH_b * jl[:, :, None] * jl[:, None, :]
    Hpl = wH_b * jp[:, :, None] * jl[:, None, :]
    coef_b = (g.b_omega * terms.bw_b * terms.be)[:, None]
    bp_b = coef_b * jp
    bl_b = coef_b * jl

    lm_sums = _segment_sum(torch.cat([Hll_b.reshape(NB, 4), bl_b], dim=1), g.b_lm, NL)
    Hll = lm_sums[:, :4].reshape(NL, 2, 2)
    bl = lm_sums[:, 4:6]

    js, jd = terms.ojs, terms.ojd
    Om = g.o_omega * terms.ow_H[:, None, None]
    OmJs = torch.einsum("eij,ejk->eik", Om, js)
    OmJd = torch.einsum("eij,ejk->eik", Om, jd)
    H_ss = torch.einsum("eij,eik->ejk", js, OmJs)
    H_dd = torch.einsum("eij,eik->ejk", jd, OmJd)
    H_sd = torch.einsum("eij,eik->ejk", js, OmJd)
    e_w = (g.o_omega @ (terms.ow_b[:, None] * terms.oe)[..., None])[..., 0]
    bp_s = torch.einsum("eij,ei->ej", js, e_w)
    bp_d = torch.einsum("eij,ei->ej", jd, e_w)

    pose_idx = torch.cat([g.b_pose, g.o_src, g.o_dst])
    pose_payload = torch.cat(
        [
            torch.cat([Hpp_b.reshape(NB, 9), bp_b], dim=1),
            torch.cat([H_ss.reshape(NO, 9), bp_s], dim=1),
            torch.cat([H_dd.reshape(NO, 9), bp_d], dim=1),
        ],
        dim=0,
    )
    pose_sums = _segment_sum(pose_payload, pose_idx, NP_)
    Hpp_diag = pose_sums[:, :9].reshape(NP_, 3, 3)
    bp = pose_sums[:, 9:12]

    # damping: a float or a device tensor (LM), never copied to the card
    Hpp_diag = Hpp_diag + damping * torch.eye(3, dtype=dtype, device=dev)
    Hll = Hll + damping * torch.eye(2, dtype=dtype, device=dev)
    return SchurBlocks(Hpp_diag, H_sd, _inv2x2(Hll), Hpl, bp, bl), terms


def _pose_mask(NP_: int, fixed_ix: torch.Tensor, dtype) -> torch.Tensor:
    """f32[NP, 1] gauge mask over pose blocks (1 except the fixed pose)."""
    return (torch.arange(NP_, device=fixed_ix.device) != fixed_ix).to(dtype)[:, None]


def _scatter(M: torch.Tensor, rows, cols, vals) -> None:
    """M[rows[e, i], cols[e, j]] += vals[e, i, j], in place."""
    r = rows[:, :, None].expand(vals.shape)
    c = cols[:, None, :].expand(vals.shape)
    M.index_put_((r.reshape(-1), c.reshape(-1)), vals.reshape(-1), accumulate=True)


def _dense_pieces(blocks: SchurBlocks, g: FactorGraph):
    """Dense damped Hpp [3NP, 3NP] and coupling U [3NP, 2NL] from the blocks."""
    NP_, NL = g.n_poses, g.n_landmarks
    dtype, dev = g.poses.dtype, g.device
    ar3 = torch.arange(3, device=dev)
    Hpp = torch.zeros((3 * NP_, 3 * NP_), dtype=dtype, device=dev)
    s3 = 3 * g.o_src[:, None] + ar3
    d3 = 3 * g.o_dst[:, None] + ar3
    _scatter(Hpp, s3, d3, blocks.Ho_sd)
    _scatter(Hpp, d3, s3, blocks.Ho_sd.transpose(1, 2))
    ix3 = 3 * torch.arange(NP_, device=dev)[:, None] + ar3
    _scatter(Hpp, ix3, ix3, blocks.Hpp_diag)
    U = torch.zeros((3 * NP_, 2 * NL), dtype=dtype, device=dev)
    bp3 = 3 * g.b_pose[:, None] + ar3
    bl2 = 2 * g.b_lm[:, None] + torch.arange(2, device=dev)
    _scatter(U, bp3, bl2, blocks.Hpl)
    return Hpp, U


def dense_reduced_system(blocks: SchurBlocks, g: FactorGraph):
    """Materialize S (3NP x 3NP) and the reduced rhs."""
    NP_, NL = g.n_poses, g.n_landmarks
    Hpp, U = _dense_pieces(blocks, g)
    W = torch.einsum("plh,lhj->plj", U.reshape(3 * NP_, NL, 2), blocks.Hll_inv).reshape(
        3 * NP_, 2 * NL
    )
    S = Hpp - W @ U.T
    rhs = -blocks.bp.reshape(-1) + W @ blocks.bl.reshape(-1)
    return S, rhs


def fused_schur_inputs(g: FactorGraph, cfg: SolverConfig, damping, terms: EdgeTerms,
                       mask: torch.Tensor):
    """The padded inputs (Hpp, U, Hb, bp, bl, m) of
    ``fused_schur_solve_blocks``, assembled by scatter from damped blocks;
    ``Hb`` holds the [Ml/2, 2, 2] blocks of Hll^-1 (zero on the padding).

    Pad rows carry mask 0, so they are exactly decoupled.
    """
    from boslam_torch.ops.schur_solve import B as TB

    NP_, NL = g.n_poses, g.n_landmarks
    dtype, dev = g.poses.dtype, g.device
    blocks, _ = build_blocks(g, cfg, damping, terms=terms)
    Hpp, U = _dense_pieces(blocks, g)

    Np, Ml = 3 * NP_, 2 * NL
    Np_pad = ((Np + TB - 1) // TB) * TB
    Ml_pad = ((Ml + TB - 1) // TB) * TB
    Hpp_p = torch.zeros((Np_pad, Np_pad), dtype=dtype, device=dev)
    Hpp_p[:Np, :Np] = Hpp
    U_p = torch.zeros((Np_pad, Ml_pad), dtype=dtype, device=dev)
    U_p[:Np, :Ml] = U
    Hb = torch.zeros((Ml_pad // 2, 2, 2), dtype=dtype, device=dev)
    Hb[:NL] = blocks.Hll_inv
    bpf = torch.zeros(Np_pad, dtype=dtype, device=dev)
    bpf[:Np] = blocks.bp.reshape(-1)
    blf = torch.zeros(Ml_pad, dtype=dtype, device=dev)
    blf[:Ml] = blocks.bl.reshape(-1)
    m = torch.zeros(Np_pad, dtype=dtype, device=dev)
    m[:Np] = mask[:, 0].repeat_interleave(3)
    return Hpp_p, U_p, Hb, bpf, blf, m


def fused_schur_solve(g: FactorGraph, cfg: SolverConfig, damping, terms: EdgeTerms,
                      mask: torch.Tensor):
    """Exact Schur solve through ``ops.schur_solve.fused_schur_solve_blocks``:
    damping -> Schur correction -> Cholesky -> both back-substitutions in
    the kernel module.  Returns (dp f32[NP,3], dl f32[NL,2])."""
    from boslam_torch.ops.schur_solve import fused_schur_solve_blocks

    inputs = fused_schur_inputs(g, cfg, damping, terms, mask)
    # the blocks are already damped, so the kernel adds zero
    x, dl = fused_schur_solve_blocks(*inputs, 0.0)
    Np, Ml = 3 * g.n_poses, 2 * g.n_landmarks
    return x[:Np].reshape(g.n_poses, 3), dl[:Ml].reshape(g.n_landmarks, 2)


def _nan_guard(dp, dl):
    ok = torch.logical_not(torch.any(torch.isnan(dp)) | torch.any(torch.isnan(dl)))
    return (torch.where(ok, dp, torch.zeros_like(dp)),
            torch.where(ok, dl, torch.zeros_like(dl)), ok)


def schur_build_and_solve(g: FactorGraph, cfg: SolverConfig, damping, use_cg: bool | None = None):
    """Exact Schur linear solve; same interface as the dense path.

    Returns (delta_poses f32[NP,3], delta_landmarks f32[NL,2], terms, ok,
    extra).  On a CUDA tensor within ``fused_fits`` the Schur kernel runs;
    otherwise S is materialized and solved as on the JAX package's
    non-TPU backends.
    """
    if use_cg is None:
        use_cg = cfg.linear_solver == "schur_cg"
    if use_cg:
        raise NotImplementedError("the Schur PCG path (schur_cg) is not ported yet")
    from boslam_torch.ops.schur_solve import fused_fits

    mask = _pose_mask(g.n_poses, g.fixed_pose_ix, g.poses.dtype)
    if g.poses.is_cuda and fused_fits(3 * g.n_poses, 2 * g.n_landmarks):
        terms = edge_terms(g, cfg)
        dp, dl = fused_schur_solve(g, cfg, damping, terms, mask)
        dp, dl, ok = _nan_guard(dp, dl)
        return dp, dl, terms, ok, {}

    from boslam_torch.solver.gauss_newton import solve_gauge_fixed

    blocks, terms = build_blocks(g, cfg, damping)
    S, rhs_flat = dense_reduced_system(blocks, g)
    m = mask[:, 0].repeat_interleave(3)
    delta, _spd = solve_gauge_fixed(S, -rhs_flat, m)
    dp = delta.reshape(g.n_poses, 3) * mask  # exact zero delta on the gauge pose

    # landmark back-substitution: dl = Hll^-1 (-bl - Hlp dp)
    hlp_dp = torch.einsum("eji,ej->ei", blocks.Hpl, dp[g.b_pose])
    hlp_dp = _segment_sum(hlp_dp, g.b_lm, g.n_landmarks)
    dl = torch.einsum("lij,lj->li", blocks.Hll_inv, -blocks.bl - hlp_dp)
    dp, dl, ok = _nan_guard(dp, dl)
    return dp, dl, terms, ok, {}
