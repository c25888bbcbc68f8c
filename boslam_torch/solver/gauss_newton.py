"""Dense-path damped Gauss-Newton step with mask-based gauge fixing (port of
``boslam/solver/gauss_newton.py``).

The gauge pose is fixed by zeroing its rows and columns, putting 1 on its
diagonal and zeroing its b entries: the remaining subsystem is identical
to the reference's permute-and-truncate, and the fixed coordinates solve
to exactly zero.
"""

from __future__ import annotations

import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph, unpack_delta
from boslam_torch.solver.normal_eq import assemble_dense


def gauge_mask(N: int, n_poses: int, fixed_pose_ix: torch.Tensor, dtype) -> torch.Tensor:
    """f32[N] mask: 0 on the fixed pose's 3 coordinates, 1 elsewhere."""
    cols = torch.arange(N, device=fixed_pose_ix.device)
    is_fixed = (cols < 3 * n_poses) & (cols // 3 == fixed_pose_ix)
    return (~is_fixed).to(dtype)


def _use_cholesky_kernel(H: torch.Tensor, cfg: SolverConfig | None) -> bool:
    """The ``cholesky_backend`` rule.  "xla": never; "pallas": whenever the
    padded size fits MAX_VMEM_DIM (the kernel on a CUDA tensor, its plain
    version on a CPU one, as the JAX package takes interpret mode off the
    TPU); "auto" (and no cfg): a CUDA tensor that fits."""
    from boslam_torch.ops.cholesky import MAX_VMEM_DIM, pad_dim

    backend = "auto" if cfg is None else cfg.cholesky_backend
    if backend == "xla":
        return False
    fits = pad_dim(H.shape[0]) <= MAX_VMEM_DIM
    return fits if backend == "pallas" else fits and H.is_cuda


def solve_gauge_fixed(H, b, mask, cfg: SolverConfig | None = None):
    """Solve H delta = -b with the fixed pose pinned to zero delta.

    Returns (delta, spd_ok).  A failed factorization shows as NaN in
    delta; ``spd_ok`` is False then and delta is zeroed (the state is
    frozen rather than poisoned).  ``cfg.cholesky_backend`` picks the
    Cholesky kernel's module (``ops/cholesky.cholesky_solve``) or
    ``torch.linalg`` (``_use_cholesky_kernel``), as the JAX package picks
    its Pallas kernel or XLA's Cholesky.
    """
    Hm = mask[:, None] * H * mask[None, :] + torch.diag(1.0 - mask)
    bm = mask * b
    if _use_cholesky_kernel(H, cfg):
        from boslam_torch.ops.cholesky import cholesky_solve

        delta = cholesky_solve(Hm, -bm)
    else:
        L, info = torch.linalg.cholesky_ex(Hm)
        L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
        delta = torch.cholesky_solve(-bm[:, None], L)[:, 0]
    spd_ok = torch.logical_not(torch.any(torch.isnan(delta)))
    delta = torch.where(spd_ok, delta, torch.zeros_like(delta))
    return delta, spd_ok


def gn_build_and_solve(g: FactorGraph, cfg: SolverConfig, damping, mesh=None):
    """Assemble, damp, gauge-fix, solve.

    Returns (delta_poses, delta_landmarks, terms, spd_ok, extra), with
    ``extra`` empty (the signature is shared with the Schur path).  Under
    edge sharding (``mesh``) the assembly psums the partial H and b, and
    the solve runs replicated on every rank, through the Cholesky kernel
    on the card.
    """
    H, b, terms = assemble_dense(g, cfg, mesh=mesh)
    N = g.state_dim
    H = H + damping * torch.eye(N, dtype=H.dtype, device=H.device)
    mask = gauge_mask(N, g.n_poses, g.fixed_pose_ix, H.dtype)
    delta, spd_ok = solve_gauge_fixed(H, b, mask, cfg)
    dp, dl = unpack_delta(delta, g.n_poses, g.n_landmarks)
    return dp, dl, terms, spd_ok, {}
