"""Two-level chain preconditioner (port of ``boslam/solver/two_level.py``).

The single-level block-tridiagonal preconditioner (``solver/btridiag.py``)
caps the chain range it can represent through its PD band clamp; at ~100k
poses the CG error is dominated by exactly those long-wavelength chain
modes.  The two-level scheme works on the chain skeleton
T = tridiag(diag(S), odometry band):

- FINE level: T with every q-th coupling cut, i.e. NC independent q-pose
  block-tridiagonal systems, factored exactly by a batched cyclic
  reduction over the [NC, q] aggregate grid;
- COARSE level: the Galerkin projection T_c = P^T T P with piecewise
  constant interpolation over the aggregates, an NC-long block-tridiagonal
  chain: dense and Cholesky-factored once per outer iteration when
  3*NC <= ``_COARSE_DENSE_MAX`` (after a PD-guarding prescale and band
  clamp), else by the same cyclic reduction.

Additive (default): M^-1 r = T_cut^-1 r + m . P T_c^-1 P^T (m . r), with
``m`` the gauge mask, so r_fixed == 0 gives z_fixed == 0.  ``"vcycle"`` is
the symmetrized multiplicative variant (fine, coarse on the exact T
residual, fine).  Both are SPD.  Everything is batched 3x3 block
arithmetic and one dense f32 Cholesky, plain PyTorch on either device; the
dense-or-cyclic choice depends on the shape only, so nothing waits for the
card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_torch.solver.btridiag import (
    BTFactor,
    _chol3x3,
    _inv_lower3x3,
    _specnorm3x3,
    btridiag_dense,
    btridiag_factor,
    btridiag_solve,
)

CYCLES = ("additive", "vcycle")

# Largest dense coarse chain the once-per-outer Cholesky may build (3*NC).
_COARSE_DENSE_MAX = 4096


class TwoLevelFactor(NamedTuple):
    fine: BTFactor  # cut-chain factor: batched [NC, q] (additive) or one chain (vcycle)
    coarse: "BTFactor | tuple"  # cyclic-reduction factor, or (L, Linv_c) of the dense chain
    q: int  # aggregate size (poses per coarse node)
    n: int  # unpadded chain length
    mask: torch.Tensor  # f32[N, 1] gauge mask for the coarse transfer
    diag: "torch.Tensor | None"  # T's diag and band, kept for the V-cycle only
    band: "torch.Tensor | None"
    cycle: str
    coarse_dense: bool = False


def _pad_chain(diag: torch.Tensor, band: torch.Tensor, q: int):
    """Pad the chain to NC*q blocks with decoupled identity blocks; the band
    to NC*q - 1 couplings with zeros."""
    N = diag.shape[0]
    NC = -(-N // q)
    Np = NC * q
    if Np > N:
        eye = torch.eye(3, dtype=diag.dtype, device=diag.device).expand(Np - N, 3, 3)
        diag = torch.cat([diag, eye])
    bpad = Np - 1 - band.shape[0]
    if bpad > 0:
        band = torch.cat([band, band.new_zeros((bpad, 3, 3))])
    return diag, band, NC


def _coarse_galerkin(diag: torch.Tensor, band: torch.Tensor, q: int):
    """(D_c, B_c) of T_c = P^T T P, P piecewise constant over aggregates.

    ``diag`` f32[N,3,3], ``band`` f32[N-1,3,3] (coupling i -> i+1).
    """
    diag, band, NC = _pad_chain(diag, band, q)
    # slot (c, j) of the [NC, q] grid is coupling (cq+j, cq+j+1): internal
    # for j < q-1, the boundary at j == q-1
    band_g = torch.cat([band, band.new_zeros((1, 3, 3))]).reshape(NC, q, 3, 3)
    Dc = diag.reshape(NC, q, 3, 3).sum(dim=1)
    if q > 1:
        internal = band_g[:, : q - 1].sum(dim=1)
        Dc = Dc + internal + internal.transpose(-1, -2)
    Bc = band_g[:-1, q - 1]  # [NC-1, 3, 3]
    return Dc, Bc


def _cut_band(band: torch.Tensor, q: int) -> torch.Tensor:
    """Zero every coupling that crosses an aggregate boundary."""
    i = torch.arange(band.shape[0], device=band.device)
    keep = ((i + 1) % q) != 0
    return band * keep[:, None, None].to(band.dtype)


def _group_aggregates(diag: torch.Tensor, band: torch.Tensor, q: int):
    """Reshape the cut chain into NC independent [q]-long batched chains."""
    diag, band, NC = _pad_chain(diag, band, q)
    band = torch.cat([band, band.new_zeros((1, 3, 3))])
    diag_g = diag.reshape(NC, q, 3, 3)
    band_g = band.reshape(NC, q, 3, 3)[:, : q - 1]  # within-aggregate only
    return diag_g, band_g


def two_level_factor(diag: torch.Tensor, band: torch.Tensor, q: int, mask: torch.Tensor,
                     clamp_band: float = 0.4999, cycle: str = "additive") -> TwoLevelFactor:
    """Factor both levels.  ``diag``/``band`` are the (gauge-masked) chain T;
    ``mask`` f32[N,1] is the gauge mask (0 at the fixed pose).

    Additive: the fine level is a batched cyclic reduction over the
    [NC, q] aggregate grid; the coarse chain is dense and Cholesky-factored
    once when 3*NC fits ``_COARSE_DENSE_MAX``, else a cyclic reduction.
    """
    if cycle not in CYCLES:
        raise ValueError(f"unknown two_level_cycle {cycle!r}")
    if cycle == "vcycle":
        fine = btridiag_factor(diag, _cut_band(band, q), clamp_band=clamp_band)
        Dc, Bc = _coarse_galerkin(diag, band, q)
        coarse = btridiag_factor(Dc, Bc, clamp_band=clamp_band)
        return TwoLevelFactor(fine, coarse, q, diag.shape[0], mask, diag, band, cycle)

    diag_g, band_g = _group_aggregates(diag, band, q)
    fine = btridiag_factor(diag_g, band_g, clamp_band=clamp_band)
    Dc, Bc = _coarse_galerkin(diag, band, q)
    NC = Dc.shape[0]
    if 3 * NC <= _COARSE_DENSE_MAX:
        # PD-guarded dense coarse level: f32 cancellation leaves occasional
        # indefinite diag(S) blocks, which the aggregated chain inherits.
        # The symmetric block-Jacobi prescale (guarded pivots) and the band
        # clamp below 1/2 make the scaled chain provably PD; the dense
        # factor is of that surrogate.
        Lc = _chol3x3(Dc)
        Linv_c = _inv_lower3x3(Lc)
        Bc_s = torch.einsum("nij,njk,nlk->nil", Linv_c[:-1], Bc, Linv_c[1:])
        s = _specnorm3x3(Bc_s)
        fclamp = torch.clamp(0.4999 / torch.clamp(s, min=1e-30), max=1.0)
        Bc_s = Bc_s * fclamp[:, None, None]
        eye = torch.eye(3, dtype=Dc.dtype, device=Dc.device).expand(Dc.shape)
        Tc = btridiag_dense(eye, Bc_s)
        # the error flag stays on the device: a failed factor turns into
        # NaN (as the JAX package's cho_factor gives), read by nobody here
        L, info = torch.linalg.cholesky_ex(Tc)
        L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
        coarse, dense = (L, Linv_c), True
    else:
        coarse, dense = btridiag_factor(Dc, Bc, clamp_band=clamp_band), False
    return TwoLevelFactor(fine, coarse, q, diag.shape[0], mask, None, None, cycle, dense)


def _restrict(r: torch.Tensor, q: int) -> torch.Tensor:
    """P^T r: sum each aggregate's q rows.  r f32[N,3] -> [NC,3]."""
    N = r.shape[0]
    NC = -(-N // q)
    if NC * q > N:
        r = torch.cat([r, r.new_zeros((NC * q - N, 3))])
    return r.reshape(NC, q, 3).sum(dim=1)


def _prolong(zc: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """P z_c: each coarse value repeated over its aggregate."""
    return torch.repeat_interleave(zc, q, dim=0)[:n]


def _t_matvec(diag: torch.Tensor, band: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = T x for the block-tridiagonal chain (shifts, no gathers)."""
    y = torch.einsum("nij,nj->ni", diag, x)
    up = torch.einsum("nij,nj->ni", band, x[1:])  # row i += C_i x_{i+1}
    lo = torch.einsum("nji,nj->ni", band, x[:-1])  # row i+1 += C_i^T x_i
    y[:-1] += up
    y[1:] += lo
    return y


def _coarse_apply(f: TwoLevelFactor, rc: torch.Tensor) -> torch.Tensor:
    if f.coarse_dense:
        L, Linv_c = f.coarse
        r = torch.einsum("nij,nj->ni", Linv_c, rc)  # L^-1 r
        z = torch.cholesky_solve(r.reshape(-1, 1), L).reshape(rc.shape)
        return torch.einsum("nji,nj->ni", Linv_c, z)  # L^-T z
    return btridiag_solve(f.coarse, rc)


def two_level_solve(f: TwoLevelFactor, r: torch.Tensor) -> torch.Tensor:
    """Apply M^-1 r (additive) or the symmetric V-cycle."""
    if f.cycle == "additive":
        NC = -(-f.n // f.q)
        rg = r
        if NC * f.q > f.n:
            rg = torch.cat([r, r.new_zeros((NC * f.q - f.n, 3))])
        z_fine = btridiag_solve(f.fine, rg.reshape(NC, f.q, 3)).reshape(NC * f.q, 3)[: f.n]
        zc = _coarse_apply(f, _restrict(r * f.mask, f.q))
        return z_fine + _prolong(zc, f.q, f.n) * f.mask
    # symmetric V(1,1): pre-smooth with the cut factor, coarse-correct on the
    # exact T residual, post-smooth; SPD since both smoothers are the same SPD
    # cut factor
    z1 = btridiag_solve(f.fine, r)
    r1 = (r - _t_matvec(f.diag, f.band, z1)) * f.mask
    zc = btridiag_solve(f.coarse, _restrict(r1, f.q))
    z2 = z1 + _prolong(zc, f.q, f.n) * f.mask
    r2 = r - _t_matvec(f.diag, f.band, z2)
    return z2 + btridiag_solve(f.fine, r2)


def aggregate_size(cfg_q: int, n_poses: int) -> int:
    """Poses per coarse node: ``coarse_q``, or ~sqrt(NP) clamped to [8, 128]
    (balances the fine q-range against the NC-long coarse chain)."""
    return int(cfg_q) or max(8, min(128, 1 << (n_poses.bit_length() // 2)))
