"""Block-tridiagonal solve by cyclic reduction, the chain preconditioner
(port of ``boslam/solver/btridiag.py``).

With chain odometry the reduced system S = Hpp - Hpl Hll^-1 Hlp has a
dominant block-tridiagonal skeleton: the odometry couplings are the
(i, i+1) band and are ~3 orders of magnitude stronger than a bearing
edge.  T = tridiag(diag(S), band) is SPD (the JAX module's docstring has
the argument) and is solved as the PCG preconditioner.

Cyclic reduction runs log2(N) levels, each a batched set of 3x3 inverses
and products over strided halves.  The factorization is computed once per
outer iteration and reused by every CG apply.  The closed-form 3x3
formulas keep the JAX package's expression order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boslam_torch.solver.schur import _inv3x3

_INV_SQRT3 = float(np.float32(1.0) / np.sqrt(np.float32(3.0)))  # in f32, as JAX computes it


def _mm(a, b):
    return torch.einsum("...nij,...njk->...nik", a, b)


def _mv(a, v):
    return torch.einsum("...nij,...nj->...ni", a, v)


def _stack33(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _chol3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form Cholesky of SPD 3x3 blocks (lower factor).

    Pivots are floored at a relative epsilon, 1e-6 of the block's largest
    diagonal entry: diag(S) blocks can go slightly indefinite in f32 near
    convergence, and an absolute floor would turn that into ~1e19 scale
    factors.  The JAX package swept it on 10k-pose graphs: 1e-5 degrades
    the preconditioner, 1e-6 and 1e-7 keep it.
    """
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    scale = torch.maximum(torch.maximum(torch.abs(a11), torch.abs(a22)), torch.abs(a33))
    eps = 1e-6 * scale + torch.finfo(A.dtype).tiny
    l11 = torch.sqrt(torch.maximum(a11, eps))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.maximum(a22 - l21 * l21, eps))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.maximum(a33 - l31 * l31 - l32 * l32, eps))
    z = torch.zeros_like(l11)
    return _stack33([[l11, z, z], [l21, l22, z], [l31, l32, l33]])


def _specnorm3x3(B: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Batched spectral norm of 3x3 blocks by power iteration on B^T B."""
    v = torch.full(B.shape[:-2] + (3,), _INV_SQRT3, dtype=B.dtype, device=B.device)
    for _ in range(iters):
        w = torch.einsum("...ij,...j->...i", B, v)
        v = torch.einsum("...ji,...j->...i", B, w)
        nv = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        v = v / torch.clamp(nv, min=1e-30)
    w = torch.einsum("...ij,...j->...i", B, v)
    return torch.sqrt(torch.sum(w * w, dim=-1))


def _inv_lower3x3(L: torch.Tensor) -> torch.Tensor:
    """Batched inverse of lower-triangular 3x3 blocks."""
    l11, l21, l31 = L[..., 0, 0], L[..., 1, 0], L[..., 2, 0]
    l22, l32, l33 = L[..., 1, 1], L[..., 2, 1], L[..., 2, 2]
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i33 = 1.0 / l33
    i21 = -l21 * i11 * i22
    i31 = (l21 * l32 - l31 * l22) * i11 * i22 * i33
    i32 = -l32 * i22 * i33
    z = torch.zeros_like(i11)
    return _stack33([[i11, z, z], [i21, i22, z], [i31, i32, i33]])


class BTFactor(NamedTuple):
    """Cyclic-reduction factorization of a block-tridiagonal matrix.

    ``levels[k] = (alpha, gamma, Binv_e, Ae, Ce)``, each [..., M_k/2, 3, 3];
    ``Binv_last`` the 1-block root system; ``n`` the unpadded size; ``Linv``
    the symmetric block-Jacobi prescaling factor.
    """

    levels: tuple
    Binv_last: torch.Tensor
    n: int
    Linv: torch.Tensor | None = None


def btridiag_factor(diag: torch.Tensor, upper: torch.Tensor, prescale: bool = True,
                    clamp_band: "float | None" = None) -> BTFactor:
    """Factor T = blocktridiag(lower=upper^T, diag, upper).

    ``diag`` f32[..., N, 3, 3] (SPD blocks), ``upper`` f32[..., N-1, 3, 3];
    leading dims factor independent chains.  Pads to the next power of two
    with decoupled identity blocks.

    ``prescale``: factor L^-1 T L^-T with L = chol(blockdiag(diag)), whose
    diagonal is the identity and whose band blocks have norm < 1, so every
    level works on O(1) blocks.  ``clamp_band`` (< 1/2) then clamps each
    scaled band block to that spectral norm, which makes the factorization
    a provably PD surrogate of T (preconditioner use only).
    """
    Linv = None
    if prescale:
        Linv = _inv_lower3x3(_chol3x3(diag))
        # diag' = I exactly; upper'_i = Linv_i @ C_i @ Linv_{i+1}^T
        upper = torch.einsum("...nij,...njk,...nlk->...nil", Linv[..., :-1, :, :], upper,
                             Linv[..., 1:, :, :])
        if clamp_band is not None:
            s = _specnorm3x3(upper)
            f = torch.clamp(clamp_band / torch.clamp(s, min=1e-30), max=1.0)
            upper = upper * f[..., None, None]
        diag = torch.eye(3, dtype=diag.dtype, device=diag.device).expand(diag.shape)

    batch = tuple(diag.shape[:-3])
    N = diag.shape[-3]
    dtype, dev = diag.dtype, diag.device
    M = 1 << max(0, (N - 1).bit_length())

    B = diag
    if M > N:
        eye = torch.eye(3, dtype=dtype, device=dev).expand(batch + (M - N, 3, 3))
        B = torch.cat([diag, eye], dim=-3)
    pad_c = M - 1 - upper.shape[-3]
    C = upper
    if pad_c:
        C = torch.cat([upper, torch.zeros(batch + (pad_c, 3, 3), dtype=dtype, device=dev)], dim=-3)
    # A[i] couples row i to i-1 (= C[i-1]^T, A[0] = 0); Cf[i] to i+1 (Cf[M-1] = 0)
    z1 = torch.zeros(batch + (1, 3, 3), dtype=dtype, device=dev)
    A = torch.cat([z1, C.transpose(-1, -2)], dim=-3)
    Cf = torch.cat([C, z1], dim=-3)

    levels = []
    while M > 1:
        Be, Bo = B[..., 0::2, :, :], B[..., 1::2, :, :]
        Ae, Ce = A[..., 0::2, :, :], Cf[..., 0::2, :, :]
        Ao, Co = A[..., 1::2, :, :], Cf[..., 1::2, :, :]

        Binv_e = _inv3x3(Be)
        # odd row i = 2j+1: even neighbours are i-1 -> even j, i+1 -> even j+1
        Binv_next = torch.cat([Binv_e[..., 1:, :, :], z1], dim=-3)
        Ae_next = torch.cat([Ae[..., 1:, :, :], z1], dim=-3)
        Ce_next = torch.cat([Ce[..., 1:, :, :], z1], dim=-3)
        alpha = _mm(Ao, Binv_e)
        gamma = _mm(Co, Binv_next)
        B = Bo - _mm(alpha, Ce) - _mm(gamma, Ae_next)
        A = -_mm(alpha, Ae)
        Cf = -_mm(gamma, Ce_next)
        levels.append((alpha, gamma, Binv_e, Ae, Ce))
        M //= 2

    return BTFactor(tuple(levels), _inv3x3(B), N, Linv)


def btridiag_solve(factor: BTFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve T x = rhs given a ``btridiag_factor`` result; rhs f32[..., N, 3]."""
    n = factor.n
    batch = tuple(rhs.shape[:-2])
    if factor.Linv is not None:
        rhs = _mv(factor.Linv, rhs)  # r' = L^-1 r
    M = 1 << max(0, (n - 1).bit_length())
    f = rhs
    if M > n:
        f = torch.cat([rhs, rhs.new_zeros(batch + (M - n, 3))], dim=-2)

    z1 = rhs.new_zeros(batch + (1, 3))
    f_evens = []
    for alpha, gamma, _Binv_e, _Ae, _Ce in factor.levels:
        fe, fo = f[..., 0::2, :], f[..., 1::2, :]
        fe_next = torch.cat([fe[..., 1:, :], z1], dim=-2)
        f_evens.append(fe)
        f = fo - _mv(alpha, fe) - _mv(gamma, fe_next)

    x = _mv(factor.Binv_last, f)  # [..., 1, 3]
    for (_alpha, _gamma, Binv_e, Ae, Ce), fe in zip(reversed(factor.levels), reversed(f_evens)):
        # even row 2j: odd neighbours are x_odd[j-1] (zero at j=0) and x_odd[j]
        x_prev = torch.cat([z1, x[..., :-1, :]], dim=-2)
        x_even = _mv(Binv_e, fe - _mv(Ae, x_prev) - _mv(Ce, x))
        x = torch.stack([x_even, x], dim=-2).reshape(batch + (2 * x.shape[-2], 3))

    x = x[..., :n, :]
    if factor.Linv is not None:
        x = torch.einsum("...nji,...nj->...ni", factor.Linv, x)  # x = L^-T x'
    return x


def btridiag_dense(diag: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Materialize T as a dense [3N, 3N] matrix: the dense coarse level of
    ``two_level`` and the tests.  Block (i, j) is written through a view of
    T's block diagonals, with no per-block launch."""
    N = diag.shape[0]
    T = torch.zeros((N, 3, N, 3), dtype=diag.dtype, device=diag.device)
    T.diagonal(dim1=0, dim2=2).copy_(diag.permute(1, 2, 0))
    if N > 1:
        T.diagonal(offset=1, dim1=0, dim2=2).copy_(upper.permute(1, 2, 0))
        T.diagonal(offset=-1, dim1=0, dim2=2).copy_(upper.permute(2, 1, 0))
    return T.reshape(3 * N, 3 * N)
