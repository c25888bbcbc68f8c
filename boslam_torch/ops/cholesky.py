"""Blocked Cholesky solve H x = b: the port of ``boslam/ops/pallas_cholesky.py``.

``cholesky_solve_padded`` launches the hand-written CUDA kernel
(``csrc/cholesky.cu``, ``csrc/cholesky.cuh``) for a CUDA tensor and runs
its plain PyTorch version, ``cholesky_solve_padded_plain``, for a CPU
tensor.  Both follow the same right-looking blocked algorithm over 64x64
tiles: factor the diagonal tile, invert it, solve the panel below it as a
product with the inverse, update the trailing lower tiles, then forward
and backward substitution through the tile inverses.

The factorization runs on a working copy that the wrapper allocates, so
``H`` is left as it was.  A non-positive pivot yields NaN, which
propagates to ``x``: callers read NaN as "not SPD".
"""

from __future__ import annotations

import torch

from boslam_torch.ops import _build

B = 128  # padding unit of the public functions (the JAX package's tile)
TILE = 64  # tile of the blocked algorithm
MAX_VMEM_DIM = 13 * B  # 1664: size gate kept from the JAX package


def pad_dim(n: int) -> int:
    return ((n + B - 1) // B) * B


def _factor_tile(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of one SPD tile from its lower triangle; NaN if not SPD."""
    L, info = torch.linalg.cholesky_ex(torch.tril(A) + torch.tril(A, -1).T)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def blocked_factor(L: torch.Tensor):
    """Factor L (lower triangle, in place) tile by tile; returns tile inverses."""
    n = L.shape[0]
    eye = torch.eye(TILE, dtype=L.dtype, device=L.device)
    inverses = []
    for k0 in range(0, n, TILE):
        k1 = k0 + TILE
        Lkk = _factor_tile(L[k0:k1, k0:k1])
        Linv = torch.linalg.solve_triangular(Lkk, eye, upper=False)
        inverses.append(Linv)
        L[k0:k1, k0:k1] = Lkk
        if k1 < n:
            P = L[k1:, k0:k1] @ Linv.T
            L[k1:, k0:k1] = P
            L[k1:, k1:] -= P @ P.T
    return inverses


def blocked_substitute(L, inverses, b, mask=None):
    """Solve L L^T x = b by tiles; ``mask`` multiplies each solved x tile."""
    n = L.shape[0]
    y = torch.empty_like(b)
    for i, i0 in enumerate(range(0, n, TILE)):
        i1 = i0 + TILE
        acc = b[i0:i1] - L[i0:i1, :i0] @ y[:i0]
        y[i0:i1] = inverses[i] @ acc
    x = torch.empty_like(b)
    for i in reversed(range(n // TILE)):
        i0, i1 = i * TILE, (i + 1) * TILE
        acc = y[i0:i1] - L[i1:, i0:i1].T @ x[i1:]
        xi = inverses[i].T @ acc
        x[i0:i1] = xi if mask is None else mask[i0:i1] * xi
    return x


def cholesky_solve_padded_plain(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    _check(H, b)
    L = H.clone()
    inverses = blocked_factor(L)
    return blocked_substitute(L, inverses, b)


def _check(H: torch.Tensor, b: torch.Tensor) -> None:
    if H.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"expected float32, got {H.dtype} and {b.dtype}")
    n = H.shape[0]
    if H.dim() != 2 or H.shape[1] != n or n % B != 0 or tuple(b.shape) != (n,):
        raise ValueError(f"expected H [n, n] and b [n] with n % {B} == 0, "
                         f"got {tuple(H.shape)} and {tuple(b.shape)}")
    if H.device != b.device:
        raise ValueError(f"H on {H.device} but b on {b.device}")


def cholesky_solve_padded(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H f32[Np, Np], Np a multiple of 128, b f32[Np].

    CUDA tensors go through the CUDA kernel; CPU tensors through the plain
    version.
    """
    if not H.is_cuda:
        return cholesky_solve_padded_plain(H, b)
    _check(H, b)
    if not (H.is_contiguous() and b.is_contiguous()):
        raise ValueError("H and b must be contiguous")
    lib = _lib()
    n = H.shape[0]
    L = H.clone()
    Linv = torch.empty((n // TILE, TILE, TILE), dtype=H.dtype, device=H.device)
    y = torch.empty_like(b)
    x = torch.empty_like(b)
    err = lib.boslam_cholesky_solve(
        _build.ptr(L), _build.ptr(Linv), _build.ptr(b), _build.ptr(y), _build.ptr(x),
        n, torch.cuda.current_stream(H.device).cuda_stream,
    )
    cholesky_solve_padded.launches += 1
    _build.check(lib, err, "cholesky_solve_padded")
    return x


cholesky_solve_padded.launches = 0


def _lib():
    import ctypes

    lib = _build.load_library("cholesky")
    fn = lib.boslam_cholesky_solve
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def cholesky_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b; pads to a 128 multiple (identity diagonal, zero rhs —
    the pad block is decoupled, so the solution is unchanged).

    Above ``MAX_VMEM_DIM`` this takes ``torch.linalg``, as the JAX package
    takes XLA's Cholesky there.
    """
    N = H.shape[0]
    Np = pad_dim(N)
    if Np > MAX_VMEM_DIM:
        return torch.cholesky_solve(b[:, None], _factor_tile(H))[:, 0]
    pad = Np - N
    if pad:
        Hp = torch.zeros((Np, Np), dtype=H.dtype, device=H.device)
        Hp[:N, :N] = H
        Hp.diagonal()[N:].fill_(1.0)
        H = Hp
        b = torch.cat([b, torch.zeros(pad, dtype=b.dtype, device=b.device)])
    return cholesky_solve_padded(H.contiguous(), b.contiguous())[:N]
