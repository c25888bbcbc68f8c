"""Blocked Cholesky solve H x = b: the port of ``boslam/ops/pallas_cholesky.py``.

``cholesky_solve_padded`` launches the hand-written CUDA kernel
(``csrc/cholesky.cu``, ``csrc/cholesky.cuh``: one cooperative launch per
solve) for a CUDA tensor and runs its plain PyTorch version,
``cholesky_solve_padded_plain``, for a CPU tensor.  Both follow the same
right-looking blocked algorithm over ``TILE`` x ``TILE`` tiles: factor the
diagonal tile, invert it, solve the panel below it as a product with the
inverse, update the trailing lower tiles, then forward and backward
substitution through the tile inverses.  The plain version inverts a tile
by recursive block inversion (``tri_inv``, the twin of the JAX package's
``_tri_inv``); the kernel, whose tile is one warp wide, by a substitution
per lane.

The factorization runs on a working copy that the wrapper allocates, so
``H`` is left as it was.  A non-positive pivot yields NaN, which
propagates to ``x``: callers read NaN as "not SPD".
"""

from __future__ import annotations

import re

import torch

from boslam_torch.ops import _build

B = 128  # padding unit of the public functions (the JAX package's tile)
TILE = 32  # tile of the blocked algorithm: chol::TILE in csrc/cholesky.cuh
BASE = 8  # base block of tri_inv, as in _tri_inv
MAX_VMEM_DIM = 13 * B  # 1664: size gate kept from the JAX package
# The band route (csrc/band_cholesky.cuh) holds its window in one block's
# shared memory: (bt + 1)^2 tiles of the band, rows padded to LD floats, the
# spare tiles and y [n].  Its numbers (LD, SPARE_TILES, SMEM_LIMIT) come from
# csrc/band_window.h, the one place the kernel's launch size takes them from.
BAND_WINDOW = {k: int(v) for k, v in re.findall(r"^#define BOSLAM_BAND_(\w+)\s+(\d+)",
                                                (_build.CSRC / "band_window.h").read_text(),
                                                re.MULTILINE)}


def band_smem_bytes(band_tiles: int, n: int) -> int:
    """Shared memory of the band route at ``band_tiles`` = bt for an n x n
    system (csrc/band_cholesky.cuh: smem_bytes)."""
    k = band_tiles + 1
    return 4 * ((k * k + BAND_WINDOW["SPARE_TILES"]) * TILE * BAND_WINDOW["LD"] + n)


def band_fits(band_tiles: int, n: int) -> bool:
    """The route rule: the band route takes a band whose window fits one
    block's shared memory (bt <= 5 up to n = 1536), else the dense route."""
    return band_smem_bytes(band_tiles, n) <= BAND_WINDOW["SMEM_LIMIT"]


def pad_dim(n: int) -> int:
    return ((n + B - 1) // B) * B


def _factor_tile(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of one SPD tile from its lower triangle; NaN if not SPD."""
    L, info = torch.linalg.cholesky_ex(torch.tril(A) + torch.tril(A, -1).T)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _diag_blocks(L: torch.Tensor, h: int) -> torch.Tensor:
    """[n/h, h, h] diagonal h-blocks of an (n, n) matrix."""
    m = L.shape[0] // h
    return L.reshape(m, h, m, h).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular (n, n) tile, n = BASE * 2^k.

    Recursive block inversion, inv [[A, 0], [B, C]] = [[A^-1, 0],
    [-C^-1 B A^-1, C^-1]], run bottom-up with all blocks of a level at
    once; the BASE x BASE blocks are inverted by forward substitution row
    by row, each sum taken in the order ``_tri_inv`` takes it.
    """
    n = L.shape[0]
    h = BASE
    Lb = _diag_blocks(L, h)
    # row j of X = (e_j - sum_k<j L_jk X_k) / L_jj, each sum taken in k order
    X = torch.eye(h, dtype=L.dtype, device=L.device).repeat(Lb.shape[0], 1, 1)
    for j in range(h):
        X[:, j] /= Lb[:, j, j, None]
        X[:, j + 1:] -= Lb[:, j + 1:, j, None] * X[:, None, j]
    while h < n:
        A, C = X[0::2], X[1::2]
        Bl = _diag_blocks(L, 2 * h)[:, h:, :h]
        top = torch.cat([A, torch.zeros_like(A)], dim=2)
        bot = torch.cat([-(C @ (Bl @ A)), C], dim=2)
        X = torch.cat([top, bot], dim=1)
        h *= 2
    return X[0]


def _reach(band_tiles, n: int) -> int:
    """Scalar rows a tile couples with on either side: all of them when
    dense (``band_tiles`` None), else ``band_tiles`` tiles."""
    return n if band_tiles is None else band_tiles * TILE


def blocked_factor(L: torch.Tensor, band_tiles: int | None = None):
    """Factor L (lower triangle, in place) tile by tile; returns tile inverses.

    With ``band_tiles`` = bt, every tile more than bt tiles below the
    diagonal must be zero: the loops then stop bt tiles below the panel,
    which skips only updates that are sums of exact zeros.
    """
    n = L.shape[0]
    reach = _reach(band_tiles, n)
    inverses = []
    for k0 in range(0, n, TILE):
        k1 = k0 + TILE
        Lkk = _factor_tile(L[k0:k1, k0:k1])
        Linv = tri_inv(Lkk)
        inverses.append(Linv)
        L[k0:k1, k0:k1] = Lkk
        e = min(n, k1 + reach)
        if k1 < n:
            P = L[k1:e, k0:k1] @ Linv.T
            L[k1:e, k0:k1] = P
            L[k1:e, k1:e] -= P @ P.T
    return inverses


def blocked_substitute(L, inverses, b, mask=None, band_tiles: int | None = None):
    """Solve L L^T x = b by tiles; ``mask`` multiplies each solved x tile.
    ``band_tiles`` as in ``blocked_factor``."""
    n = L.shape[0]
    reach = _reach(band_tiles, n)
    y = torch.empty_like(b)
    for i, i0 in enumerate(range(0, n, TILE)):
        i1, lo = i0 + TILE, max(0, i0 - reach)
        acc = b[i0:i1] - L[i0:i1, lo:i0] @ y[lo:i0]
        y[i0:i1] = inverses[i] @ acc
    x = torch.empty_like(b)
    for i in reversed(range(n // TILE)):
        i0, i1 = i * TILE, (i + 1) * TILE
        e = min(n, i1 + reach)
        acc = y[i0:i1] - L[i1:e, i0:i1].T @ x[i1:e]
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
    p = _build.ptr
    err = lib.boslam_cholesky_solve(
        p(L), p(Linv), p(b), p(y), p(x), n, torch.cuda.current_stream(H.device).cuda_stream,
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
