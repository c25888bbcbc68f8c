"""Exact Schur solve of the reduced pose system: the port of
``boslam/ops/pallas_schur.py``.

    W   = U Hll^-1                    (Hll^-1: block-diagonal 2x2)
    S   = m m^T o (Hpp + lam I - W U^T) + diag(1 - m)
    rhs = m o (W bl - bp)
    x   = S^-1 rhs                    (blocked Cholesky, masked tile by tile)
    dl  = Hll^-1 (-bl - U^T x)

``fused_schur_solve_blocks`` takes Hll^-1 as its [Ml/2, 2, 2] diagonal
blocks.  It launches the hand-written CUDA kernels (``csrc/schur_solve.cu``,
which reuses the factorization and substitutions of ``csrc/cholesky.cuh``)
for CUDA tensors and runs the plain PyTorch version,
``fused_schur_solve_blocks_plain``, for CPU tensors.
``fused_schur_solve_padded`` keeps the JAX package's signature, a dense
[Ml, Ml] block-diagonal ``HllD``, and reads its diagonal blocks.  The gauge
and pad rows carry mask 0, so their x comes out as exact 0.0.
"""

from __future__ import annotations

import torch

from boslam_torch.ops import _build
from boslam_torch.ops.cholesky import TILE, blocked_factor, blocked_substitute

B = 128
MAX_NP = 10 * B  # 1280: size gates kept from the JAX package
MAX_ML = 4 * B  # 512


def fused_fits(n_pose_dim: int, n_lm_dim: int) -> bool:
    """True when the padded problem is within the JAX kernel's size gate."""
    Np = ((n_pose_dim + B - 1) // B) * B
    Ml = ((n_lm_dim + B - 1) // B) * B
    return Np <= MAX_NP and Ml <= MAX_ML


def _diag_blocks(HllD: torch.Tensor) -> torch.Tensor:
    """[Ml/2, 2, 2] diagonal blocks of a block-diagonal [Ml, Ml] matrix."""
    nl = HllD.shape[0] // 2
    return HllD.reshape(nl, 2, nl, 2).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def _as_damping(damping, like: torch.Tensor) -> torch.Tensor:
    """[1] tensor on ``like``'s device; a float is filled there, not copied."""
    if torch.is_tensor(damping):
        return damping.to(dtype=like.dtype, device=like.device).reshape(1)
    return torch.full((1,), float(damping), dtype=like.dtype, device=like.device)


def fused_schur_solve_blocks_plain(Hpp, U, Hb, bp, bl, mask, damping):
    """Plain PyTorch version of the kernel, on any device."""
    _check(Hpp, U, Hb, bp, bl, mask)
    Np, Ml = U.shape
    W = torch.einsum("rlb,lba->rla", U.reshape(Np, Ml // 2, 2), Hb).reshape(Np, Ml)
    lam = _as_damping(damping, Hpp)
    eye = torch.eye(Np, dtype=Hpp.dtype, device=Hpp.device)
    S = (Hpp - W @ U.T) + lam * eye
    S = S * (mask[:, None] * mask[None, :]) + eye * (1.0 - mask)
    rhs = mask * (W @ bl - bp)
    inverses = blocked_factor(S)
    x = blocked_substitute(S, inverses, rhs, mask)
    t = -bl - U.T @ x
    dl = torch.einsum("lab,lb->la", Hb, t.reshape(Ml // 2, 2)).reshape(Ml)
    return x, dl


def _check(Hpp, U, Hb, bp, bl, mask) -> None:
    ts = (Hpp, U, Hb, bp, bl, mask)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("all inputs must be float32")
    if any(t.device != Hpp.device for t in ts):
        raise ValueError("all inputs must be on one device")
    Np, Ml = Hpp.shape[0], 2 * Hb.shape[0]
    ok = (
        Np % B == 0 and Ml % B == 0
        and tuple(Hpp.shape) == (Np, Np) and tuple(U.shape) == (Np, Ml)
        and tuple(Hb.shape) == (Ml // 2, 2, 2) and tuple(bp.shape) == (Np,)
        and tuple(bl.shape) == (Ml,) and tuple(mask.shape) == (Np,)
    )
    if not ok:
        raise ValueError(
            f"bad shapes Hpp {tuple(Hpp.shape)} U {tuple(U.shape)} Hb {tuple(Hb.shape)} "
            f"bp {tuple(bp.shape)} bl {tuple(bl.shape)} mask {tuple(mask.shape)}; "
            f"Np and Ml must be multiples of {B}"
        )


def fused_schur_solve_blocks(Hpp, U, Hb, bp, bl, mask, damping):
    """Reduced-system solve; returns (x f32[Np], dl f32[Ml]).

    ``Hpp`` f32[Np, Np] (damping is added here), ``U`` f32[Np, Ml], ``Hb``
    f32[Ml/2, 2, 2] the diagonal blocks of Hll^-1, ``bp`` f32[Np], ``bl``
    f32[Ml], ``mask`` f32[Np] (0 on the gauge rows and the padding),
    ``damping`` a scalar (a float or a tensor, read on the device without a
    sync).
    """
    if not Hpp.is_cuda:
        return fused_schur_solve_blocks_plain(Hpp, U, Hb, bp, bl, mask, damping)
    _check(Hpp, U, Hb, bp, bl, mask)
    if not all(t.is_contiguous() for t in (Hpp, U, Hb, bp, bl, mask)):
        raise ValueError("all inputs must be contiguous")
    lib = _lib()
    Np, Ml = U.shape
    f32 = dict(dtype=Hpp.dtype, device=Hpp.device)
    lam = _as_damping(damping, Hpp)
    W = torch.empty((Np, Ml), **f32)
    S = torch.empty((Np, Np), **f32)
    Linv = torch.empty((Np // TILE, TILE, TILE), **f32)
    rhs, y, x = (torch.empty(Np, **f32) for _ in range(3))
    dl = torch.empty(Ml, **f32)
    p = _build.ptr
    err = lib.boslam_schur_solve(
        p(Hpp), p(U), p(Hb), p(bp), p(bl), p(mask), p(lam), p(W), p(S), p(Linv),
        p(rhs), p(y), p(x), p(dl), Np, Ml, torch.cuda.current_stream(Hpp.device).cuda_stream,
    )
    fused_schur_solve_blocks.launches += 1
    _build.check(lib, err, "fused_schur_solve_blocks")
    return x, dl


fused_schur_solve_blocks.launches = 0


def fused_schur_solve_padded(Hpp, U, HllD, bp, bl, mask, damping):
    """``fused_schur_solve_blocks`` with the JAX package's signature:
    ``HllD`` f32[Ml, Ml] block-diagonal, of which only the 2x2 diagonal
    blocks are read."""
    if tuple(HllD.shape) != (U.shape[-1], U.shape[-1]) or HllD.shape[0] % 2:
        raise ValueError(f"HllD {tuple(HllD.shape)} must be [Ml, Ml] for U {tuple(U.shape)}")
    return fused_schur_solve_blocks(Hpp, U, _diag_blocks(HllD).contiguous(), bp, bl, mask,
                                    damping)


def _lib():
    import ctypes

    lib = _build.load_library("schur_solve")
    fn = lib.boslam_schur_solve
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
