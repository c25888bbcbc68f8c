"""Robust kernels as per-edge IRLS weights (port of
``boslam/solver/robust.py``).

The reference's threshold kernel rescales the *error* by sqrt(kt/chi) when
chi > kt but leaves the Jacobian term of H unscaled; that b-side-only
quirk is kept under ``SolverConfig.reference_kernel_quirk``.  Every kernel
is a pair of per-edge weights ``(w_H, w_b)``.
"""

from __future__ import annotations

import torch

from boslam_torch.config import SolverConfig


def robust_weights(chi2: torch.Tensor, cfg: SolverConfig, kt=None):
    """Per-edge (w_H, w_b) from pre-kernel chi2 = e^T Omega e."""
    one = torch.ones_like(chi2)
    if cfg.robust == "none":
        return one, one
    # a Python float stays a scalar operand: turning it into a device
    # tensor would copy it to the card and synchronize on every call
    kt = cfg.kernel_threshold if kt is None else kt
    w = torch.sqrt(kt / torch.clamp(chi2, min=torch.finfo(chi2.dtype).tiny))
    w = torch.where(chi2 > kt, w, one)
    if cfg.robust == "threshold":
        if cfg.reference_kernel_quirk:
            return one, w
        return w, w
    if cfg.robust == "huber":
        return w, w
    raise ValueError(f"unknown robust kernel {cfg.robust!r}")


def robust_cost(chi2: torch.Tensor, cfg: SolverConfig, kt=None) -> torch.Tensor:
    """rho(chi2) per edge — the objective actually minimized."""
    if cfg.robust == "none":
        return chi2
    kt = cfg.kernel_threshold if kt is None else kt
    if cfg.robust == "threshold":
        return torch.minimum(chi2, kt) if torch.is_tensor(kt) else torch.clamp(chi2, max=kt)
    if cfg.robust == "huber":
        safe = torch.clamp(chi2, min=torch.finfo(chi2.dtype).tiny)
        return torch.where(chi2 > kt, 2.0 * torch.sqrt(kt * safe) - kt, chi2)
    raise ValueError(f"unknown robust kernel {cfg.robust!r}")
