"""Solver / run configuration (PyTorch port of ``boslam/config.py``).

Same fields and defaults as the JAX package, so a configuration means the
same thing in both.  Fields whose code paths the port does not carry yet
(the CG solvers, the packed layout, GNC, the Cholesky backend choice, f64)
are kept for that parity; ``check_ported`` rejects any non-default value of
them, so none is accepted and then ignored.
"""

from __future__ import annotations

import dataclasses

import torch

UNPORTED_FIELDS = frozenset((
    "gnc_kt0", "gnc_anneal_iters",
    "cg_iters", "cg_tol", "cg_restarts", "preconditioner", "coarse_q", "two_level_cycle",
    "band_width", "band_group", "btridiag_block", "cg_warm_start", "matvec_row_chunk",
    "gather", "coupling_dtype", "lm_split",
    "cholesky_backend", "dtype",
))


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # --- robustifier (reference threshold kernel) ---
    robust: str = "threshold"  # "threshold" | "huber" | "none"
    kernel_threshold: float = 1.0

    # --- graduated non-convexity (packed / pose-range paths) ---
    gnc_kt0: float = 0.0  # 0 disables
    gnc_anneal_iters: int = 0

    # --- damping ---
    optimizer: str = "gn"  # "gn" | "lm"
    damping: float = 0.01
    lm_lambda0: float = 1e-3
    lm_up: float = 10.0
    lm_down: float = 0.1
    lm_lambda_min: float = 1e-9
    lm_lambda_max: float = 1e6

    # --- linear solver ---
    # "dense": Cholesky of the full gauge-fixed H; "schur": landmark
    # elimination + Cholesky of the reduced pose system; "schur_cg":
    # matrix-free PCG (not ported yet).
    linear_solver: str = "dense"  # "dense" | "schur" | "schur_cg"
    cg_iters: int = 100
    cg_tol: float = 1e-5
    cg_restarts: int = 8
    preconditioner: str = "auto"
    coarse_q: int = 0
    two_level_cycle: str = "additive"
    band_width: int = 8
    band_group: int = 0
    btridiag_block: int = 0
    cg_warm_start: bool = False
    matvec_row_chunk: int = 0

    # --- packed-path knobs (not ported yet) ---
    gather: str = "auto"
    coupling_dtype: str = "float32"
    lm_split: "str | int" = "auto"

    # --- normal-equation assembly strategy ---
    # "scatter": index gathers + index_add_; "matmul": one-hot design
    # matrix products; "auto": "matmul" when E*N fits the budget.
    assembly: str = "auto"  # "auto" | "scatter" | "matmul"
    matmul_assembly_budget: int = 40_000_000

    # --- whole-step kernel ---
    # "auto": the unfused path (the whole-step kernel is not ported yet);
    # "off": the unfused path; "force": raises NotImplementedError.
    fused_step: str = "auto"  # "auto" | "off" | "force"

    # --- dense linear-solve backend ---
    # Only "auto": the hand-written Cholesky kernel for CUDA tensors when the
    # padded size fits MAX_VMEM_DIM, else torch.linalg.
    cholesky_backend: str = "auto"

    # --- iteration control ---
    iters: int = 50

    # Scale only the b-side error by the robust weight, as the reference does.
    reference_kernel_quirk: bool = True

    # Autodiff Jacobians are not ported yet (raises NotImplementedError).
    use_autodiff_jacobians: bool = False

    dtype: str = "float32"

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)

    def check_ported(self) -> None:
        """Raise NotImplementedError if a field the port does not implement
        has a value other than its default."""
        changed = [f.name for f in dataclasses.fields(self)
                if f.name in UNPORTED_FIELDS and getattr(self, f.name) != f.default]
        if changed:
            raise NotImplementedError(
                f"not ported yet, leave at their defaults: {', '.join(changed)}")

    @property
    def gnc_enabled(self) -> bool:
        return self.gnc_kt0 > 0 and self.gnc_anneal_iters > 0

    def kt_at(self, i):
        """Effective kernel threshold at outer iteration ``i`` (a tensor).

        Geometric interpolation gnc_kt0 -> kernel_threshold over the first
        ``gnc_anneal_iters`` outers, then the reference threshold exactly.
        Returns None when GNC is disabled.
        """
        if not self.gnc_enabled:
            return None
        i = torch.as_tensor(i, dtype=torch.float32)
        frac = torch.clamp(1.0 - i / self.gnc_anneal_iters, 0.0, 1.0)
        ratio = torch.tensor(self.gnc_kt0 / self.kernel_threshold, dtype=torch.float32,
                             device=i.device)
        return self.kernel_threshold * torch.pow(ratio, frac)
