"""Solver / run configuration (PyTorch port of ``boslam/config.py``).

Same fields and defaults as the JAX package, so a configuration means the
same thing in both.  ``dtype`` has no reader in the JAX package either; it
is kept for that parity and ``check_ported`` rejects any non-default value
of it, so none is accepted and then ignored.  ``check_ported`` also
refuses a value of ``band_width``, ``band_group``, ``coupling_dtype`` or
``cholesky_backend`` that the JAX package does not accept.  As in the JAX
package, the packed-path fields (GNC, ``cg_warm_start``, ``gather``,
``lm_split``, ``coupling_dtype``, the bband knobs) are read by
``solve_packed`` only.

``MeshConfig`` has no counterpart: nothing in the JAX package reads it,
and the port's mesh is ``parallel/mesh.Mesh`` over a process group.
"""

from __future__ import annotations

import dataclasses

import numpy as np

UNPORTED_FIELDS = frozenset(("dtype",))

# Relative noise floor that bfloat16-stored coupling blocks put under the
# Schur matvec (~2^-8 per-element rounding): with coupling_dtype="bfloat16"
# the CG tolerance is clamped up to this, reported per solve as
# stats["cg_tol_effective"].
BF16_CG_TOL_FLOOR = 4e-3


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
    # matrix-free PCG.
    linear_solver: str = "dense"  # "dense" | "schur" | "schur_cg"
    cg_iters: int = 100
    cg_tol: float = 1e-5
    cg_restarts: int = 8
    preconditioner: str = "auto"  # "auto" | "block_jacobi" | "btridiag" | "two_level" | "bband"
    coarse_q: int = 0  # two_level: poses per coarse aggregate (0 = ~sqrt(NP) in [8, 128])
    two_level_cycle: str = "additive"  # two_level: "additive" | "vcycle"
    # bband: S offsets 1..band_width kept exactly, and the super-node size
    # (band_group overrides it when nonzero)
    band_width: int = 8
    band_group: int = 0
    btridiag_block: int = 0
    cg_warm_start: bool = False
    matvec_row_chunk: int = 0

    # --- packed-path knobs ---
    gather: str = "auto"
    # "bfloat16" stores the packed coupling blocks half-size; the
    # contractions round the other operand to bf16 too and sum in f32
    coupling_dtype: str = "float32"  # "float32" | "bfloat16"
    lm_split: "str | int" = "auto"

    # --- normal-equation assembly strategy ---
    # "scatter": index gathers + index_add_; "matmul": one-hot design
    # matrix products; "auto": "matmul" when E*N fits the budget.
    assembly: str = "auto"  # "auto" | "scatter" | "matmul"
    matmul_assembly_budget: int = 40_000_000

    # --- whole-step kernel (GN + "schur" within ops.gn_step.fused_gn_fits) ---
    # "auto": the whole-step CUDA kernel for a CUDA graph, the unfused path
    # for a CPU graph; "force": the whole step on any device (the kernel,
    # or its plain version for a CPU graph); "off": the unfused path.  LM
    # and graphs outside the gate always take the unfused path.
    fused_step: str = "auto"  # "auto" | "off" | "force"

    # --- dense linear-solve backend ---
    # "xla": torch.linalg (and no Schur kernel); "pallas": the hand-written
    # Cholesky kernel whenever the padded size fits MAX_VMEM_DIM (its plain
    # version for a CPU tensor); "auto": the kernel for a CUDA tensor that
    # fits, else torch.linalg.  The names are the JAX package's.
    cholesky_backend: str = "auto"  # "auto" | "xla" | "pallas"

    # --- iteration control ---
    iters: int = 50

    # Scale only the b-side error by the robust weight, as the reference does.
    reference_kernel_quirk: bool = True

    # Jacobians by torch.func.jacfwd of the boxplus-perturbed errors
    # instead of the closed forms (the reference's verification mode).
    use_autodiff_jacobians: bool = False

    dtype: str = "float32"

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)

    def check_ported(self) -> None:
        """Raise NotImplementedError if a field the port does not implement
        has a value other than its default, and ValueError on a value of a
        ported field that the JAX package does not accept."""
        changed = [f.name for f in dataclasses.fields(self)
                if f.name in UNPORTED_FIELDS and getattr(self, f.name) != f.default]
        if changed:
            raise NotImplementedError(
                f"not ported yet, leave at their defaults: {', '.join(changed)}")
        if self.coupling_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown coupling_dtype {self.coupling_dtype!r}")
        if self.cholesky_backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown cholesky_backend {self.cholesky_backend!r}")
        for name in ("band_width", "band_group"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise ValueError(f"{name} must be an int >= 0, got {v!r}")

    @property
    def gnc_enabled(self) -> bool:
        return self.gnc_kt0 > 0 and self.gnc_anneal_iters > 0

    def kt_at(self, i: int):
        """Effective kernel threshold at outer iteration ``i``, a host float.

        Geometric interpolation gnc_kt0 -> kernel_threshold over the first
        ``gnc_anneal_iters`` outers, then the reference threshold exactly,
        computed in f32 as the JAX package computes it on its device.
        Returns None when GNC is disabled.
        """
        if not self.gnc_enabled:
            return None
        f32 = np.float32
        frac = np.clip(f32(1.0) - f32(i) / f32(self.gnc_anneal_iters), f32(0.0), f32(1.0))
        ratio = f32(self.gnc_kt0 / self.kernel_threshold)
        return float(f32(self.kernel_threshold) * np.power(ratio, frac))
