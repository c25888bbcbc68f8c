"""boslam_torch — the PyTorch / CUDA port of boslam (2D bearing-only graph SLAM).

Robust damped Gauss-Newton / Levenberg-Marquardt over SE(2) poses and 2D
landmarks with one gauge-fixed pose, on tensors.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  The dense and Schur
linear solves, the whole GN step and the packed path's windowed gather go
through hand-written CUDA kernels (``boslam_torch/ops``) on the card and
through their plain PyTorch versions on the CPU.  ``solve_packed`` is the
dual-packed Schur+PCG scale path.
"""

import torch as _torch

# Least-squares solving is precision-critical: the normal matrix has a
# condition number of about 1e7, and reduced-precision (TF32) products
# turn its Cholesky into NaN.  Keep every f32 product in full f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from boslam_torch.config import SolverConfig  # noqa: E402
from boslam_torch.graph.build import build_graph  # noqa: E402
from boslam_torch.graph.data import FactorGraph, GraphMeta  # noqa: E402
from boslam_torch.io.g2o import parse_g2o, write_g2o  # noqa: E402
from boslam_torch.solver.optimizer import solve, solve_packed  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "FactorGraph",
    "GraphMeta",
    "parse_g2o",
    "write_g2o",
    "build_graph",
    "solve",
    "solve_packed",
]
