from boslam_torch.solver.optimizer import solve, gn_step
from boslam_torch.solver.residuals import (
    predict_bearing,
    predict_odometry,
    bearing_error,
    odometry_error,
    bearing_jacobians,
    odometry_jacobians,
)

__all__ = [
    "solve",
    "gn_step",
    "predict_bearing",
    "predict_odometry",
    "bearing_error",
    "odometry_error",
    "bearing_jacobians",
    "odometry_jacobians",
]
