from boslam_torch.geometry.se2 import (
    wrap_angle,
    rot2,
    v2t,
    t2v,
    boxplus_pose,
    boxplus_state,
    transform_point,
    inverse_transform_point,
)

__all__ = [
    "wrap_angle",
    "rot2",
    "v2t",
    "t2v",
    "boxplus_pose",
    "boxplus_state",
    "transform_point",
    "inverse_transform_point",
]
