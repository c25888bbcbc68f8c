"""SE(2) chart maps on flat ``(x, y, theta)`` tensors (port of
``boslam/geometry/se2.py``).

Every map works on arbitrary leading batch dimensions.  Angles are wrapped
to [-pi, pi) with the closed form ``a - 2pi*floor((a+pi)/2pi)``.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 6.283185307179586


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Normalize angle(s) to [-pi, pi)."""
    return a - _TWO_PI * torch.floor((a + math.pi) / _TWO_PI)


def boxplus_pose(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Manifold retraction ``X' = v2t(delta) * X`` on flat poses.

    ``t' = R(dtheta) @ t + dt`` and ``theta' = wrap(theta + dtheta)``: the
    left perturbation rotates the pose translation.
    """
    dtheta = delta[..., 2]
    c, s = torch.cos(dtheta), torch.sin(dtheta)
    tx, ty = pose[..., 0], pose[..., 1]
    nx = c * tx - s * ty + delta[..., 0]
    ny = s * tx + c * ty + delta[..., 1]
    ntheta = wrap_angle(pose[..., 2] + dtheta)
    return torch.stack([nx, ny, ntheta], dim=-1)


def boxplus_state(poses, landmarks, delta_poses, delta_landmarks):
    """Per-pose manifold boxplus, Euclidean ``+=`` for landmarks."""
    return boxplus_pose(poses, delta_poses), landmarks + delta_landmarks


def inverse_transform_point(pose: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``X^-1 * p``: map a world point into the pose frame, ``R^T (p - t)``."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    dx = p[..., 0] - pose[..., 0]
    dy = p[..., 1] - pose[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)
