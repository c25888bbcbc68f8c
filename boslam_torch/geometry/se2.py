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


def rot2(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``f32[..., 2, 2]`` from angles ``f32[...]``."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def v2t(ep: torch.Tensor) -> torch.Tensor:
    """Euclidean pose ``(x, y, theta)`` -> homogeneous ``f32[..., 3, 3]``.

    The reference's ``v2t``; used at API boundaries only, the hot paths
    work on the flat representation.
    """
    x, y, theta = ep[..., 0], ep[..., 1], ep[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack(
        [
            torch.stack([c, -s, x], dim=-1),
            torch.stack([s, c, y], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def t2v(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous ``f32[..., 3, 3]`` -> ``(x, y, theta)``, the angle
    recovered by atan2 in [-pi, pi] (the reference's ``t2v``)."""
    theta = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    return torch.stack([T[..., 0, 2], T[..., 1, 2], theta], dim=-1)


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


def transform_point(pose: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``X * p``: map a point from the pose frame to the world frame."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    px, py = p[..., 0], p[..., 1]
    return torch.stack([c * px - s * py + pose[..., 0], s * px + c * py + pose[..., 1]], dim=-1)


def inverse_transform_point(pose: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``X^-1 * p``: map a world point into the pose frame, ``R^T (p - t)``."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    dx = p[..., 0] - pose[..., 0]
    dy = p[..., 1] - pose[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)
