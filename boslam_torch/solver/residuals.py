"""Edge errors and analytic block Jacobians, batched (port of
``boslam/solver/residuals.py``).

Bearing edge:  h(X) = atan2(g), g = R^T (l - t), error = wrap(h - z);
  d atan2/d g = [-gy, gx] / |g|^2, d g/d dt = -R^T,
  d g/d dtheta = R^T DR'^T l, d g/d dl = R^T.
Odometry edge: h(X) = [R_s^T (t_d - t_s) ; theta_d - theta_s], error =
  h - z with the angle wrapped; J_src = [[-R_s^T, -(R_s^T DR' t_d)], [0, -1]],
  J_dst = [[R_s^T, R_s^T DR' t_d], [0, 1]], DR' = [[0,-1],[1,0]].
"""

from __future__ import annotations

import torch

from boslam_torch.geometry.se2 import inverse_transform_point, wrap_angle


def predict_bearing(pose: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """atan2 of the landmark in the pose frame: f32[...]."""
    g = inverse_transform_point(pose, lm)
    return torch.atan2(g[..., 1], g[..., 0])


def predict_odometry(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Relative motion in the source frame (g2o SLAM-2D convention)."""
    t = inverse_transform_point(src, dst[..., :2])
    dtheta = wrap_angle(dst[..., 2] - src[..., 2])
    return torch.cat([t, dtheta[..., None]], dim=-1)


def bearing_error_from(p, l, b_meas):
    """Error from pre-gathered per-edge poses/landmarks."""
    return wrap_angle(predict_bearing(p, l) - b_meas)


def odometry_error_from(src, dst, o_meas):
    """Error from pre-gathered per-edge source/destination poses."""
    err = predict_odometry(src, dst) - o_meas
    return torch.cat([err[..., :2], wrap_angle(err[..., 2:3])], dim=-1)


def bearing_jacobians_from(p, l):
    """Per-edge blocks (J_pose f32[NB, 3], J_lm f32[NB, 2])."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    g = inverse_transform_point(p, l)
    gx, gy = g[..., 0], g[..., 1]
    # guard the landmark == pose degeneracy (any finite value is right for
    # zero-information slots; NaN would not be)
    n2 = gx * gx + gy * gy
    inv_n2 = 1.0 / torch.clamp(n2, min=torch.finfo(n2.dtype).tiny)
    ax = -gy * inv_n2
    ay = gx * inv_n2

    gRx = ax * c - ay * s
    gRy = ax * s + ay * c

    lx, ly = l[..., 0], l[..., 1]
    col_x = c * ly - s * lx
    col_y = -s * ly - c * lx
    j_theta = ax * col_x + ay * col_y

    j_pose = torch.stack([-gRx, -gRy, j_theta], dim=-1)
    j_lm = torch.stack([gRx, gRy], dim=-1)
    return j_pose, j_lm


def odometry_jacobians_from(src, dst):
    """Per-edge blocks (J_src f32[NO, 3, 3], J_dst f32[NO, 3, 3])."""
    c, s = torch.cos(src[..., 2]), torch.sin(src[..., 2])
    tdx, tdy = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)

    thd_x = -c * tdy + s * tdx
    thd_y = s * tdy + c * tdx
    ths_x = -thd_x
    ths_y = -thd_y

    j_src = torch.stack(
        [
            torch.stack([-c, -s, ths_x], dim=-1),
            torch.stack([s, -c, ths_y], dim=-1),
            torch.stack([zeros, zeros, -ones], dim=-1),
        ],
        dim=-2,
    )
    j_dst = torch.stack(
        [
            torch.stack([c, s, thd_x], dim=-1),
            torch.stack([-s, c, thd_y], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return j_src, j_dst
