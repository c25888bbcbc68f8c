"""Edge errors and analytic block Jacobians, batched (port of
``boslam/solver/residuals.py``).

Bearing edge:  h(X) = atan2(g), g = R^T (l - t), error = wrap(h - z);
  d atan2/d g = [-gy, gx] / |g|^2, d g/d dt = -R^T,
  d g/d dtheta = R^T DR'^T l, d g/d dl = R^T.
Odometry edge: h(X) = [R_s^T (t_d - t_s) ; theta_d - theta_s], error =
  h - z with the angle wrapped; J_src = [[-R_s^T, -(R_s^T DR' t_d)], [0, -1]],
  J_dst = [[R_s^T, R_s^T DR' t_d], [0, 1]], DR' = [[0,-1],[1,0]].

The autodiff variants differentiate the boxplus-perturbed errors at
delta = 0 with ``torch.func.jacfwd`` under ``torch.func.vmap`` (the
reference's numerical-Jacobian verification mode, exact here).
"""

from __future__ import annotations

import torch

from boslam_torch.geometry.se2 import boxplus_pose, inverse_transform_point, wrap_angle


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


def bearing_error(poses, landmarks, b_pose, b_lm, b_meas):
    """Wrapped angular error for every bearing edge: f32[NB]."""
    return bearing_error_from(poses[b_pose], landmarks[b_lm], b_meas)


def odometry_error_from(src, dst, o_meas):
    """Error from pre-gathered per-edge source/destination poses."""
    err = predict_odometry(src, dst) - o_meas
    return torch.cat([err[..., :2], wrap_angle(err[..., 2:3])], dim=-1)


def odometry_error(poses, o_src, o_dst, o_meas):
    """Euclidean-minus error with wrapped angle component: f32[NO, 3]."""
    return odometry_error_from(poses[o_src], poses[o_dst], o_meas)


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


def bearing_jacobians(poses, landmarks, b_pose, b_lm):
    """Per-edge blocks (J_pose f32[NB, 3], J_lm f32[NB, 2])."""
    return bearing_jacobians_from(poses[b_pose], landmarks[b_lm])


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


def odometry_jacobians(poses, o_src, o_dst):
    """Per-edge blocks (J_src f32[NO, 3, 3], J_dst f32[NO, 3, 3])."""
    return odometry_jacobians_from(poses[o_src], poses[o_dst])


# The perturbed errors run on one-row batches: under forward-mode AD a
# 0-dim tensor combined with a Python float (wrap_angle's constants) gives
# a float64 tangent in PyTorch 2.x, a one-element row keeps it float32.
def _bearing_err_of_delta(dp, dl, pose, lm, meas):
    p = boxplus_pose(pose[None], dp[None])
    return wrap_angle(predict_bearing(p, (lm + dl)[None]) - meas)[0]


def _odom_err_of_delta(ds, dd, src, dst, meas):
    e = predict_odometry(boxplus_pose(src[None], ds[None]), boxplus_pose(dst[None], dd[None]))
    e = e - meas[None]
    # the angle entry is wrapped out of place: vmap/jacfwd refuse in-place writes
    return torch.cat([e[:, :2], wrap_angle(e[:, 2:3])], dim=-1)[0]


def bearing_jacobians_autodiff(poses, landmarks, b_pose, b_lm, b_meas):
    """(J_pose f32[NB,3], J_lm f32[NB,2]) by jacfwd of the perturbed error."""
    from torch.func import jacfwd, vmap

    zero3, zero2 = poses.new_zeros(3), poses.new_zeros(2)

    def one(pose, lm, meas):
        return jacfwd(_bearing_err_of_delta, argnums=(0, 1))(zero3, zero2, pose, lm, meas)

    return vmap(one)(poses[b_pose], landmarks[b_lm], b_meas)


def odometry_jacobians_autodiff(poses, o_src, o_dst, o_meas):
    """(J_src f32[NO,3,3], J_dst f32[NO,3,3]) by jacfwd of the perturbed error."""
    from torch.func import jacfwd, vmap

    zero3 = poses.new_zeros(3)

    def one(src, dst, meas):
        return jacfwd(_odom_err_of_delta, argnums=(0, 1))(zero3, zero3, src, dst, meas)

    return vmap(one)(poses[o_src], poses[o_dst], o_meas)
