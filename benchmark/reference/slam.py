"""The plain reference: bearing-only graph SLAM by damped Gauss-Newton,
written from the problem's equations in plain PyTorch.

It imports nothing of the system under test and takes nothing the system
made: it reads the generated input (``harness.traffic.Parsed``) and works
out the landmark ids, the triangulation, every residual, Jacobian, robust
weight and solve itself.  The check runs it in float64.

The algorithm is the C++ reference's (SURVEY.md):

- state: SE(2) poses (x, y, theta) and 2D landmarks; the first-added pose
  (or the FIX record) is held fixed;
- bearing edge: e = wrap(atan2(R^T (l - t)) - z), information omega;
- odometry edge: e = [R_s^T (t_d - t_s), wrap(theta_d - theta_s)] - z,
  angle wrapped, information Omega (3x3);
- boxplus on the left: t' = R(dtheta) t + dt, theta' = wrap(theta +
  dtheta); landmarks l' = l + dl;
- the threshold kernel: an edge with chi2 = e^T Omega e above kt has its
  error scaled by sqrt(kt / chi2) on the b side only (H is unweighted);
  its robust cost is min(chi2, kt);
- a GN step solves (H + damping I) delta = -b with the fixed pose's rows
  and columns pinned, by eliminating the landmarks (dense Schur complement
  S of the pose block) and a Cholesky factorization of S.  A step whose
  solve is not finite keeps the state.
- landmarks start from the least-squares intersection of their bearing
  rays (the minimum-norm point on the line when the rays are parallel).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
# rank test of a landmark's 2x2 ray system: parallel rays below it
DEGENERATE_RTOL = 1e-7


class Problem(NamedTuple):
    """One input as index arrays on a device, in a float dtype."""

    poses: torch.Tensor  # [NP, 3] initial guess
    b_pose: torch.Tensor  # [NB] int64
    b_lm: torch.Tensor  # [NB] int64, into the sorted landmark ids
    b_meas: torch.Tensor
    b_omega: torch.Tensor
    o_src: torch.Tensor
    o_dst: torch.Tensor
    o_meas: torch.Tensor  # [NO, 3]
    o_omega: torch.Tensor  # [NO, 3, 3]
    fixed: int
    n_landmarks: int


def problem(parsed, dtype=torch.float64, device="cpu") -> Problem:
    """The input's arrays with ids turned into indices: poses in file
    order, landmarks by ascending id (the ids that bearing edges observe)."""
    pose_ix = {int(p): i for i, p in enumerate(parsed.pose_ids)}
    lm_ids = np.unique(np.asarray(parsed.bearing_lm_id))
    fixed_id = parsed.fixed_pose_id if parsed.fixed_pose_id >= 0 else parsed.pose_ids[0]

    def ix(ids):
        return torch.as_tensor(np.array([pose_ix[int(i)] for i in ids], np.int64), device=device)

    def fl(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    return Problem(
        poses=fl(parsed.pose_xyt),
        b_pose=ix(parsed.bearing_pose_id),
        b_lm=torch.as_tensor(np.searchsorted(lm_ids, parsed.bearing_lm_id), device=device),
        b_meas=fl(parsed.bearing_meas), b_omega=fl(parsed.bearing_omega),
        o_src=ix(parsed.odom_src_id), o_dst=ix(parsed.odom_dst_id),
        o_meas=fl(parsed.odom_meas), o_omega=fl(parsed.odom_omega),
        fixed=pose_ix[int(fixed_id)], n_landmarks=len(lm_ids),
    )


def wrap(a):
    return a - TWO_PI * torch.floor((a + math.pi) / TWO_PI)


def triangulate(pb: Problem) -> torch.Tensor:
    """[NL, 2]: each landmark's least-squares intersection of its rays.

    A ray from pose (px, py, theta) at bearing z is the line
    sin(a) x - cos(a) y = sin(a) px - cos(a) py, a = theta + z."""
    p = pb.poses[pb.b_pose]
    a = p[:, 2] + pb.b_meas
    n = torch.stack([torch.sin(a), -torch.cos(a)], 1)  # unit row of the line
    r = (n * p[:, :2]).sum(1)
    NL = pb.n_landmarks
    A = torch.zeros(NL, 2, 2, dtype=p.dtype, device=p.device)
    B = torch.zeros(NL, 2, dtype=p.dtype, device=p.device)
    A.index_add_(0, pb.b_lm, n[:, :, None] * n[:, None, :])
    B.index_add_(0, pb.b_lm, n * r[:, None])
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    tr = A[:, 0, 0] + A[:, 1, 1]
    full = det > DEGENERATE_RTOL * tr * tr
    adj = torch.stack([torch.stack([A[:, 1, 1], -A[:, 0, 1]], 1),
                       torch.stack([-A[:, 1, 0], A[:, 0, 0]], 1)], 1)
    x_full = (adj @ B[:, :, None])[:, :, 0] / torch.where(full, det, torch.ones_like(det))[:, None]
    # rank one: A = tr u u^T, so A B / tr^2 = (u . B / tr) u, the
    # minimum-norm point of the line
    trc = torch.clamp(tr, min=torch.finfo(tr.dtype).tiny)
    x_min = (A @ B[:, :, None])[:, :, 0] / (trc * trc)[:, None]
    return torch.where(full[:, None], x_full, x_min)


def _rot_t(theta, v):
    """R(theta)^T v for [..., 2] vectors."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([c * v[..., 0] + s * v[..., 1], -s * v[..., 0] + c * v[..., 1]], -1)


def bearing_terms(pb: Problem, poses, lms):
    """(error [NB], J_pose [NB, 3], J_lm [NB, 2]) at the state."""
    p, l = poses[pb.b_pose], lms[pb.b_lm]
    g = _rot_t(p[:, 2], l - p[:, :2])
    e = wrap(torch.atan2(g[:, 1], g[:, 0]) - pb.b_meas)
    # d atan2 / d g; a landmark on its pose (a ray through the origin can put a
    # one-ray landmark there) has no bearing: its derivative is taken as 0
    n2 = torch.clamp((g * g).sum(1, keepdim=True), min=torch.finfo(g.dtype).tiny)
    d = torch.stack([-g[:, 1], g[:, 0]], 1) / n2
    # g(delta) = R(theta)^T (R(dth)^T (l - dt)) - R(theta)^T t at delta = 0:
    # d g / d dt = -R^T, d g / d dth = R^T [l_y, -l_x], d g / d l = R^T
    c, s = torch.cos(p[:, 2]), torch.sin(p[:, 2])
    dg_dl = torch.stack([torch.stack([c, s], 1), torch.stack([-s, c], 1)], 1)  # R^T
    j_l = (d[:, None, :] @ dg_dl)[:, 0]
    j_th = (d * _rot_t(p[:, 2], torch.stack([l[:, 1], -l[:, 0]], 1))).sum(1)
    return e, torch.cat([-j_l, j_th[:, None]], 1), j_l


def odometry_terms(pb: Problem, poses):
    """(error [NO, 3], J_src [NO, 3, 3], J_dst [NO, 3, 3]) at the state."""
    s, d = poses[pb.o_src], poses[pb.o_dst]
    t = _rot_t(s[:, 2], d[:, :2] - s[:, :2])
    e = torch.cat([t, (d[:, 2] - s[:, 2])[:, None]], 1) - pb.o_meas
    e = torch.cat([e[:, :2], wrap(e[:, 2:3])], 1)
    c, sn = torch.cos(s[:, 2]), torch.sin(s[:, 2])
    o = torch.ones_like(c)
    Rt = torch.stack([torch.stack([c, sn], 1), torch.stack([-sn, c], 1)], 1)
    # with both poses perturbed on the left, the translation part is
    # R_s^T R(dth_s)^T (R(dth_d) t_d + dt_d - R(dth_s) t_s - dt_s)
    lever = _rot_t(s[:, 2], torch.stack([d[:, 1], -d[:, 0]], 1))
    j_s = torch.zeros(len(c), 3, 3, dtype=c.dtype, device=c.device)
    j_d = torch.zeros_like(j_s)
    j_s[:, :2, :2] = -Rt
    j_s[:, :2, 2] = lever
    j_s[:, 2, 2] = -o
    j_d[:, :2, :2] = Rt
    j_d[:, :2, 2] = -lever
    j_d[:, 2, 2] = o
    return e, j_s, j_d


def costs(pb: Problem, poses, lms, kt: float):
    """(bearing chi2 [NB], odometry chi2 [NO]) at the state."""
    be, _, _ = bearing_terms(pb, poses, lms)
    oe, _, _ = odometry_terms(pb, poses)
    bchi2 = pb.b_omega * be * be
    ochi2 = torch.einsum("ei,eij,ej->e", oe, pb.o_omega, oe)
    return bchi2, ochi2


def robust_cost(pb: Problem, poses, lms, kt: float) -> torch.Tensor:
    """sum of min(chi2, kt) over every edge: the threshold kernel's cost."""
    bchi2, ochi2 = costs(pb, poses, lms, kt)
    return torch.clamp(bchi2, max=kt).sum() + torch.clamp(ochi2, max=kt).sum()


def _b_weight(chi2, kt):
    """The threshold kernel's b-side weight: sqrt(kt / chi2) above kt."""
    return torch.where(chi2 > kt, torch.sqrt(kt / torch.clamp(chi2, min=1e-300)),
                       torch.ones_like(chi2))


def gn_step(pb: Problem, poses, lms, damping: float, kt: float):
    """One damped GN step: (poses', lms', ok).  H and b are assembled
    dense in their pose and landmark blocks, the landmarks are eliminated
    and the pose system is solved by Cholesky."""
    NP, NL = poses.shape[0], lms.shape[0]
    dt, dev = poses.dtype, poses.device
    be, bjp, bjl = bearing_terms(pb, poses, lms)
    oe, ojs, ojd = odometry_terms(pb, poses)
    bchi2 = pb.b_omega * be * be
    ochi2 = torch.einsum("ei,eij,ej->e", oe, pb.o_omega, oe)
    bwe = pb.b_omega * _b_weight(bchi2, kt) * be

    # pose block Hpp [3NP, 3NP], landmark blocks Hll [NL, 2, 2], coupling Hpl [3NP, 2NL]
    # (the blocks are summed as [NP * NP, 3, 3] and laid out once)
    flat = torch.zeros(NP * NP, 3, 3, dtype=dt, device=dev)
    flat.index_add_(0, pb.b_pose * NP + pb.b_pose,
                    pb.b_omega[:, None, None] * bjp[:, :, None] * bjp[:, None, :])
    OJs = pb.o_omega @ ojs
    OJd = pb.o_omega @ ojd
    flat.index_add_(0, pb.o_src * NP + pb.o_src, ojs.transpose(1, 2) @ OJs)
    flat.index_add_(0, pb.o_dst * NP + pb.o_dst, ojd.transpose(1, 2) @ OJd)
    flat.index_add_(0, pb.o_src * NP + pb.o_dst, ojs.transpose(1, 2) @ OJd)
    flat.index_add_(0, pb.o_dst * NP + pb.o_src, ojd.transpose(1, 2) @ OJs)
    Hpp = flat.reshape(NP, NP, 3, 3).permute(0, 2, 1, 3).reshape(3 * NP, 3 * NP)
    del flat

    bp = torch.zeros(NP, 3, dtype=dt, device=dev)
    bp.index_add_(0, pb.b_pose, bwe[:, None] * bjp)
    ow = _b_weight(ochi2, kt)[:, None] * oe
    bp.index_add_(0, pb.o_src, (ojs.transpose(1, 2) @ (pb.o_omega @ ow[:, :, None]))[:, :, 0])
    bp.index_add_(0, pb.o_dst, (ojd.transpose(1, 2) @ (pb.o_omega @ ow[:, :, None]))[:, :, 0])
    bl = torch.zeros(NL, 2, dtype=dt, device=dev)
    bl.index_add_(0, pb.b_lm, bwe[:, None] * bjl)

    Hll = torch.zeros(NL, 2, 2, dtype=dt, device=dev)
    Hll.index_add_(0, pb.b_lm, pb.b_omega[:, None, None] * bjl[:, :, None] * bjl[:, None, :])
    Hll = Hll + damping * torch.eye(2, dtype=dt, device=dev)
    fpl = torch.zeros(NP * NL, 3, 2, dtype=dt, device=dev)
    fpl.index_add_(0, pb.b_pose * NL + pb.b_lm,
                   pb.b_omega[:, None, None] * bjp[:, :, None] * bjl[:, None, :])
    Hpl = fpl.reshape(NP, NL, 3, 2).permute(0, 2, 1, 3).reshape(3 * NP, 2 * NL)

    # eliminate the landmarks: S = Hpp - Hpl Hll^-1 Hlp, r = -bp + Hpl Hll^-1 bl
    Hll_inv = torch.linalg.inv(Hll)
    W = (Hpl.reshape(3 * NP, NL, 1, 2) @ Hll_inv[None]).reshape(3 * NP, 2 * NL)
    S = Hpp  # (in place: at 10k poses S alone is 7.2 GB in float64)
    S.diagonal().add_(damping)
    S.addmm_(W, Hpl.T, alpha=-1.0)
    r = -bp.reshape(-1) + W @ bl.reshape(-1)
    keep = torch.ones(3 * NP, dtype=torch.bool, device=dev)
    keep[3 * pb.fixed:3 * pb.fixed + 3] = False
    L, info = torch.linalg.cholesky_ex(S[keep][:, keep])
    dp = torch.zeros(3 * NP, dtype=dt, device=dev)
    dp[keep] = torch.cholesky_solve(r[keep][:, None], L)[:, 0]
    dl = torch.einsum("lij,lj->li", Hll_inv, -bl - (Hpl.T @ dp).reshape(NL, 2))
    dp = dp.reshape(NP, 3)
    ok = bool(info == 0) and bool(torch.isfinite(dp).all()) and bool(torch.isfinite(dl).all())
    if not ok:
        return poses, lms, False
    c, s = torch.cos(dp[:, 2]), torch.sin(dp[:, 2])
    new_poses = torch.stack([c * poses[:, 0] - s * poses[:, 1] + dp[:, 0],
                             s * poses[:, 0] + c * poses[:, 1] + dp[:, 1],
                             wrap(poses[:, 2] + dp[:, 2])], 1)
    return new_poses, lms + dl, True


class Solution(NamedTuple):
    landmarks0: torch.Tensor  # [NL, 2] triangulated start
    chi2: list  # robust cost at the linearisation point of each step
    poses: torch.Tensor  # final
    landmarks: torch.Tensor
    cost: float  # robust cost of the final state
    failed_steps: int


def solve(pb: Problem, iters: int, damping: float, kt: float) -> Solution:
    """``iters`` damped GN steps from the triangulated start."""
    lms0 = triangulate(pb)
    poses, lms = pb.poses, lms0
    chi2, failed = [], 0
    for _ in range(iters):
        chi2.append(float(robust_cost(pb, poses, lms, kt)))
        poses, lms, ok = gn_step(pb, poses, lms, damping, kt)
        failed += not ok
    return Solution(lms0, chi2, poses, lms, float(robust_cost(pb, poses, lms, kt)), failed)
