"""Trajectory / map quality metrics (numpy; port of ``boslam/metrics.py``).

The reference judges convergence purely visually (SURVEY §5/§6: "chi2 is
never computed or reported").  These metrics make the behavioral baseline
("converge to the ground-truth trajectory/map in ~20 iterations",
README.md:22) quantitative: ATE RMSE over pose translations, rotation RMSE,
and landmark RMSE against a ground-truth g2o file — both raw (gauge is
shared via the FIX record, so raw comparison is meaningful) and after an
optimal 2D rigid alignment (Umeyama/Kabsch) to factor out any residual
gauge difference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _wrap(a: np.ndarray) -> np.ndarray:
    """Angles to [-pi, pi)."""
    return a - 2.0 * np.pi * np.floor((a + np.pi) / (2.0 * np.pi))


def rigid_align_2d(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Best-fit rotation R and translation t with ``R @ src + t ~= dst``."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s)
    U, _, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, d]) @ Vt
    t = mu_d - R @ mu_s
    return R, t


def ate_metrics(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    est_landmarks: np.ndarray | None = None,
    gt_landmarks: np.ndarray | None = None,
) -> Dict[str, float]:
    """Absolute trajectory / map error vs ground truth.

    ``est_poses``/``gt_poses`` are f32[NP,3] in *matching index order* (same
    id normalization).  Landmark arrays are matched by index too and may
    have NaN rows in gt for unlocalizable landmarks (excluded).
    """
    est_poses = np.asarray(est_poses, np.float64)
    gt_poses = np.asarray(gt_poses, np.float64)
    dt = est_poses[:, :2] - gt_poses[:, :2]
    out: Dict[str, float] = {
        "ate_rmse": float(np.sqrt(np.mean(np.sum(dt**2, axis=1)))),
        "rot_rmse": float(
            np.sqrt(
                np.mean(np.square(_wrap(est_poses[:, 2] - gt_poses[:, 2])))
            )
        ),
    }

    # Aligned variant: find the rigid map est->gt over pose translations.
    R, t = rigid_align_2d(est_poses[:, :2], gt_poses[:, :2])
    aligned = est_poses[:, :2] @ R.T + t
    da = aligned - gt_poses[:, :2]
    out["ate_rmse_aligned"] = float(np.sqrt(np.mean(np.sum(da**2, axis=1))))

    if est_landmarks is not None and gt_landmarks is not None:
        est_l = np.asarray(est_landmarks, np.float64)
        gt_l = np.asarray(gt_landmarks, np.float64)
        valid = np.all(np.isfinite(gt_l), axis=1)
        if valid.any():
            dl = est_l[valid] - gt_l[valid]
            out["lm_rmse"] = float(np.sqrt(np.mean(np.sum(dl**2, axis=1))))
            dla = est_l[valid] @ R.T + t - gt_l[valid]
            out["lm_rmse_aligned"] = float(np.sqrt(np.mean(np.sum(dla**2, axis=1))))
    return out


def match_gt_landmarks(meta, gt_parsed) -> np.ndarray:
    """Ground-truth landmark array in *our* landmark index order.

    Rows are NaN for landmarks absent from the ground-truth file.
    """
    gt_map = {int(lid): xy for lid, xy in zip(gt_parsed.lm_ids, gt_parsed.lm_xy)}
    out = np.full((len(meta.lm_ids), 2), np.nan, np.float64)
    for ix, lid in enumerate(meta.lm_ids):
        if lid in gt_map:
            out[ix] = gt_map[lid]
    return out


def match_gt_poses(meta, gt_parsed) -> np.ndarray:
    """Ground-truth pose array in our pose index order (ids must all exist)."""
    gt_map = {
        int(pid): xyt for pid, xyt in zip(gt_parsed.pose_ids, gt_parsed.pose_xyt)
    }
    return np.stack([gt_map[pid] for pid in meta.pose_ids])
