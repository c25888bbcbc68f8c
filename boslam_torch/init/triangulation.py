"""Landmark triangulation from bearing rays (port of
``boslam/init/triangulation.py``).

Each bearing observation gives one line equation
``sin(theta+alpha) * x - cos(theta+alpha) * y = sin(theta+alpha) * px -
cos(theta+alpha) * py``.  With unit-norm rows the per-landmark 2x2 normal
equations are segment sums over the flat edge arrays, followed by one
batched guarded 2x2 solve.  Collinear rays (rank-1 normal matrix) give the
minimum-norm point on the constraint line.

The arithmetic runs in f64 (the angle, its sine and cosine, the per-edge
parts, the sums, the rank test and both branches of the solve) and the
result is cast to f32.  The JAX package does all of it in f32.  The sums
are an ``index_add_``, which is atomic on a CUDA device, so their order
changes from run to run; near-collinear rays amplify that rounding, and
in f32 it moved landmarks of a 10k-pose walk by up to 0.2 between two runs
on the card.  In f64 the order and the ulp of the card's sine and cosine
stay below the f32 cast: the card, the CPU and any order of the edges give
the same f32 landmarks, or one f32 ulp apart where an f64 result lies at a
rounding boundary.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger("boslam_torch.init")

# Rank threshold for the 2x2 normal matrix: below it the rays are treated
# as collinear and the min-norm solution is used.
_DEGENERATE_RTOL = 1e-7


def triangulate_landmarks(poses, b_pose_ix, b_lm_ix, b_meas, *, n_landmarks: int):
    """Triangulate all landmarks at once: returns f32[NL, 2] (summed and
    solved in f64)."""
    p = poses[b_pose_ix].double()
    ang = p[:, 2] + b_meas.double()  # theta + alpha
    s, c = torch.sin(ang), torch.cos(ang)
    rhs = s * p[:, 0] - c * p[:, 1]

    parts = torch.stack([s * s, -s * c, c * c, s * rhs, -c * rhs], dim=1)
    sums = torch.zeros((n_landmarks, 5), dtype=torch.float64, device=poses.device)
    sums.index_add_(0, b_lm_ix, parts)
    A00, A01, A11, B0, B1 = sums.unbind(1)

    det = A00 * A11 - A01 * A01
    tr = A00 + A11  # == number of observations (rows have unit norm)
    ok = det > _DEGENERATE_RTOL * tr * tr

    safe_det = torch.where(ok, det, torch.ones_like(det))
    x_ok = (A11 * B0 - A01 * B1) / safe_det
    y_ok = (A00 * B1 - A01 * B0) / safe_det

    # rank-1: x = (A^T A)(A^T b) / tr^2
    safe_tr = torch.clamp(tr, min=torch.finfo(tr.dtype).tiny)
    x_deg = (A00 * B0 + A01 * B1) / (safe_tr * safe_tr)
    y_deg = (A01 * B0 + A11 * B1) / (safe_tr * safe_tr)

    xy = torch.stack([torch.where(ok, x_ok, x_deg), torch.where(ok, y_ok, y_deg)], dim=-1)
    return xy.to(torch.float32)


def warn_underconstrained(lm_ids, b_lm_ix: np.ndarray, n_landmarks: int) -> list:
    """Log and return the original ids of single-observation landmarks."""
    counts = np.bincount(np.asarray(b_lm_ix), minlength=n_landmarks)
    bad = [int(lm_ids[i]) for i in np.nonzero(counts == 1)[0]]
    for lid in bad:
        log.warning(
            "Landmark no. %d only has one observation; "
            "bearing-only SLAM won't be able to locate it properly.",
            lid,
        )
    return bad
