"""Headless visualization (port of ``boslam/viz/draw.py``, the rebuild of
the reference's ``utils/draw_utils.{hpp,cpp}``).

The reference draws into an 800x800 OpenCV window: red pose circles with a
heading ray (draw_utils.cpp:61-82), blue landmark squares (:84-101), green
bearing rays of fixed pixel length (:103-128), purple odometry segments
with a heading tick at the predicted destination, under the source-frame
translation convention (:130-156), and a world->image mapping with a
y-flip only when a positive bound is given (:47-59), plus an
iteration-indicator bar (executables/bearing_only_slam.cpp:27-29).

Here the same scene renders through matplotlib's Agg backend into a PNG
(headless; the interactive loop is in ``boslam_torch/cli.py``).  Inputs
are host numpy arrays.  matplotlib is imported inside the functions only,
so importing this module needs nothing beyond numpy.  Colors mirror the
reference's #defines (draw_utils.cpp:3-14).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# reference palette (draw_utils.cpp:3-14, BGR -> matplotlib names)
POSE_COLOR = "#cc0000"  # red circle + heading ray
LM_COLOR = "#0000cc"  # blue square
BEARING_COLOR = "#00aa00"  # green ray
ODOM_COLOR = "#800080"  # purple segment
BEARING_RAY_LEN_FRAC = 50.0 / 800.0  # 50 px on the 800 px canvas (:11,:122)
ODOM_TICK_LEN_FRAC = 4.0 / 800.0  # ODOMETRY_LEN = 4 px (draw_utils.cpp:14)


def render_state(
    poses: np.ndarray,
    landmarks: np.ndarray,
    *,
    bound: Optional[float] = None,
    bearings: Optional[tuple] = None,  # (pose_ix, meas)
    odometries: Optional[tuple] = None,  # (src_ix, meas[NO,3])
    iteration: Optional[int] = None,
    max_iterations: int = 50,
    draw_only_pose: Optional[int] = None,
    draw_only_lm: Optional[int] = None,
    ax=None,
):
    """Draw the scene onto a matplotlib axes (created if None); returns ax.

    ``draw_only_pose`` / ``draw_only_lm`` are the reference's aggressive
    debug filters (``DRAW_ONLY_POSE/LM``, framework/definitions.hpp:10-11;
    applied in draw_utils.cpp:174-196): when given (>= 0 there, not-None
    here) only the bearing/odometry overlays touching that pose/landmark
    INDEX are drawn — poses and landmarks themselves stay visible, exactly
    as in the reference (the filters guard only the observation loops).
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    poses = np.asarray(poses)
    landmarks = np.asarray(landmarks)
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))
    if bound is None or bound <= 0:
        # no mapping: raw coordinates (draw_utils.cpp:47-52 "bound <= 0")
        coords = np.concatenate([poses[:, :2], landmarks]) if len(landmarks) else poses[:, :2]
        bound = float(np.abs(coords).max()) + 3.0
    ax.set_xlim(-bound, bound)
    ax.set_ylim(-bound, bound)
    ax.set_aspect("equal")

    ray_len = 2 * bound * BEARING_RAY_LEN_FRAC

    # bearing rays (green, fixed length, from the observing pose at
    # world angle theta + alpha — draw_utils.cpp:103-128)
    if bearings is not None:
        b_pose, b_meas = bearings[0], bearings[1]
        b_lm = bearings[2] if len(bearings) > 2 else None
        keep = np.ones(len(np.asarray(b_pose)), bool)
        if draw_only_pose is not None:
            keep &= np.asarray(b_pose) == draw_only_pose
        if draw_only_lm is not None and b_lm is not None:
            keep &= np.asarray(b_lm) == draw_only_lm
        b_pose, b_meas = np.asarray(b_pose)[keep], np.asarray(b_meas)[keep]
        p = poses[np.asarray(b_pose)]
        ang = p[:, 2] + np.asarray(b_meas)
        # one LineCollection for all rays: a per-ray ax.plot loop issues
        # O(edges) draw calls, minutes at 100k poses
        ends = p[:, :2] + ray_len * np.stack([np.cos(ang), np.sin(ang)], 1)
        segs = np.stack([p[:, :2], ends], axis=1)  # [NB, 2, 2]
        ax.add_collection(LineCollection(
            segs, colors=BEARING_COLOR, linewidths=0.3, alpha=0.5, zorder=1,
        ))

    # odometry segments (purple) from source pose to the predicted
    # destination under the source-frame convention (draw_utils.cpp:130-156)
    if odometries is not None:
        o_src, o_meas = odometries
        o_src, o_meas = np.asarray(o_src), np.asarray(o_meas)
        if draw_only_pose is not None:
            keep = o_src == draw_only_pose  # source-id filter (:186-189)
            o_src, o_meas = o_src[keep], o_meas[keep]
        s = poses[np.asarray(o_src)]
        o_meas = np.asarray(o_meas)
        c, sn = np.cos(s[:, 2]), np.sin(s[:, 2])
        dx = c * o_meas[:, 0] - sn * o_meas[:, 1]
        dy = sn * o_meas[:, 0] + c * o_meas[:, 1]
        # heading tick at the predicted destination (draw_utils.cpp:151:
        # draw_line_ray(dest, ODOMETRY_LEN, src_theta + trasf.z, ...))
        tick = 2 * bound * ODOM_TICK_LEN_FRAC
        dth = s[:, 2] + o_meas[:, 2]
        dest = s[:, :2] + np.stack([dx, dy], 1)
        tick_end = dest + tick * np.stack([np.cos(dth), np.sin(dth)], 1)
        segs = np.concatenate([
            np.stack([s[:, :2], dest], axis=1),  # segment src -> predicted dst
            np.stack([dest, tick_end], axis=1),  # heading tick at the dst
        ])
        ax.add_collection(LineCollection(
            segs, colors=ODOM_COLOR, linewidths=0.8, zorder=2,
        ))

    # landmarks: blue squares (draw_utils.cpp:84-101)
    if len(landmarks):
        ax.scatter(
            landmarks[:, 0], landmarks[:, 1],
            marker="s", s=25, color=LM_COLOR, zorder=3, label="landmarks",
        )

    # poses: red circles + heading rays (draw_utils.cpp:61-82)
    ax.scatter(
        poses[:, 0], poses[:, 1], s=12, facecolors="none",
        edgecolors=POSE_COLOR, zorder=4, label="poses",
    )
    hl = ray_len * 0.4
    heads = poses[:, :2] + hl * np.stack(
        [np.cos(poses[:, 2]), np.sin(poses[:, 2])], 1
    )
    ax.add_collection(LineCollection(
        np.stack([poses[:, :2], heads], axis=1),
        colors=POSE_COLOR, linewidths=0.5, zorder=4,
    ))

    # iteration-indicator bar (bearing_only_slam.cpp:27-29)
    if iteration is not None:
        frac = min(1.0, iteration / max(1, max_iterations))
        ax.plot(
            [-bound, -bound + 2 * bound * frac],
            [bound * 0.98, bound * 0.98],
            color="black", lw=3, zorder=5,
        )
        ax.set_title(f"iteration {iteration}")
    return ax


def save_render(path: str, *args, **kwargs) -> None:
    """Render to a PNG file (the headless replacement for cv::imshow)."""
    import matplotlib.pyplot as plt

    ax = render_state(*args, **kwargs)
    ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(ax.figure)
