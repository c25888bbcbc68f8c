"""Host-side graph construction: ids -> contiguous indices, init landmarks
(port of ``boslam/graph/build.py``).

Pipeline: parse -> default the fixed pose to the first-added pose when no
FIX record exists -> triangulate landmark initial guesses -> build the
device-side problem.  When triangulating, landmarks are ordered by id;
from VERTEX_XY records they keep file order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from boslam_torch.device import resolve_device
from boslam_torch.graph.data import FactorGraph, GraphMeta
from boslam_torch.init.triangulation import triangulate_landmarks, warn_underconstrained
from boslam_torch.io.g2o import ParsedG2O


def build_graph(
    parsed: ParsedG2O,
    *,
    init: str = "auto",
    device=None,
) -> Tuple[FactorGraph, GraphMeta]:
    """Build the device-side problem from a parse result.

    ``init``: "triangulate" (landmarks are the ids observed by bearing
    edges, initialized by triangulation), "file" (VERTEX_XY records),
    "auto" ("file" when VERTEX_XY records exist, else "triangulate").
    "pose_graph" is not ported yet.  ``device`` defaults to ``cuda``.
    """
    device = resolve_device(device)
    edges = parsed

    if init == "auto":
        init = "file" if len(parsed.lm_ids) else "triangulate"
    if init == "pose_graph":
        raise NotImplementedError("pose-graph initialization is not ported yet")

    pose_ids = parsed.pose_ids
    pose_id_to_ix = {pid: ix for ix, pid in enumerate(pose_ids)}

    if init == "file":
        lm_ids = list(parsed.lm_ids)
    elif init == "triangulate":
        lm_ids = sorted(set(int(i) for i in edges.bearing_lm_id))
    else:
        raise ValueError(f"unknown init {init!r}")
    lm_id_to_ix = {lid: ix for ix, lid in enumerate(lm_ids)}

    b_pose = np.array([pose_id_to_ix[int(i)] for i in edges.bearing_pose_id], np.int64)
    b_lm = np.array([lm_id_to_ix[int(i)] for i in edges.bearing_lm_id], np.int64)
    o_src = np.array([pose_id_to_ix[int(i)] for i in edges.odom_src_id], np.int64)
    o_dst = np.array([pose_id_to_ix[int(i)] for i in edges.odom_dst_id], np.int64)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    poses = f32(parsed.pose_xyt)
    b_meas = f32(edges.bearing_meas)

    if init == "file":
        landmarks = f32(parsed.lm_xy)
    else:
        landmarks = triangulate_landmarks(
            poses, i64(b_pose), i64(b_lm), b_meas, n_landmarks=len(lm_ids)
        )
        warn_underconstrained(lm_ids, b_lm, len(lm_ids))

    fixed_pose_id = parsed.fixed_pose_id
    if fixed_pose_id < 0:
        fixed_pose_id = pose_ids[0]

    graph = FactorGraph(
        poses=poses,
        landmarks=landmarks,
        b_pose=i64(b_pose),
        b_lm=i64(b_lm),
        b_meas=b_meas,
        b_omega=f32(edges.bearing_omega),
        o_src=i64(o_src),
        o_dst=i64(o_dst),
        o_meas=f32(edges.odom_meas),
        o_omega=f32(edges.odom_omega),
        fixed_pose_ix=i64(pose_id_to_ix[fixed_pose_id]),
    )
    meta = GraphMeta.from_ids(pose_ids, lm_ids, fixed_pose_id, parsed.bound)
    return graph, meta
