"""Host-side graph construction: ids -> contiguous indices, init landmarks
(port of ``boslam/graph/build.py``).

Pipeline: parse -> default the fixed pose to the first-added pose when no
FIX record exists -> triangulate landmark initial guesses -> build the
device-side problem.  When triangulating, landmarks are ordered by id;
from VERTEX_XY records they keep file order.  A build is the span
"build", with "ids" (the host's sorted id lookups and index arrays),
"upload" and "triangulate" under it (``utils/spans.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from boslam_torch.device import resolve_device
from boslam_torch.graph.data import FactorGraph, GraphMeta
from boslam_torch.init.triangulation import triangulate_landmarks, warn_underconstrained
from boslam_torch.io.g2o import ParsedG2O
from boslam_torch.utils.spans import span


class _IdIndex:
    """Original ids -> their position in ``ids``, as a dict built over
    ``ids`` maps them (a repeated id maps to its last position), by a
    binary search over the ids sorted stably; an absent id raises
    ``KeyError`` naming the first one."""

    def __init__(self, ids):
        ids = np.asarray(ids, np.int64)
        self._order = np.argsort(ids, kind="stable")
        self._sorted = ids[self._order]

    def __call__(self, query) -> np.ndarray:
        query = np.asarray(query, np.int64)
        pos = np.searchsorted(self._sorted, query, side="right") - 1
        found = pos >= 0
        found[found] = self._sorted[pos[found]] == query[found]
        if not found.all():
            raise KeyError(int(query[np.argmin(found)]))
        return self._order[pos].astype(np.int64, copy=False)


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
    Pose-graph initialization is applied after the build, by
    ``init.pose_graph.pgo_initialize``.  ``device`` defaults to ``cuda``.
    """
    device = resolve_device(device)
    with span("build"):
        with span("ids"):
            if init == "auto":
                init = "file" if len(parsed.lm_ids) else "triangulate"
            pose_ids = parsed.pose_ids
            pose_ix = _IdIndex(pose_ids)
            b_pose = pose_ix(parsed.bearing_pose_id)
            if init == "file":
                lm_ids = list(parsed.lm_ids)
                b_lm = _IdIndex(lm_ids)(parsed.bearing_lm_id)
            elif init == "triangulate":
                lm_ids, b_lm = np.unique(np.asarray(parsed.bearing_lm_id, np.int64),
                                         return_inverse=True)
                lm_ids, b_lm = lm_ids.tolist(), b_lm.astype(np.int64, copy=False)
            else:
                raise ValueError(f"unknown init {init!r}")
            o_src = pose_ix(parsed.odom_src_id)
            o_dst = pose_ix(parsed.odom_dst_id)
            fixed_pose_id = parsed.fixed_pose_id
            if fixed_pose_id < 0:
                fixed_pose_id = pose_ids[0]
            fixed_pose_ix = pose_ix([fixed_pose_id])[0]

        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        with span("upload"):
            edges = dict(
                b_pose=i64(b_pose),
                b_lm=i64(b_lm),
                b_meas=f32(parsed.bearing_meas),
                b_omega=f32(parsed.bearing_omega),
                o_src=i64(o_src),
                o_dst=i64(o_dst),
                o_meas=f32(parsed.odom_meas),
                o_omega=f32(parsed.odom_omega),
                fixed_pose_ix=i64(fixed_pose_ix),
            )
            poses = f32(parsed.pose_xyt)
            if init == "file":
                landmarks = f32(parsed.lm_xy)

        if init == "triangulate":
            with span("triangulate"):
                landmarks = triangulate_landmarks(poses, edges["b_pose"], edges["b_lm"],
                                                  edges["b_meas"], n_landmarks=len(lm_ids))
                warn_underconstrained(lm_ids, b_lm, len(lm_ids))

    graph = FactorGraph(poses=poses, landmarks=landmarks, **edges)
    meta = GraphMeta.from_ids(pose_ids, lm_ids, fixed_pose_id, parsed.bound)
    return graph, meta
