"""g2o SLAM-2D file front-end (numpy; PyTorch port of ``boslam/io/g2o.py``).

Record grammar of the reference's ``utils/g2o_utils``:

- ``VERTEX_SE2 id x y theta``
- ``VERTEX_XY id x y``            (ground truth)
- ``FIX id``                      (at most one honored, last wins)
- ``EDGE_SE2 i j x y theta  o11 o12 o13 o22 o23 o33`` — upper-triangular
  information matrix, row-major, mirrored
- ``EDGE_BEARING_SE2_XY id_pose id_lm bearing <ignored>`` — the 4th numeric
  field is deliberately ignored and the bearing information weight is 1

Parity details kept: unknown tokens are warned about, the symmetric plot
bound tracks max |x|,|y| over both vertex types with a +3 margin, and
empty inputs warn.  This module is the pure-Python parser only; the JAX
package's native tokenizer has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("boslam_torch.io")


@dataclasses.dataclass
class ParsedG2O:
    """Raw parse result: ids are original file ids, not yet contiguous."""

    pose_ids: List[int]
    pose_xyt: np.ndarray  # f32[NP, 3] in file order
    lm_ids: List[int]
    lm_xy: np.ndarray  # f32[NL, 2] in file order (VERTEX_XY records)
    bearing_pose_id: np.ndarray  # i64[NB]
    bearing_lm_id: np.ndarray  # i64[NB]
    bearing_meas: np.ndarray  # f32[NB]
    bearing_omega: np.ndarray  # f32[NB]
    odom_src_id: np.ndarray  # i64[NO]
    odom_dst_id: np.ndarray  # i64[NO]
    odom_meas: np.ndarray  # f32[NO, 3]
    odom_omega: np.ndarray  # f32[NO, 3, 3]
    fixed_pose_id: int  # -1 if no FIX record
    bound: float  # max-abs coordinate + 3

    @property
    def n_poses(self) -> int:
        return len(self.pose_ids)


def parse_g2o_text(text: str) -> ParsedG2O:
    """Parse the contents of a g2o file."""
    pose_ids: List[int] = []
    pose_xyt: List[Tuple[float, float, float]] = []
    lm_ids: List[int] = []
    lm_xy: List[Tuple[float, float]] = []
    b_pose: List[int] = []
    b_lm: List[int] = []
    b_meas: List[float] = []
    o_src: List[int] = []
    o_dst: List[int] = []
    o_meas: List[Tuple[float, float, float]] = []
    o_omega: List[np.ndarray] = []
    fixed_pose_id = -1
    bound = 0.0

    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        tag = tok[0]
        if tag == "VERTEX_SE2":
            x, y, theta = float(tok[2]), float(tok[3]), float(tok[4])
            bound = max(bound, abs(x), abs(y))
            pose_ids.append(int(tok[1]))
            pose_xyt.append((x, y, theta))
        elif tag == "VERTEX_XY":
            x, y = float(tok[2]), float(tok[3])
            bound = max(bound, abs(x), abs(y))
            lm_ids.append(int(tok[1]))
            lm_xy.append((x, y))
        elif tag == "FIX":
            fixed_pose_id = int(tok[1])
        elif tag == "EDGE_SE2":
            o_src.append(int(tok[1]))
            o_dst.append(int(tok[2]))
            o_meas.append((float(tok[3]), float(tok[4]), float(tok[5])))
            o11, o12, o13, o22, o23, o33 = (float(t) for t in tok[6:12])
            o_omega.append(
                np.array(
                    [[o11, o12, o13], [o12, o22, o23], [o13, o23, o33]],
                    dtype=np.float32,
                )
            )
        elif tag == "EDGE_BEARING_SE2_XY":
            b_pose.append(int(tok[1]))
            b_lm.append(int(tok[2]))
            b_meas.append(float(tok[3]))
        else:
            log.warning("Unrecognized %s", tag)

    bound += 3.0

    if not pose_ids:
        log.warning("no poses found; downstream is likely to break")
    if not b_meas:
        log.warning("no bearing observations found; downstream is likely to break")

    nb, no = len(b_meas), len(o_meas)
    return ParsedG2O(
        pose_ids=pose_ids,
        pose_xyt=np.asarray(pose_xyt, dtype=np.float32).reshape(len(pose_ids), 3),
        lm_ids=lm_ids,
        lm_xy=np.asarray(lm_xy, dtype=np.float32).reshape(len(lm_ids), 2),
        bearing_pose_id=np.asarray(b_pose, dtype=np.int64),
        bearing_lm_id=np.asarray(b_lm, dtype=np.int64),
        bearing_meas=np.asarray(b_meas, dtype=np.float32),
        bearing_omega=np.ones(nb, dtype=np.float32),
        odom_src_id=np.asarray(o_src, dtype=np.int64),
        odom_dst_id=np.asarray(o_dst, dtype=np.int64),
        odom_meas=np.asarray(o_meas, dtype=np.float32).reshape(no, 3),
        odom_omega=(
            np.stack(o_omega) if o_omega else np.zeros((0, 3, 3), dtype=np.float32)
        ),
        fixed_pose_id=fixed_pose_id,
        bound=bound,
    )


def parse_g2o(path: str) -> ParsedG2O:
    """Parse a g2o file."""
    with open(path) as f:
        return parse_g2o_text(f.read())


def write_g2o(
    path: str,
    pose_ids,
    pose_xyt,
    lm_ids,
    lm_xy,
    parsed: Optional[ParsedG2O] = None,
    fixed_pose_id: Optional[int] = None,
) -> None:
    """Write a state back out as g2o.

    Vertices are emitted with original ids; if ``parsed`` is given its edges
    and FIX record are re-emitted so the output is a complete problem.
    """
    pose_xyt = np.asarray(pose_xyt, dtype=np.float64)
    lm_xy = np.asarray(lm_xy, dtype=np.float64)
    lines: List[str] = []
    for lid, (x, y) in zip(lm_ids, lm_xy):
        lines.append(f"VERTEX_XY {int(lid)} {x:.9g} {y:.9g}")
    for pid, (x, y, t) in zip(pose_ids, pose_xyt):
        lines.append(f"VERTEX_SE2 {int(pid)} {x:.9g} {y:.9g} {t:.9g}")
    if fixed_pose_id is None and parsed is not None:
        fixed_pose_id = parsed.fixed_pose_id
    if fixed_pose_id is not None and fixed_pose_id >= 0:
        lines.append(f"FIX {int(fixed_pose_id)}")
    if parsed is not None:
        for i in range(len(parsed.bearing_meas)):
            lines.append(
                "EDGE_BEARING_SE2_XY "
                f"{int(parsed.bearing_pose_id[i])} {int(parsed.bearing_lm_id[i])} "
                f"{float(parsed.bearing_meas[i]):.9g}"
            )
        for i in range(len(parsed.odom_meas)):
            m = parsed.odom_meas[i]
            om = parsed.odom_omega[i]
            lines.append(
                "EDGE_SE2 "
                f"{int(parsed.odom_src_id[i])} {int(parsed.odom_dst_id[i])} "
                f"{m[0]:.9g} {m[1]:.9g} {m[2]:.9g} "
                f"{om[0,0]:.9g} {om[0,1]:.9g} {om[0,2]:.9g} "
                f"{om[1,1]:.9g} {om[1,2]:.9g} {om[2,2]:.9g}"
            )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
