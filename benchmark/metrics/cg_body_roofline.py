"""The fused CG body's share of its memory roofline in the traced solve, in
percent: the time the bytes its bodies must move take at the H100's HBM
rate, over the summed device time of the four kernels of the body
(``pcg_*`` in the trace's ``device_ops``).  Over 100 the bytes are counted
too high or the time misses part of the work.

A body's bytes are counted here, from the graph's own unpadded sizes
(``graph_sizes``), never from the program's slot layout, so that the bound
reads the same work whatever implements the body (``body_bytes``).  The
bodies are the program's counter "cg.fused_bodies" of the traced solves'
"solve_packed" roots.  Nothing where any of the four kernels is missing
from the trace (a program without the fused body, or a body of other
kernels), or where the program counts no fused body."""

import numpy as np

from benchmark.harness import program_spans

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
KERNELS = ("pcg_lm_rows_kernel", "pcg_pose_rows_kernel", "pcg_update_kernel",
           "pcg_commit_kernel")


def graph_sizes(parsed) -> tuple:
    """(bearing edges, poses, landmarks, chain edges, loop-closure edges) of
    a generated input: the landmarks its bearing edges observe, a chain
    edge one from a pose to the next in the input's pose order, every other
    odometry edge a loop closure."""
    pos = {pid: k for k, pid in enumerate(parsed.pose_ids)}
    src = np.array([pos[int(i)] for i in parsed.odom_src_id], np.int64)
    dst = np.array([pos[int(i)] for i in parsed.odom_dst_id], np.int64)
    n_chain = int(np.count_nonzero(dst == src + 1))
    return (len(parsed.bearing_meas), len(parsed.pose_ids),
            len(np.unique(parsed.bearing_lm_id)), n_chain, len(src) - n_chain)


def body_bytes(n_bearing: int, n_poses: int, n_landmarks: int, n_chain: int,
               n_loops: int) -> float:
    """The bytes one block-Jacobi CG body on the reduced pose system must
    read and write, each input once, f32 values and i32 indices:

    - a bearing edge: its 3x2 pose-landmark coupling block and its two
      vertices (24 + 8);
    - a pose: its 3x3 diagonal block and block-Jacobi inverse, its gauge
      mask (36 + 36 + 4), the state read (iterate, residual, direction,
      best iterate: 4 x 12) and written (those and the preconditioned
      residual: 5 x 12);
    - a landmark: its 2x2 inverse (16);
    - a chain edge: its 3x3 coupling (36, its poses implied);
    - a loop closure: its 3x3 coupling and its two poses (36 + 8)."""
    return float(32 * n_bearing + 184 * n_poses + 16 * n_landmarks + 36 * n_chain
                 + 44 * n_loops)


def _kernel_seconds(trace) -> float | None:
    """The summed device time of the body's four kernels, or None where one
    is missing."""
    times = [sum(s for name, s in trace.device_ops if k in name) for k in KERNELS]
    return sum(times) if all(t > 0 for t in times) else None


def read(run):
    if run.trace is None or not run.traced:
        return None
    seconds = _kernel_seconds(run.trace)
    spans = program_spans.ring()
    if seconds is None or spans is None:
        return None
    roots = [r for r in spans.records() if r.name == "solve_packed"]
    nbytes, counted = 0.0, False
    for a in run.traced:
        lo, hi = int(a.t0 * 1e9), int(a.t_end * 1e9)
        mine = [r for r in roots if lo <= r.start_ns <= hi]
        counted = counted or any("cg.fused_bodies" in r.counters for r in mine)
        bodies = program_spans.counted(mine, "cg.fused_bodies")
        nbytes += bodies * body_bytes(*graph_sizes(run.pool[a.graph][1]))
    if not counted:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
