"""Checkpoint and resume (port of ``boslam/io/checkpoint.py``).

An npz snapshot of the solver state: poses, landmarks, the id sets of the
problem, the iteration counter, the LM damping and the last outer delta of
the packed path.  The keys and dtypes are the JAX package's, so a file
written by either package loads in the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from boslam_torch.device import host_sync
from boslam_torch.graph.data import FactorGraph, GraphMeta


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_npz(path: str, graph: FactorGraph, meta: GraphMeta, iteration: int = 0,
             lm_lambda: Optional[float] = None, dp=None) -> None:
    """``dp`` is the last outer iteration's pose delta: saving it makes a
    resumed ``cg_warm_start`` run iteration-exact (the first resumed CG
    warm-starts from the vector the uninterrupted run used)."""
    with host_sync(graph.device):
        poses, landmarks = _host(graph.poses), _host(graph.landmarks)
        dp = np.zeros((0, 3), np.float32) if dp is None else _host(dp)
    np.savez_compressed(
        path,
        poses=poses,
        landmarks=landmarks,
        pose_ids=np.asarray(meta.pose_ids, np.int64),
        lm_ids=np.asarray(meta.lm_ids, np.int64),
        fixed_pose_id=np.int64(meta.fixed_pose_id),
        bound=np.float64(meta.bound),
        iteration=np.int64(iteration),
        lm_lambda=np.float64(-1.0 if lm_lambda is None else lm_lambda),
        dp=dp,
    )


def load_npz(path: str, graph: FactorGraph, meta: GraphMeta
             ) -> Tuple[FactorGraph, GraphMeta, int, Optional[float], Optional[np.ndarray]]:
    """Restore the state into an existing problem (the edges come from the
    g2o), on the graph's device.

    Refuses a checkpoint of another problem (other id sets) with
    ``ValueError``.  Returns (graph, meta, iteration, lm_lambda, dp); ``dp``
    is the saved warm-start delta as numpy, or None when absent.
    """
    z = np.load(path)
    if list(z["pose_ids"]) != meta.pose_ids or list(z["lm_ids"]) != meta.lm_ids:
        raise ValueError(f"checkpoint {path} belongs to a different problem")
    with host_sync(graph.device):
        g = graph.with_state(
            torch.as_tensor(z["poses"], dtype=graph.poses.dtype, device=graph.device),
            torch.as_tensor(z["landmarks"], dtype=graph.landmarks.dtype, device=graph.device),
        )
    lam = float(z["lm_lambda"])
    dp = None
    if "dp" in z.files and z["dp"].shape[0] == graph.n_poses:
        dp = z["dp"]
    return g, meta, int(z["iteration"]), (None if lam < 0 else lam), dp
