"""Landmark locality reordering, host-side once per solve (port of
``boslam/graph/reorder.py``).

Relabeling landmarks by their mean observing pose index makes consecutive
poses see consecutive landmark indices, after which both slot grids of the
dual packing are banded and the windowed gather applies
(``ops/windowed_gather.py``).  The solve unmaps the order on the way out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boslam_torch.graph.data import FactorGraph


def reorder_landmarks_by_pose(g: FactorGraph) -> tuple[FactorGraph, np.ndarray, np.ndarray]:
    """Relabel landmarks by mean observing pose index.

    Returns (reordered graph, perm, inv) with ``new[i] = old[perm[i]]`` and
    ``old[j] = new[inv[j]]``; unmap results with ``landmarks[inv]``.  Reads
    the edges back to the host.
    """
    b_lm = g.b_lm.cpu().numpy()
    b_pose = g.b_pose.cpu().numpy().astype(np.float64)
    NL = g.n_landmarks
    sums = np.zeros(NL, np.float64)
    counts = np.zeros(NL, np.float64)
    np.add.at(sums, b_lm, b_pose)
    np.add.at(counts, b_lm, 1.0)
    # unobserved landmarks sort last (they touch no edge, any order works)
    mean = np.where(counts > 0, sums / np.maximum(counts, 1.0), np.inf)
    perm = np.argsort(mean, kind="stable").astype(np.int64)
    inv = np.empty(NL, np.int64)
    inv[perm] = np.arange(NL)
    dev = g.device
    g2 = dataclasses.replace(
        g,
        landmarks=g.landmarks[torch.as_tensor(perm, device=dev)],
        b_lm=torch.as_tensor(inv, dtype=g.b_lm.dtype, device=dev)[g.b_lm],
    )
    return g2, perm, inv
