"""Dual-packed (CSR-style) edge layout for the scale path (port of
``boslam/graph/packed.py``).

Bearing edges are packed into dense per-vertex slot grids, so every
vertex-keyed reduction is a masked sum over the slot axis and each side
needs one row gather:

- pose-packed [NP, K] slots (K = max bearing edges per pose): the pose of
  slot (p, k) is p, a broadcast; only landmark states are gathered;
- landmark-packed [NLV, K2] slots: the landmark is broadcast, poses are
  gathered.  Landmarks observed more often than the slot cap own several
  consecutive virtual rows (``l_virt``: virtual row -> landmark).

Padding slots carry omega = 0 (and index 0) and contribute exactly zero.
The leading chain prefix of the odometry (edge e: src == e, dst == e + 1)
makes its couplings shifts; edges past it go through a small gather and
segment sum.  Packing is numpy on the host, once per solve; the grids then
go to the graph's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from boslam_torch.device import resolve_device
from boslam_torch.graph.data import FactorGraph
from boslam_torch.ops.windowed_gather import WindowPlan, plan_windows

_GRIDS = ("p_lm", "p_meas", "p_omega", "l_pose", "l_meas", "l_omega")


@dataclasses.dataclass
class PackedEdges:
    """Bearing edges in both packings + odometry chain classification.

    ``chain_len`` is the length of the maximal leading chain prefix;
    ``odometry_is_chain`` says the prefix is the whole edge list and spans
    every pose.  Both are host values.  ``p_plan`` / ``l_plan`` are the
    windowed-gather plans of the two grids (None: plain gathers);
    ``l_virt`` i32[NLV] maps landmark-grid rows to landmarks (None: one row
    per landmark).
    """

    p_lm: torch.Tensor  # i32 [NP, K] landmark index per slot (0 for padding)
    p_meas: torch.Tensor  # f32 bearing
    p_omega: torch.Tensor  # f32 information (0 = padding)
    l_pose: torch.Tensor  # i32 [NLV, K2] pose index per slot
    l_meas: torch.Tensor
    l_omega: torch.Tensor
    odometry_is_chain: bool
    chain_len: int = 0
    p_plan: Optional[WindowPlan] = None
    l_plan: Optional[WindowPlan] = None
    l_virt: Optional[torch.Tensor] = None

    @property
    def K(self) -> int:
        return self.p_lm.shape[1]

    @property
    def K2(self) -> int:
        return self.l_pose.shape[1]

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "PackedEdges":
        """Build from a dict of numpy arrays and host values keyed by field.

        This carries a packing across from the JAX package
        (``dataclasses.asdict`` of its ``PackedEdges``, arrays through
        ``np.asarray``; a plan is then a dict of ``starts``, ``window`` and
        ``tile_rows``), so that both packages compute on one packing.  The
        tensors go to ``cuda`` unless ``device`` says otherwise.
        """
        device = resolve_device(device)

        def tensor(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        def plan(p):
            if p is None:
                return None
            return WindowPlan(tensor(p["starts"], torch.int32), int(p["window"]),
                              int(p["tile_rows"]))

        kw = {k: tensor(arrays[k], torch.int32 if k in ("p_lm", "l_pose") else torch.float32)
              for k in _GRIDS}
        virt = arrays.get("l_virt")
        return cls(**kw, odometry_is_chain=bool(arrays["odometry_is_chain"]),
                   chain_len=int(arrays["chain_len"]), p_plan=plan(arrays.get("p_plan")),
                   l_plan=plan(arrays.get("l_plan")),
                   l_virt=None if virt is None else tensor(virt, torch.int32))


@dataclasses.dataclass
class PackedMeta:
    odometry_is_chain: bool
    fill_pose: float  # fraction of pose-packed slots that are real edges
    fill_lm: float
    windowed: bool = False  # windowed-gather plans built for both grids
    lm_split_cap: Optional[int] = None  # K2 cap when hot landmarks split
    n_virt_rows: Optional[int] = None  # landmark-grid rows (NLV) when split


# Cost weight of one extra virtual row, in padded-slot equivalents (the
# JAX package's figure, measured on its TPU; kept so both pack alike).
_ROW_COST_SLOTS = 8


def _choose_split_cap(counts: np.ndarray) -> Optional[int]:
    """The landmark-grid slot cap minimizing rows*(cap + row_cost), or None
    (no split) unless it beats the plain [NL, max] layout by >15%."""
    kmax = max(1, int(counts.max()))
    if kmax <= 8:
        return None

    def cost(cap):
        rows = int(np.maximum(1, -(-counts // cap)).sum())
        return rows * (cap + _ROW_COST_SLOTS)

    candidates = [c for c in (8, 16, 32, 64, 128, 256) if c < kmax]
    if not candidates:
        return None
    best = min(candidates, key=cost)
    return best if cost(best) < 0.85 * cost(kmax) else None


def pack_edges(g: FactorGraph, windows: bool = False,
               split_lm: "int | str | None" = "auto") -> tuple[PackedEdges, PackedMeta]:
    """Host-side packing (numpy), the result on the graph's device.

    ``windows=True`` also plans windowed gathers for both slot grids (the
    caller has locality-reordered the landmarks, ``graph/reorder.py``); a
    grid without usable locality keeps its plain gather.  ``split_lm``: "auto"
    picks the landmark-grid slot cap from the observation counts (or does
    not split), an int forces that cap, None/0 disables.
    """
    b_pose = g.b_pose.cpu().numpy()
    b_lm = g.b_lm.cpu().numpy()
    b_meas = g.b_meas.cpu().numpy()
    b_omega = g.b_omega.cpu().numpy()
    NP_, NL = g.n_poses, g.n_landmarks
    NB = len(b_pose)

    def pack(key_ix, other_ix, n_keys, cap=None):
        """Slot grids [n_rows, K] + (virtual row -> key) map.  With a cap
        below the max count, key k owns ceil(count_k / K) consecutive rows;
        an edge of rank r within its key lands at (row_start[k] + r // K, r % K)."""
        counts = np.bincount(key_ix, minlength=n_keys)
        kmax = max(1, int(counts.max()))
        K = kmax if cap is None else max(1, min(int(cap), kmax))
        v = np.maximum(1, -(-counts // K))  # rows per key (ceil)
        row_start = np.zeros(n_keys + 1, np.int64)
        np.cumsum(v, out=row_start[1:])
        n_rows = int(row_start[-1])
        slot_other = np.zeros((n_rows, K), np.int32)
        slot_meas = np.zeros((n_rows, K), np.float32)
        slot_omega = np.zeros((n_rows, K), np.float32)
        # stable sort by key; an edge's slot is its rank within its key
        order = np.argsort(key_ix, kind="stable")
        sk = key_ix[order]
        seg_start = np.zeros(n_keys, np.int64)
        np.cumsum(counts[:-1], out=seg_start[1:])
        rank = np.arange(NB, dtype=np.int64) - seg_start[sk]
        rows = row_start[sk] + rank // K
        slot_other[rows, rank % K] = other_ix[order]
        slot_meas[rows, rank % K] = b_meas[order]
        slot_omega[rows, rank % K] = b_omega[order]
        virt = None
        if K < kmax:
            virt = np.repeat(np.arange(n_keys, dtype=np.int32), v)
        return slot_other, slot_meas, slot_omega, K, virt

    p_lm, p_meas, p_omega, K, _ = pack(b_pose, b_lm, NP_)
    lm_cap = split_lm
    if split_lm == "auto":
        lm_cap = _choose_split_cap(np.bincount(b_lm, minlength=NL)) if NB else None
    elif not split_lm:
        lm_cap = None
    l_pose, l_meas, l_omega, K2, l_virt = pack(b_lm, b_pose, NL, lm_cap)

    o_src = g.o_src.cpu().numpy()
    o_dst = g.o_dst.cpu().numpy()
    # maximal leading chain prefix: edges 0..c-1 with src == e, dst == e+1
    is_chain_edge = (o_src == np.arange(len(o_src))) & (o_dst == o_src + 1)
    chain_len = int(np.argmin(is_chain_edge)) if not is_chain_edge.all() else len(o_src)
    chain = chain_len == len(o_src) == NP_ - 1

    dev = g.device
    p_plan = l_plan = None
    if windows:
        p_plan = plan_windows(p_lm, p_omega > 0, NL, device=dev)
        l_plan = plan_windows(l_pose, l_omega > 0, NP_, device=dev)

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    packed = PackedEdges(
        p_lm=on_dev(p_lm), p_meas=on_dev(p_meas), p_omega=on_dev(p_omega),
        l_pose=on_dev(l_pose), l_meas=on_dev(l_meas), l_omega=on_dev(l_omega),
        odometry_is_chain=bool(chain), chain_len=chain_len, p_plan=p_plan, l_plan=l_plan,
        l_virt=None if l_virt is None else on_dev(l_virt),
    )
    meta = PackedMeta(
        odometry_is_chain=bool(chain),
        fill_pose=NB / max(1, NP_ * K),
        fill_lm=NB / max(1, l_pose.shape[0] * K2),
        windowed=p_plan is not None and l_plan is not None,
        lm_split_cap=None if l_virt is None else int(K2),
        n_virt_rows=None if l_virt is None else int(l_pose.shape[0]),
    )
    return packed, meta
