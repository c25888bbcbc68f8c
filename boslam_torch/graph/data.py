"""Factor graph as a dataclass of tensors (port of ``boslam/graph/data.py``).

All ids are normalized to contiguous indices on the host at load time.
``FactorGraph`` holds the state and the edges on one device; ``GraphMeta``
is host-only bookkeeping (id maps, plot bound).  Indices are int64, the
type ``index_add_`` and advanced indexing take; floats are f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from boslam_torch.device import host_sync, resolve_device

_INDEX_FIELDS = ("b_pose", "b_lm", "o_src", "o_dst", "fixed_pose_ix")


@dataclasses.dataclass
class FactorGraph:
    """Device-side problem: state + edges, indices pre-resolved.

    - ``poses`` f32[NP, 3] (x, y, theta), ``landmarks`` f32[NL, 2]
    - bearing edges: ``b_pose``, ``b_lm`` i64[NB], ``b_meas``, ``b_omega`` f32[NB]
    - odometry edges: ``o_src``, ``o_dst`` i64[NO], ``o_meas`` f32[NO, 3],
      ``o_omega`` f32[NO, 3, 3]
    - ``fixed_pose_ix``: i64 scalar tensor, the gauge pose.  It stays a
      tensor so that no step has to read it back to the host.
    """

    poses: torch.Tensor
    landmarks: torch.Tensor
    b_pose: torch.Tensor
    b_lm: torch.Tensor
    b_meas: torch.Tensor
    b_omega: torch.Tensor
    o_src: torch.Tensor
    o_dst: torch.Tensor
    o_meas: torch.Tensor
    o_omega: torch.Tensor
    fixed_pose_ix: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.poses.device

    @property
    def n_poses(self) -> int:
        return self.poses.shape[0]

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def n_bearing(self) -> int:
        return self.b_meas.shape[0]

    @property
    def n_odometry(self) -> int:
        return self.o_meas.shape[0]

    @property
    def state_dim(self) -> int:
        """N = 3*NP + 2*NL."""
        return 3 * self.n_poses + 2 * self.n_landmarks

    def with_state(self, poses: torch.Tensor, landmarks: torch.Tensor) -> "FactorGraph":
        return dataclasses.replace(self, poses=poses, landmarks=landmarks)

    def to(self, device) -> "FactorGraph":
        return FactorGraph(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "FactorGraph":
        """Build from a dict of numpy arrays keyed by field name.

        This carries a graph across from the JAX package
        (``dataclasses.asdict`` of its graph mapped through ``np.asarray``),
        so that both packages compute on identical inputs.  Indices become
        int64 and floats f32.  The graph goes to ``cuda`` unless ``device``
        says otherwise.
        """
        device = resolve_device(device)
        kw = {}
        for f in dataclasses.fields(cls):
            dtype = torch.int64 if f.name in _INDEX_FIELDS else torch.float32
            kw[f.name] = torch.tensor(np.asarray(arrays[f.name]), dtype=dtype, device=device)
        return cls(**kw)


@dataclasses.dataclass
class GraphMeta:
    """Host-side id bookkeeping; device code sees contiguous indices."""

    pose_ids: List[int]
    lm_ids: List[int]
    pose_id_to_ix: Dict[int, int]
    lm_id_to_ix: Dict[int, int]
    fixed_pose_id: int
    bound: float  # symmetric plot bound (+3 margin)

    @classmethod
    def from_ids(cls, pose_ids, lm_ids, fixed_pose_id: int, bound: float) -> "GraphMeta":
        pose_ids = [int(i) for i in pose_ids]
        lm_ids = [int(i) for i in lm_ids]
        return cls(
            pose_ids=pose_ids,
            lm_ids=lm_ids,
            pose_id_to_ix={pid: ix for ix, pid in enumerate(pose_ids)},
            lm_id_to_ix={lid: ix for ix, lid in enumerate(lm_ids)},
            fixed_pose_id=int(fixed_pose_id),
            bound=float(bound),
        )


def pack_delta(delta_poses: np.ndarray, delta_landmarks: np.ndarray) -> np.ndarray:
    """Flatten per-block host deltas into the reference's packed
    ``[3*NP | 2*NL]`` layout."""
    return np.concatenate([np.ravel(delta_poses), np.ravel(delta_landmarks)])


def unpack_delta(delta: torch.Tensor, n_poses: int, n_landmarks: int):
    """Split a packed ``[3*NP | 2*NL]`` delta into per-block tensors."""
    dp = delta[: 3 * n_poses].reshape(n_poses, 3)
    dl = delta[3 * n_poses :].reshape(n_landmarks, 2)
    return dp, dl


def first_coupled(g: FactorGraph) -> tuple[np.ndarray, int]:
    """(first i64[NP], the gauge pose): for each pose, the lowest pose it
    couples with in the gauge-masked reduced system S (itself at least).

    Poses a and b couple through an odometry edge or a landmark both
    observe; the gauge pose couples only with itself.  Structure, not
    values: the edges go to the host once (inside ``host_sync`` when they
    live on the card), never inside a solve loop.
    """
    NP_, NL = g.n_poses, g.n_landmarks
    with host_sync(g.device):
        fix = int(g.fixed_pose_ix)
        src, dst = g.o_src.cpu().numpy(), g.o_dst.cpu().numpy()
        bp, bl = g.b_pose.cpu().numpy(), g.b_lm.cpu().numpy()
    first = np.arange(NP_)
    keep = (src != fix) & (dst != fix)
    np.minimum.at(first, np.maximum(src, dst)[keep], np.minimum(src, dst)[keep])
    seen = bp != fix
    lm_first = np.full(NL, NP_)
    np.minimum.at(lm_first, bl[seen], bp[seen])
    np.minimum.at(first, bp[seen], lm_first[bl[seen]])
    return first, fix


def full_state_vector(poses, landmarks) -> np.ndarray:
    """Packed ``[3*NP | 2*NL]`` state vector (t2v per pose, then landmarks)
    on the host: the layout of ``State::print_full_vector``."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return pack_delta(host(poses), host(landmarks))


def print_full_state(poses, landmarks, file=None) -> None:
    """The reference's ``State::print_full_vector`` debug line, "State: <v>",
    each entry in ``%g``."""
    import sys

    v = full_state_vector(poses, landmarks)
    print("State: " + " ".join(f"{x:g}" for x in v), file=file or sys.stdout)
