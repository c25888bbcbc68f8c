"""One whole Gauss-Newton iteration of the exact-Schur path: the port of
``boslam/ops/pallas_gn_step.py``.

    edge terms -> pose, landmark and pair sums -> damped Hll^-1 ->
    S = Hpp + lam I - U Hll^-1 U^T (gauge-masked) -> Cholesky solve ->
    landmark back-substitution -> boxplus -> chi2 stats

``fused_gn_step`` and ``fused_gn_solve`` keep the JAX package's
signatures.  For CUDA tensors every GN iteration is one call into
``csrc/gn_step.cu`` (a short pipeline of launches on the current stream,
counted once in ``fused_gn_step.launches``); for CPU tensors the plain
PyTorch version, ``fused_gn_step_plain``, computes the same step.
``prep_static`` builds what a solve keeps fixed, on the graph's device:
the edges as int32/f32 arrays, the gauge mask, the ownership lists by
which the kernel sums each pose, landmark and pair in a fixed order (no
atomics, so a run repeats to the bit), and the route of the reduced
system's factor-solve, ``band_tiles``: the band route when S's tile band
fits one block's shared memory, else None, the dense route.
``tile_band`` computes it from the edges' structure, a host wait that
``fused_gn_solve`` makes once per solve; ``fused_gn_step`` takes the route
from its caller.  Steps on the band route also count in
``fused_gn_step.band_launches``.

The state keeps the port's interleaved layout (3p + c, 2l + c); the
reduced system is padded to 128-multiples, Np = pad(3 NP), Ml = pad(2 NL),
with mask 0 and Hll^-1 = 0 on the padding.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph, first_coupled
from boslam_torch.ops import _build
from boslam_torch.ops.cholesky import TILE, band_fits

B = 128
# size gate kept from the JAX package (pallas_gn_step.py:139-144)
MAX_NPP = 512
MAX_CHUNK = 1280
_ROBUST = {"none": 0, "threshold": 1, "huber": 2}


def _pad128(n: int) -> int:
    return max(B, ((n + B - 1) // B) * B)


def fused_gn_fits(n_poses: int, n_landmarks: int, n_bearing: int, n_odometry: int) -> bool:
    """The JAX package's size gate for the whole-step path, unchanged, so
    that ``fused_step="auto"`` admits the same graphs in both packages."""
    NPp, NLp = _pad128(n_poses), _pad128(n_landmarks)
    NOp = _pad128(n_odometry)
    if NLp > NPp or NPp > MAX_NPP or NOp > MAX_CHUNK:
        return False
    Np, Ml = 3 * NPp, 2 * NLp
    chunk = min(MAX_CHUNK, _pad128(n_bearing))
    vmem = 4 * (
        Np * Np + Np * Ml + chunk * 2 * NPp + chunk * 128
        + NPp * NPp + B * Ml + (Np // B) * B * B + NPp * 256 + NLp * 128
    )
    return vmem < 48 * 2 ** 20


@dataclasses.dataclass
class GNPrep:
    """What a solve keeps fixed, on the graph's device."""

    graph: FactorGraph
    Np: int
    Ml: int
    mask: torch.Tensor  # f32[Np]: 0 on the gauge pose and the padding
    b_pose: torch.Tensor  # i32[NB]
    b_lm: torch.Tensor
    o_src: torch.Tensor  # i32[NO]
    o_dst: torch.Tensor
    o_omega6: torch.Tensor  # f32[NO, 6]: 00 01 02 11 12 22
    pose_order: torch.Tensor  # i32[NB + 2 NO]: contribution ids sorted by pose
    pose_off: torch.Tensor  # i32[NP + 1]
    lm_order: torch.Tensor  # i32[NB]: bearing edges sorted by landmark
    lm_off: torch.Tensor  # i32[NL + 1]
    u_order: torch.Tensor  # i32[NB]: bearing edges sorted by pose * NL + landmark
    u_key: torch.Tensor  # i32[NB]: the sorted keys
    c_order: torch.Tensor  # i32[NO]: odometry edges sorted by min * NP + max
    c_key: torch.Tensor  # i32[NO]
    band_tiles: int | None = None  # S's tile band (the band route), None: dense


def _sorted_by(keys: torch.Tensor, n_keys: int | None = None):
    """(order, sorted keys, offsets of keys 0..n_keys) without a host sync."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    off = None
    if n_keys is not None:
        off = torch.searchsorted(sk, torch.arange(n_keys + 1, device=keys.device)).to(torch.int32)
    return order.to(torch.int32), sk.to(torch.int32), off


def structural_band(g: FactorGraph) -> int:
    """The tile band bt of the gauge-masked reduced system S: the largest
    tile distance r // TILE - c // TILE between coupled rows r >= c
    (``first_coupled``; the padding rows couple only with themselves)."""
    first, fix = first_coupled(g)
    p = np.arange(g.n_poses)
    live = p != fix
    dist = (3 * p[live] + 2) // TILE - (3 * first[live]) // TILE
    return int(dist.max(initial=0))


def tile_band(g: FactorGraph, Np: int | None = None) -> int | None:
    """The band route's ``band_tiles`` for the graph's reduced system of
    padded size ``Np`` (by default 3 NP padded to 128): S's tile band when
    the band's window fits one block's shared memory
    (``cholesky.band_fits``), else None (the dense route).  Decided on the
    host, once per solve."""
    bt = structural_band(g)
    return bt if band_fits(bt, _pad128(3 * g.n_poses) if Np is None else Np) else None


def prep_static(g: FactorGraph, band_tiles: int | None = None) -> GNPrep:
    """Counterpart of ``_prep_static`` (pallas_gn_step.py:841): the fixed
    edge data and ownership lists of a solve, built on the graph's device
    without a host wait, and the route of its factor-solve the caller chose
    (``band_tiles`` from ``tile_band``; None: the dense route)."""
    NP_, NL = g.n_poses, g.n_landmarks
    dev = g.device
    Np, Ml = _pad128(3 * NP_), _pad128(2 * NL)
    live = (torch.arange(NP_, device=dev) != g.fixed_pose_ix).to(torch.float32)
    mask = torch.zeros(Np, dtype=torch.float32, device=dev)
    mask[: 3 * NP_] = live[:, None].expand(NP_, 3).reshape(-1)
    O = g.o_omega
    o_omega6 = torch.stack([O[:, 0, 0], O[:, 0, 1], O[:, 0, 2], O[:, 1, 1], O[:, 1, 2],
                            O[:, 2, 2]], dim=1).contiguous()
    pose_order, _, pose_off = _sorted_by(torch.cat([g.b_pose, g.o_src, g.o_dst]), NP_)
    lm_order, _, lm_off = _sorted_by(g.b_lm, NL)
    u_order, u_key, _ = _sorted_by(g.b_pose * NL + g.b_lm)
    lo, hi = torch.minimum(g.o_src, g.o_dst), torch.maximum(g.o_src, g.o_dst)
    c_order, c_key, _ = _sorted_by(lo * NP_ + hi)
    i32 = torch.int32
    return GNPrep(
        graph=g, Np=Np, Ml=Ml, mask=mask,
        b_pose=g.b_pose.to(i32), b_lm=g.b_lm.to(i32),
        o_src=g.o_src.to(i32), o_dst=g.o_dst.to(i32), o_omega6=o_omega6,
        pose_order=pose_order, pose_off=pose_off, lm_order=lm_order, lm_off=lm_off,
        u_order=u_order, u_key=u_key, c_order=c_order, c_key=c_key,
        band_tiles=band_tiles,
    )


# ---------------------------------------------------------------- stats

# one row per step: chi2_b, chi2_o, chi2_robust, clamped_b, clamped_o,
# |delta|^2, ok, 0 (the layout the kernel writes)
STATS_WIDTH = 8


def _stats(rows: torch.Tensor, cfg: SolverConfig) -> dict:
    """The optimizer's stats dict from [..., 8] rows, on the device."""
    return {
        "chi2_bearing": rows[..., 0],
        "chi2_odometry": rows[..., 1],
        "chi2_robust": rows[..., 2],
        "n_bearing_clamped": rows[..., 3].to(torch.int64),
        "n_odometry_clamped": rows[..., 4].to(torch.int64),
        "spd_ok": rows[..., 6] > 0.5,
        "accepted": torch.ones_like(rows[..., 0], dtype=torch.bool),
        "damping": torch.full_like(rows[..., 0], cfg.damping),
        "delta_norm": torch.sqrt(rows[..., 5]),
    }


# ---------------------------------------------------------------- plain


def fused_gn_step_plain(prep: GNPrep, poses: torch.Tensor, landmarks: torch.Tensor,
                        cfg: SolverConfig):
    """Plain PyTorch version of one whole step, on any device.

    Returns (poses', landmarks', stats row f32[8]).  A step whose new state
    is not finite keeps the old state (``ok`` = 0 in the row).
    """
    from boslam_torch.geometry.se2 import boxplus_state
    from boslam_torch.ops.schur_solve import fused_schur_solve_blocks_plain
    from boslam_torch.solver.normal_eq import edge_terms
    from boslam_torch.solver.robust import robust_cost
    from boslam_torch.solver.schur import fused_schur_inputs

    g = prep.graph.with_state(poses, landmarks)
    NP_, NL = g.n_poses, g.n_landmarks
    terms = edge_terms(g, cfg)
    pmask = prep.mask[: 3 * NP_ : 3, None]
    # the inputs come damped, so the solve adds zero
    x, dl = fused_schur_solve_blocks_plain(
        *fused_schur_inputs(g, cfg, cfg.damping, terms, pmask), 0.0, prep.band_tiles)
    new_p, new_l = boxplus_state(poses, landmarks, x[: 3 * NP_].reshape(NP_, 3),
                                 dl[: 2 * NL].reshape(NL, 2))
    ok = torch.isfinite(new_p).all() & torch.isfinite(new_l).all()
    kt = cfg.kernel_threshold
    row = torch.stack([
        terms.bchi2.sum(), terms.ochi2.sum(),
        robust_cost(terms.bchi2, cfg).sum() + robust_cost(terms.ochi2, cfg).sum(),
        (terms.bchi2 > kt).sum().to(torch.float32), (terms.ochi2 > kt).sum().to(torch.float32),
        (x * x).sum() + (dl * dl).sum(), ok.to(torch.float32),
        torch.zeros((), dtype=torch.float32, device=x.device),
    ])
    return torch.where(ok, new_p, poses), torch.where(ok, new_l, landmarks), row


# ---------------------------------------------------------------- kernel

_PTR_FIELDS = (
    "b_pose", "b_lm", "b_meas", "b_omega", "o_src", "o_dst", "o_meas", "o_omega",
    "pose_order", "pose_off", "lm_order", "lm_off", "u_order", "u_key", "c_order", "c_key",
    "mask", "scal", "poses", "lms",
    "planes", "Hpp", "U", "Hb", "bp", "bl", "W", "S", "Linv", "rhs", "y", "x", "dl", "stats",
)
_INT_FIELDS = ("np_", "nl", "nb", "no", "Np", "Ml", "robust", "quirk", "band")


class _Args(ctypes.Structure):
    """Mirror of ``GNStepArgs`` in csrc/gn_step.cu (same field order)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [(n, ctypes.c_int) for n in _INT_FIELDS])


def _lib():
    lib = _build.load_library("gn_step")
    fn = lib.boslam_gn_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


class GNStepKernel:
    """The CUDA whole-step kernel bound to one solve: ``prep``'s edges and
    lists, the state tensors ``poses`` f32[NP, 3] and ``landmarks``
    f32[NL, 2] (updated in place by each step), and the workspace."""

    def __init__(self, prep: GNPrep, poses: torch.Tensor, landmarks: torch.Tensor,
                 cfg: SolverConfig):
        g = prep.graph
        if not (poses.is_cuda and landmarks.is_cuda):
            raise ValueError("GNStepKernel needs CUDA tensors")
        for t in (poses, landmarks):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("the state must be contiguous float32")
        if tuple(poses.shape) != (g.n_poses, 3) or tuple(landmarks.shape) != (g.n_landmarks, 2):
            raise ValueError(f"state shapes {tuple(poses.shape)}, {tuple(landmarks.shape)} "
                             f"do not match the graph")
        if not fused_gn_fits(g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry):
            raise ValueError("the graph is outside fused_gn_fits")
        NB, NO, Np, Ml = g.n_bearing, g.n_odometry, prep.Np, prep.Ml
        f32 = dict(dtype=torch.float32, device=poses.device)
        scal = torch.full((2,), cfg.damping, **f32)
        scal[1:].fill_(cfg.kernel_threshold)
        # Hpp, U and bp: zero once; every step writes the same positions
        buf = dict(
            scal=scal, planes=torch.empty(23 * NB + 30 * NO, **f32),
            Hpp=torch.zeros((Np, Np), **f32), U=torch.zeros((Np, Ml), **f32),
            Hb=torch.empty((Ml // 2, 2, 2), **f32), bp=torch.zeros(Np, **f32),
            bl=torch.empty(Ml, **f32), W=torch.empty((Np, Ml), **f32),
            S=torch.empty((Np, Np), **f32), Linv=torch.empty((Np // TILE, TILE, TILE), **f32),
            rhs=torch.empty(Np, **f32), y=torch.empty(Np, **f32), x=torch.empty(Np, **f32),
            dl=torch.empty(Ml, **f32),
        )
        ins = dict(
            b_pose=prep.b_pose, b_lm=prep.b_lm, b_meas=g.b_meas.contiguous(),
            b_omega=g.b_omega.contiguous(), o_src=prep.o_src, o_dst=prep.o_dst,
            o_meas=g.o_meas.contiguous(), o_omega=prep.o_omega6,
            pose_order=prep.pose_order, pose_off=prep.pose_off, lm_order=prep.lm_order,
            lm_off=prep.lm_off, u_order=prep.u_order, u_key=prep.u_key,
            c_order=prep.c_order, c_key=prep.c_key, mask=prep.mask, poses=poses, lms=landmarks,
        )
        for name, t in ins.items():
            if t.device != poses.device:
                raise ValueError(f"{name} is on {t.device}, the state on {poses.device}")
        self._keep = {**ins, **buf}  # the struct holds raw pointers: keep the tensors alive
        self.poses = poses
        self._lib = _lib()
        self._args = _Args(
            **{n: t.data_ptr() for n, t in self._keep.items()}, stats=0,
            np_=g.n_poses, nl=g.n_landmarks, nb=NB, no=NO, Np=Np, Ml=Ml,
            robust=_ROBUST[cfg.robust], quirk=int(bool(cfg.reference_kernel_quirk)),
            band=-1 if prep.band_tiles is None else prep.band_tiles,
        )
        self.band_tiles = prep.band_tiles

    def step(self, stats_row: torch.Tensor) -> None:
        """One GN iteration in place; its stats go to ``stats_row`` f32[8]."""
        if not (stats_row.is_cuda and stats_row.dtype == torch.float32
                and stats_row.is_contiguous() and stats_row.numel() == STATS_WIDTH):
            raise ValueError("stats_row must be a contiguous CUDA float32[8]")
        self._args.stats = stats_row.data_ptr()
        stream = torch.cuda.current_stream(self.poses.device).cuda_stream
        err = self._lib.boslam_gn_step(ctypes.byref(self._args), stream)
        fused_gn_step.launches += 1
        if self.band_tiles is not None:
            fused_gn_step.band_launches += 1
        _build.check(self._lib, err, "fused_gn_step")


def _run(g: FactorGraph, cfg: SolverConfig, iters: int, band_tiles: int | None):
    """``iters`` whole steps from ``g``'s state on the route ``band_tiles``:
    (poses, landmarks, rows [iters, 8])."""
    prep = prep_static(g, band_tiles)
    rows = torch.zeros((iters, STATS_WIDTH), dtype=torch.float32, device=g.device)
    poses, landmarks = g.poses.clone(), g.landmarks.clone()
    if g.poses.is_cuda:
        kernel = GNStepKernel(prep, poses, landmarks, cfg)
        for i in range(iters):
            kernel.step(rows[i])
        return poses, landmarks, rows
    for i in range(iters):
        poses, landmarks, row = fused_gn_step_plain(prep, poses, landmarks, cfg)
        rows[i] = row
    return poses, landmarks, rows


def fused_gn_step(g: FactorGraph, cfg: SolverConfig, band_tiles: int | None = None):
    """One GN iteration as one whole-step call: (g', stats).

    Drop-in for ``optimizer.gn_step`` on the exact-Schur path within
    ``fused_gn_fits``: the kernel for a CUDA graph, the plain version for a
    CPU graph.  ``band_tiles``: the route, ``tile_band(g)`` computed once by
    a caller that steps the same graph again, or None for the dense route.
    """
    poses, landmarks, rows = _run(g, cfg, 1, band_tiles)
    return g.with_state(poses, landmarks), _stats(rows[0], cfg)


fused_gn_step.launches = 0
fused_gn_step.band_launches = 0  # those of .launches on the band route


def fused_gn_solve(g: FactorGraph, cfg: SolverConfig):
    """``cfg.iters`` whole steps, with the static data and the route
    (``tile_band``, the solve's one host wait) prepped once.

    Same return contract as ``optimizer.solve_loop``: the final graph and
    per-iteration stats with a leading ``iters`` axis, all on the device
    (the loop never waits on the host).
    """
    poses, landmarks, rows = _run(g, cfg, cfg.iters, tile_band(g))
    return g.with_state(poses, landmarks), _stats(rows, cfg)
