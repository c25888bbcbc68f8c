"""Pose-range sharding: the state and the reduced system split over the
ranks (port of ``boslam/parallel/pose_range.py``).

The edge-sharded layouts replicate the state, the per-vertex blocks and
every CG vector; only the slot work is 1/D.  Here rank d owns

- poses [d*NPd, (d+1)*NPd): their state rows, pose-grid rows [NPd, K],
  Hpp_diag, bp, the CG iterate and the delta;
- landmarks [d*NLd, (d+1)*NLd): their state rows, landmark-grid rows
  [NLd, K2], Hll^-1 and bl.

In the dual-packed layout every bearing edge of pose p lies in p's
pose-grid row and every observation of landmark l in l's landmark-grid
row, so the per-vertex sums are local.  What crosses ranks are two
all-gathers per CG matvec (x, 12*NPp bytes; w, 8*NLp bytes), the
all-gathers of the state in each build, and one of Hll^-1 for diag(S).

Odometry: the chain (src == e, dst == e + 1) goes through a one-edge
halo: rank d holds chain edges [d*NPd - 1, d*NPd + NPd), the boundary edge
twice, so both endpoints of every edge land on rows the rank owns.  An
edge's chi2 and H_ss count on its src owner; the halo copy adds only
H_dd.  Other odometry edges (loop closures) are split by edge, and their
sums reach the owner rows through one ``psum_scatter``.

Hot-landmark splitting is off here (a landmark's virtual rows could
straddle two ranks).  Preconditioners: block-Jacobi (diag(S) is
pose-local) and two_level with a replicated coarse factor.

``prepare_pose_range_host`` builds the global padded and halo arrays for
D ranks in numpy, the JAX function's arrays to the bit; ``place_pose_range``
puts one rank's rows on its device.  The CG loop's polls and every branch
the host takes come out of collectives (``schur.poll``), so the ranks stay
in step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from boslam_torch.config import SolverConfig
from boslam_torch.device import host_sync
from boslam_torch.geometry.se2 import boxplus_state
from boslam_torch.parallel.mesh import Mesh, make_mesh, put_sharded
from boslam_torch.solver import residuals as R
from boslam_torch.solver.robust import robust_cost
from boslam_torch.solver.schur import _inv2x2, _inv3x3, _segment_sum, cg_stats, pcg
from boslam_torch.solver.schur_packed import _bearing_slot_terms, _odometry_terms
from boslam_torch.solver.schur_packed import _step_stats as _packed_step_stats


@dataclasses.dataclass
class RangeShards:
    """One rank's rows of the range-sharded problem (``fixed_pose_ix`` is
    replicated)."""

    poses: torch.Tensor  # f32[NPd, 3]
    landmarks: torch.Tensor  # f32[NLd, 2]
    p_lm: torch.Tensor  # i32[NPd, K] global landmark index
    p_meas: torch.Tensor  # f32[NPd, K]
    p_omega: torch.Tensor  # f32[NPd, K] (0 = padding)
    l_pose: torch.Tensor  # i32[NLd, K2] global pose index
    l_meas: torch.Tensor  # f32[NLd, K2]
    l_omega: torch.Tensor  # f32[NLd, K2]
    # halo chain rows [NPd+1]: row j is global chain edge d*NPd - 1 + j
    # (omega zero where that edge is out of range)
    oh_meas: torch.Tensor  # f32[NPd+1, 3]
    oh_omega: torch.Tensor  # f32[NPd+1, 3, 3]
    # non-chain (loop-closure) odometry edges, split by edge
    os_src: torch.Tensor  # i32[Es/D]
    os_dst: torch.Tensor  # i32[Es/D]
    os_meas: torch.Tensor  # f32[Es/D, 3]
    os_omega: torch.Tensor  # f32[Es/D, 3, 3]
    fixed_pose_ix: torch.Tensor  # i32 scalar (replicated)

    def with_state(self, poses, landmarks) -> "RangeShards":
        return dataclasses.replace(self, poses=poses, landmarks=landmarks)

    def nbytes(self) -> int:
        """Bytes of this rank's arrays (its shard of the problem)."""
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, f.name) for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class RangeMeta:
    """Host facts about the sharded problem."""

    n_poses: int  # real pose count (before padding)
    n_landmarks: int
    np_pad: int  # NPp = D * NPd
    nl_pad: int
    n_devices: int
    has_suffix: bool  # any non-chain odometry edges


class RangeBlocks(NamedTuple):
    Hpp_diag: torch.Tensor  # [NPd, 3, 3] local pose rows
    Hll_inv: torch.Tensor  # [NLd, 2, 2] local landmark rows
    Bp: torch.Tensor  # [NPd, K, 3, 2]
    Bl: torch.Tensor  # [NLd, K2, 3, 2]
    bp: torch.Tensor  # [NPd, 3]
    bl: torch.Tensor  # [NLd, 2]
    Ho: torch.Tensor  # [NPd+1, 3, 3] halo chain couplings
    Ho_s: torch.Tensor  # [Es/D, 3, 3] suffix couplings


# names of the arrays split by row blocks (the halo and suffix arrays too)
_SPLIT = ("poses", "landmarks", "p_lm", "p_meas", "p_omega", "l_pose", "l_meas", "l_omega",
          "oh_meas", "oh_omega", "os_src", "os_dst", "os_meas", "os_omega")


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------


def prepare_pose_range_host(graph, n_ranks: int):
    """Pack, pad and halo-replicate the problem for ``n_ranks`` ranks, in
    numpy: ({name: global array}, RangeMeta).  The arrays are those of the
    JAX package's ``prepare_pose_range`` on an ``n_ranks``-device mesh,
    read back to the host; rank d's rows are the d-th of ``n_ranks``
    equal row blocks of each."""
    from boslam_torch.graph.packed import pack_edges

    D = n_ranks
    g = graph.to("cpu")
    pk, _ = pack_edges(g, split_lm=0)  # no virtual rows (see the module's doc)

    NP_, NL = g.n_poses, g.n_landmarks
    NPd = -(-NP_ // D)
    NLd = -(-NL // D)
    NPp, NLp = D * NPd, D * NLd

    def pad0(x, n):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return np.pad(x, [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

    # halo chain arrays: rank d's row j <- global chain edge d*NPd - 1 + j
    nc = pk.chain_len
    o_meas, o_omega = g.o_meas.numpy(), g.o_omega.numpy()
    oh_meas = np.zeros((D, NPd + 1, 3), np.float32)
    oh_omega = np.zeros((D, NPd + 1, 3, 3), np.float32)
    for d in range(D):
        e = np.arange(NPd + 1) + d * NPd - 1
        valid = (e >= 0) & (e < nc)
        oh_meas[d, valid] = o_meas[e[valid]]
        oh_omega[d, valid] = o_omega[e[valid]]

    # suffix (non-chain) edges, padded to a multiple of D
    NO = g.n_odometry
    has_suffix = nc < NO
    ns = NO - nc if has_suffix else 0
    ns_pad = D * max(1, -(-ns // D)) if has_suffix else D
    os_src = np.zeros(ns_pad, np.int32)
    os_dst = np.zeros(ns_pad, np.int32)
    os_meas = np.zeros((ns_pad, 3), np.float32)
    os_omega = np.zeros((ns_pad, 3, 3), np.float32)
    if has_suffix:
        os_src[:ns] = g.o_src.numpy()[nc:]
        os_dst[:ns] = g.o_dst.numpy()[nc:]
        os_meas[:ns] = o_meas[nc:]
        os_omega[:ns] = o_omega[nc:]

    arrays = dict(
        poses=pad0(g.poses, NPp), landmarks=pad0(g.landmarks, NLp),
        p_lm=pad0(pk.p_lm, NPp).astype(np.int32), p_meas=pad0(pk.p_meas, NPp),
        p_omega=pad0(pk.p_omega, NPp),
        l_pose=pad0(pk.l_pose, NLp).astype(np.int32), l_meas=pad0(pk.l_meas, NLp),
        l_omega=pad0(pk.l_omega, NLp),
        oh_meas=oh_meas.reshape(D * (NPd + 1), 3),
        oh_omega=oh_omega.reshape(D * (NPd + 1), 3, 3),
        os_src=os_src, os_dst=os_dst, os_meas=os_meas, os_omega=os_omega,
        fixed_pose_ix=np.asarray(g.fixed_pose_ix.numpy(), np.int32),
    )
    meta = RangeMeta(n_poses=NP_, n_landmarks=NL, np_pad=NPp, nl_pad=NLp, n_devices=D,
                     has_suffix=bool(has_suffix))
    return arrays, meta


def place_pose_range(arrays: dict, mesh: Mesh) -> RangeShards:
    """This rank's rows of ``prepare_pose_range_host``'s arrays on its
    device, in their host types."""
    def put(name):
        x = torch.as_tensor(arrays[name])
        return put_sharded(x, mesh) if name in _SPLIT else x.to(mesh.device)

    return RangeShards(**{f.name: put(f.name) for f in dataclasses.fields(RangeShards)})


def prepare_pose_range(graph, mesh: Mesh):
    """Pack, pad, halo-replicate and place this rank's rows: (RangeShards,
    RangeMeta).  The host waits for the card here (inside ``host_sync``)."""
    with host_sync(mesh.device):
        arrays, meta = prepare_pose_range_host(graph, mesh.size)
        return place_pose_range(arrays, mesh), meta


# ---------------------------------------------------------------------------
# Device-side math (arrays are the rank's rows)
# ---------------------------------------------------------------------------


def _local_mask(sh: RangeShards, meta: RangeMeta, mesh: Mesh) -> torch.Tensor:
    """f32[NPd, 1]: 0 on the gauge pose and on the padding rows."""
    NPd = sh.poses.shape[0]
    ids = mesh.rank * NPd + torch.arange(NPd, device=sh.poses.device)
    live = (ids != sh.fixed_pose_ix) & (ids < meta.n_poses)
    return live.to(sh.poses.dtype)[:, None]


def _halo_ix(sh: RangeShards, meta: RangeMeta, mesh: Mesh):
    """Global (src, dst) pose rows of the rank's halo chain edges."""
    NPd = sh.poses.shape[0]
    j = mesh.rank * NPd + torch.arange(NPd + 1, device=sh.poses.device)
    return (torch.clamp(j - 1, 0, meta.np_pad - 1), torch.clamp(j, 0, meta.np_pad - 1))


def _range_build(sh: RangeShards, cfg: SolverConfig, damping, meta: RangeMeta, mesh: Mesh,
                 kt=None):
    """The rank's damped blocks and the stats of the state.  Collectives:
    all_gather(poses), all_gather(landmarks), one psum of the stats and,
    with loop closures, one psum_scatter."""
    dtype, dev = sh.poses.dtype, sh.poses.device
    NPd, NLd = sh.poses.shape[0], sh.landmarks.shape[0]
    pg = mesh.all_gather(sh.poses)  # [NPp, 3]
    lg = mesh.all_gather(sh.landmarks)  # [NLp, 2]

    # pose-packed pass: local rows, landmarks gathered
    p_slot = sh.poses[:, None, :].expand(NPd, sh.p_lm.shape[1], 3)
    _, bchi2, Hpp_b, _, Bp, bp_b, _ = _bearing_slot_terms(
        p_slot, lg[sh.p_lm], sh.p_meas, sh.p_omega, cfg, kt)
    Hpp_diag = torch.sum(Hpp_b, dim=1)
    bp = torch.sum(bp_b, dim=1)

    # landmark-packed pass: local rows, poses gathered
    l_slot = sh.landmarks[:, None, :].expand(NLd, sh.l_pose.shape[1], 2)
    _, _, _, Hll_b, Bl, _, bl_b = _bearing_slot_terms(
        pg[sh.l_pose], l_slot, sh.l_meas, sh.l_omega, cfg, kt)
    Hll = torch.sum(Hll_b, dim=1)
    bl = torch.sum(bl_b, dim=1)

    # halo chain: src side of rows 1..NPd -> local row j-1, dst side of
    # rows 0..NPd-1 -> local row j
    src_ix, dst_ix = _halo_ix(sh, meta, mesh)
    ochi2, H_ss, H_dd, H_sd, bp_s, bp_d = _odometry_terms(
        pg[src_ix], pg[dst_ix], sh.oh_meas, sh.oh_omega, cfg, kt)
    Hpp_diag = Hpp_diag + H_ss[1:]
    bp = bp + bp_s[1:]
    Hpp_diag = Hpp_diag + H_dd[:-1]
    bp = bp + bp_d[:-1]
    ktv = cfg.kernel_threshold if kt is None else kt
    ochi2 = ochi2[1:]  # each edge counted once, on its src owner
    chi2_odo = torch.sum(ochi2)
    n_odo_clamped = torch.sum(ochi2 > ktv)
    robust = (torch.sum(robust_cost(bchi2, cfg, kt) * (sh.p_omega > 0))
              + torch.sum(robust_cost(ochi2, cfg, kt) * (ochi2 > 0)))

    # suffix (loop-closure) odometry: the general path and a psum_scatter
    Ho_s = torch.zeros((sh.os_src.shape[0], 3, 3), dtype=dtype, device=dev)
    if meta.has_suffix:
        schi2, sH_ss, sH_dd, Ho_s, sbp_s, sbp_d = _odometry_terms(
            pg[sh.os_src], pg[sh.os_dst], sh.os_meas, sh.os_omega, cfg, kt)
        payload = torch.cat([torch.cat([sH_ss.reshape(-1, 9), sbp_s], dim=1),
                             torch.cat([sH_dd.reshape(-1, 9), sbp_d], dim=1)])
        sums = _segment_sum(payload, torch.cat([sh.os_src, sh.os_dst]), meta.np_pad)
        local = mesh.psum_scatter(sums)
        Hpp_diag = Hpp_diag + local[:, :9].reshape(NPd, 3, 3)
        bp = bp + local[:, 9:12]
        chi2_odo = chi2_odo + torch.sum(schi2)
        n_odo_clamped = n_odo_clamped + torch.sum(schi2 > ktv)
        robust = robust + torch.sum(robust_cost(schi2, cfg, kt) * (schi2 > 0))

    stats = mesh.psum_dict({
        "chi2_bearing": torch.sum(bchi2),
        "chi2_odometry": chi2_odo,
        "chi2_robust": robust,
        "n_bearing_clamped": torch.sum(bchi2 > ktv),
        "n_odometry_clamped": n_odo_clamped,
    })
    Hpp_diag = Hpp_diag + damping * torch.eye(3, dtype=dtype, device=dev)
    Hll_inv = _inv2x2(Hll + damping * torch.eye(2, dtype=dtype, device=dev))
    return RangeBlocks(Hpp_diag, Hll_inv, Bp, Bl, bp, bl, H_sd, Ho_s), stats


def _range_matvec(blocks: RangeBlocks, sh: RangeShards, x_local, mask, meta: RangeMeta,
                  mesh: Mesh):
    """y = S_masked @ x on the range layout.  Collectives: all_gather(x),
    all_gather(w), and with loop closures one psum_scatter; the rest is
    local."""
    xm = x_local * mask
    xg = mesh.all_gather(xm)  # [NPp, 3]
    # z = Hlp x on the local landmark rows, w = Hll^-1 z
    z = torch.einsum("lkij,lki->lj", blocks.Bl, xg[sh.l_pose])
    w = torch.einsum("lij,lj->li", blocks.Hll_inv, z)
    wg = mesh.all_gather(w)  # [NLp, 2]
    # y_corr = Hpl w on the local pose rows
    y_corr = torch.einsum("pkij,pkj->pi", blocks.Bp, wg[sh.p_lm])
    # the halo chain, every index through xg
    src_ix, dst_ix = _halo_ix(sh, meta, mesh)
    y_sd = torch.einsum("eij,ej->ei", blocks.Ho, xg[dst_ix])[1:]  # -> src row j-1
    y_ds = torch.einsum("eji,ej->ei", blocks.Ho, xg[src_ix])[:-1]  # -> dst row j
    y = torch.einsum("pij,pj->pi", blocks.Hpp_diag, xm) + y_sd + y_ds - y_corr
    if meta.has_suffix:
        m = sh.os_src.shape[0]
        xs = xg[torch.cat([sh.os_dst, sh.os_src])]
        scat = _segment_sum(
            torch.cat([torch.einsum("eij,ej->ei", blocks.Ho_s, xs[:m]),
                       torch.einsum("eji,ej->ei", blocks.Ho_s, xs[m:])]),
            torch.cat([sh.os_src, sh.os_dst]), meta.np_pad)
        y = y + mesh.psum_scatter(scat)
    return y * mask + x_local * (1.0 - mask)


def _range_s_diag(blocks: RangeBlocks, sh: RangeShards, mesh: Mesh) -> torch.Tensor:
    """The rank's rows of diag(S) for block-Jacobi (one Hll^-1 gather),
    summed in f64 and returned in f32 as ``packed_s_diag`` is."""
    Hinv_g = mesh.all_gather(blocks.Hll_inv)[sh.p_lm]  # [NPd, K, 2, 2]
    Bp = blocks.Bp.double()
    corr = torch.einsum("pkij,pkjl,pkml->pim", Bp, Hinv_g.double(), Bp)
    return (blocks.Hpp_diag.double() - corr).float()


def _range_two_level(blocks: RangeBlocks, sh: RangeShards, d_local, mask, meta: RangeMeta,
                     mesh: Mesh, cfg: SolverConfig):
    """The two-level chain preconditioner with a replicated factor: the
    masked diag(S) rows and the halo band are all-gathered once per build
    (a rank's halo rows 1..NPd are the global band rows start..start+NPd-1)
    and factored on every rank; each apply all-gathers the residual and
    keeps the rank's rows of the replicated solve."""
    from boslam_torch.solver.two_level import aggregate_size, two_level_factor, two_level_solve

    NPp = meta.np_pad
    NPd = d_local.shape[0]
    dg = mesh.all_gather(d_local)  # [NPp, 3, 3]
    mg = mesh.all_gather(mask)  # [NPp, 1]
    bandg = mesh.all_gather(blocks.Ho[1:])[: NPp - 1]
    bandg = bandg * (mg[:-1, :, None] * mg[1:, :, None])
    factor = two_level_factor(dg, bandg, aggregate_size(cfg.coarse_q, NPp), mg,
                              cycle=cfg.two_level_cycle)
    start = mesh.rank * NPd

    def apply_m(r):
        return two_level_solve(factor, mesh.all_gather(r))[start:start + NPd]

    return apply_m


def range_build_and_solve(sh: RangeShards, cfg: SolverConfig, damping, meta: RangeMeta,
                          mesh: Mesh, x0=None, kt=None):
    """The linear solve on the range layout (the packed path's
    ``schur_packed_build_and_solve``): (dp, dl, stats, ok), dp and dl the
    rank's rows.  block-Jacobi, or two_level when asked for.  A NaN on any
    rank freezes every rank (``pmax`` of the flag)."""
    blocks, stats = _range_build(sh, cfg, damping, meta, mesh, kt)
    mask = _local_mask(sh, meta, mesh)

    w0 = torch.einsum("lij,lj->li", blocks.Hll_inv, blocks.bl)
    corr = torch.einsum("pkij,pkj->pi", blocks.Bp, mesh.all_gather(w0)[sh.p_lm])
    rhs = (-blocks.bp + corr) * mask

    eye3 = torch.eye(3, dtype=sh.poses.dtype, device=sh.poses.device)
    d = mask[..., None] * _range_s_diag(blocks, sh, mesh) + (1.0 - mask[..., None]) * eye3
    if cfg.preconditioner == "two_level":
        precond = _range_two_level(blocks, sh, d, mask, meta, mesh, cfg)
    else:
        precond = _inv3x3(d)
    if x0 is not None:
        x0 = x0 * mask
    dp, n_iters, rel_res2, breakdown, info = pcg(
        lambda x: _range_matvec(blocks, sh, x, mask, meta, mesh), rhs, precond,
        cfg.cg_iters, cfg.cg_tol, x0, restarts=cfg.cg_restarts, mesh=mesh, split=True)
    dp = dp * mask

    hlp_dp = torch.einsum("lkij,lki->lj", blocks.Bl, mesh.all_gather(dp)[sh.l_pose])
    dl = torch.einsum("lij,lj->li", blocks.Hll_inv, -blocks.bl - hlp_dp)

    bad = torch.any(torch.isnan(dp)) | torch.any(torch.isnan(dl))
    ok = torch.logical_not(mesh.pmax(bad))
    dp = torch.where(ok, dp, torch.zeros_like(dp))
    dl = torch.where(ok, dl, torch.zeros_like(dl))
    stats.update(cg_stats(n_iters, rel_res2, breakdown, info, sh.poses.device))
    stats["cg_tol_effective"] = torch.full((), cfg.cg_tol, dtype=torch.float32,
                                           device=sh.poses.device)
    return dp, dl, stats, ok


def _range_robust_total(sh: RangeShards, cfg: SolverConfig, meta: RangeMeta, mesh: Mesh,
                        kt=None):
    """Total robust cost on the range layout (one psum)."""
    NPd = sh.poses.shape[0]
    pg = mesh.all_gather(sh.poses)
    lg = mesh.all_gather(sh.landmarks)
    p_slot = sh.poses[:, None, :].expand(NPd, sh.p_lm.shape[1], 3)
    err = R.bearing_error_from(p_slot, lg[sh.p_lm], sh.p_meas)
    bchi2 = sh.p_omega * err * err
    src_ix, dst_ix = _halo_ix(sh, meta, mesh)
    oe = R.odometry_error_from(pg[src_ix], pg[dst_ix], sh.oh_meas)
    ochi2 = torch.einsum("ei,eij,ej->e", oe, sh.oh_omega, oe)[1:]
    total = (torch.sum(robust_cost(bchi2, cfg, kt) * (sh.p_omega > 0))
             + torch.sum(robust_cost(ochi2, cfg, kt) * (ochi2 > 0)))
    if meta.has_suffix:
        oes = R.odometry_error_from(pg[sh.os_src], pg[sh.os_dst], sh.os_meas)
        schi2 = torch.einsum("ei,eij,ej->e", oes, sh.os_omega, oes)
        total = total + torch.sum(robust_cost(schi2, cfg, kt) * (schi2 > 0))
    return mesh.psum(total)


def _step_stats(stats, ok, accepted, damping, kt, cfg, dp, dl, mesh):
    """The packed path's step stats, with the delta norm over every rank."""
    stats = _packed_step_stats(stats, ok, accepted, damping, kt, cfg, dp, dl, dp.device)
    stats["delta_norm"] = torch.sqrt(mesh.psum(torch.sum(dp * dp) + torch.sum(dl * dl)))
    return stats


def range_gn_step(sh: RangeShards, cfg: SolverConfig, meta: RangeMeta, mesh: Mesh,
                  dp_prev=None, kt=None):
    """One GN iteration: (shards', stats, dp)."""
    x0 = dp_prev if cfg.cg_warm_start else None
    dp, dl, stats, ok = range_build_and_solve(sh, cfg, cfg.damping, meta, mesh, x0, kt)
    poses, landmarks = boxplus_state(sh.poses, sh.landmarks, dp, dl)
    dev = sh.poses.device
    stats = _step_stats(stats, ok, torch.ones((), dtype=torch.bool, device=dev),
                        torch.full((), cfg.damping, dtype=sh.poses.dtype, device=dev), kt, cfg,
                        dp, dl, mesh)
    return sh.with_state(poses, landmarks), stats, dp


def range_lm_step(sh: RangeShards, cfg: SolverConfig, meta: RangeMeta, mesh: Mesh, lam,
                  dp_prev=None, kt=None):
    """One LM trial: (shards', lam', stats, dp).  Both costs are psums, so
    every rank takes the same decision."""
    x0 = dp_prev if cfg.cg_warm_start else None
    dp, dl, stats, ok = range_build_and_solve(sh, cfg, lam, meta, mesh, x0, kt)
    cand = sh.with_state(*boxplus_state(sh.poses, sh.landmarks, dp, dl))
    cost_new = _range_robust_total(cand, cfg, meta, mesh, kt)
    accept = (cost_new < stats["chi2_robust"]) & ok
    poses = torch.where(accept, cand.poses, sh.poses)
    landmarks = torch.where(accept, cand.landmarks, sh.landmarks)
    new_lam = torch.where(accept, torch.clamp(lam * cfg.lm_down, min=cfg.lm_lambda_min),
                          torch.clamp(lam * cfg.lm_up, max=cfg.lm_lambda_max))
    stats = _step_stats(stats, ok, accept, lam, kt, cfg, dp, dl, mesh)
    dp_next = torch.where(accept, dp, torch.zeros_like(dp))
    return sh.with_state(poses, landmarks), new_lam, stats, dp_next


def range_solve_loop(sh: RangeShards, cfg: SolverConfig, meta: RangeMeta, mesh: Mesh,
                     lam0=None, dp0=None, start_iter: int = 0):
    """``cfg.iters`` GN or LM steps on the range layout: (shards', stats,
    dp_final), ``dp_final`` the rank's rows of the last outer delta.
    ``lam0`` restores the LM damping, ``dp0`` the warm-start delta and
    ``start_iter`` the GNC schedule's offset (the JAX package's loop has no
    offset, so its resumed GNC runs start the schedule again)."""
    from boslam_torch.solver.optimizer import _stack

    if cfg.optimizer not in ("gn", "lm"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    dev = sh.poses.device
    dp = torch.zeros_like(sh.poses) if dp0 is None else dp0
    lam = (torch.full((), cfg.lm_lambda0, dtype=sh.poses.dtype, device=dev)
           if lam0 is None else lam0)
    per_iter = []
    for i in range(cfg.iters):
        kt = cfg.kt_at(start_iter + i)
        if cfg.optimizer == "gn":
            sh, stats, dp = range_gn_step(sh, cfg, meta, mesh, dp, kt)
        else:
            sh, lam, stats, dp = range_lm_step(sh, cfg, meta, mesh, lam, dp, kt)
        per_iter.append(stats)
    stats = _stack(per_iter)
    if cfg.optimizer == "lm":
        stats["lam_final"] = lam
    return sh, stats, dp


def make_pose_range_solve(mesh: Mesh, cfg: SolverConfig, meta: RangeMeta,
                          lam0: float | None = None, start_iter: int = 0):
    """The range-sharded solve of a rank's shards: (RangeShards, dp0) ->
    (RangeShards', stats, dp_final), ``dp0`` the rank's rows [NPd, 3] of
    the warm-start delta (zeros when not resuming)."""
    def _solve(sh: RangeShards, dp0):
        lam = None if lam0 is None else torch.full((), lam0, dtype=sh.poses.dtype,
                                                   device=sh.poses.device)
        return range_solve_loop(sh, cfg, meta, mesh, lam0=lam, dp0=dp0, start_iter=start_iter)

    return _solve


def pose_range_solve(graph, cfg: SolverConfig, mesh: Mesh | None = None,
                     lam0: float | None = None, dp0=None, start_iter: int = 0):
    """One-shot: prepare, solve, gather and unpad.

    Returns (graph with the optimized state, stats) on every rank, the same
    full state everywhere (poses and landmarks all-gathered), as a global
    JAX array reads the same everywhere; ``stats["dp_final"]`` is the last
    outer delta [NP, 3].  ``lam0``, ``dp0`` and ``start_iter`` restore the
    LM damping, the warm-start delta and the GNC schedule on resume.
    """
    if mesh is None:
        mesh = make_mesh(graph.device)
    # the once-per-solve host preparation and its copies to the card
    with host_sync(mesh.device):
        arrays, meta = prepare_pose_range_host(graph, mesh.size)
        sh = place_pose_range(arrays, mesh)
        dp0_pad = np.zeros((meta.np_pad, 3), np.float32)
        if dp0 is not None:
            dp0_pad[: meta.n_poses] = (dp0.cpu().numpy() if isinstance(dp0, torch.Tensor)
                                       else np.asarray(dp0))
        dp0_local = put_sharded(dp0_pad, mesh)
    out, stats, dp_f = make_pose_range_solve(mesh, cfg, meta, lam0, start_iter)(sh, dp0_local)
    poses = mesh.all_gather(out.poses)[: meta.n_poses]
    landmarks = mesh.all_gather(out.landmarks)[: meta.n_landmarks]
    stats["dp_final"] = mesh.all_gather(dp_f)[: meta.n_poses].to(graph.device)
    return graph.with_state(poses.to(graph.device), landmarks.to(graph.device)), stats
