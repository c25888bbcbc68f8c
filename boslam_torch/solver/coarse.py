"""Rigid-segment coarse correction (port of ``boslam/solver/coarse.py``).

At survey scale the map's long-wavelength bending modes have Hessian
eigenvalues far below the stiff local modes, so a damped f32 Krylov step
barely moves them.  The multiscale answer: project the problem onto rigid
motions of trajectory segments, where bending modes become stiff, and
solve that small system exactly in f64.

Coarse space: segment k (``seg`` consecutive poses) gets 3 dof (dt_k,
dtheta_k), a rigid motion about the segment's anchor in the same
left-multiplicative chart as the fine boxplus, so the coarse Jacobian of
any edge is an exact linear map of its fine Jacobian.  Landmarks are
eliminated exactly per landmark (Schur): a landmark co-observed from two
segments couples them, which is the bending information the bearings
carry.

Everything runs on the host in float64, as in the JAX package: assembly by
bincount/einsum over per-(landmark, segment) aggregates, one dense
Cholesky of the [3*NS, 3*NS] coarse system, rigid prolongation with
backtracking on the true robust cost, and landmark re-triangulation (f32,
on the graph's device).  ``tools/port_converge_bench.py`` applies it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from boslam_torch.device import host_sync

_TWO_PI = 2.0 * np.pi


def _wrap(a):
    return a - _TWO_PI * np.floor((a + np.pi) / _TWO_PI)


class HostEdges(NamedTuple):
    """A graph's edges and gauge pose as host numpy arrays, read once."""

    b_pose: np.ndarray
    b_lm: np.ndarray
    b_meas: np.ndarray
    b_omega: np.ndarray
    o_src: np.ndarray
    o_dst: np.ndarray
    o_meas: np.ndarray
    o_omega: np.ndarray
    fixed_pose_ix: int


def host_edges(graph) -> HostEdges:
    """Read ``graph``'s edges to the host (one wait for the card)."""
    if isinstance(graph, HostEdges):
        return graph
    with host_sync(graph.device):
        return HostEdges(*(getattr(graph, f).cpu().numpy() for f in HostEdges._fields[:-1]),
                         int(graph.fixed_pose_ix))


def _bearing_terms(poses, lms, b_pose, b_lm, b_meas):
    p = poses[b_pose]
    l = lms[b_lm]
    c, s = np.cos(p[:, 2]), np.sin(p[:, 2])
    dx, dy = l[:, 0] - p[:, 0], l[:, 1] - p[:, 1]
    gx = c * dx + s * dy
    gy = -s * dx + c * dy
    err = _wrap(np.arctan2(gy, gx) - b_meas)
    n2 = np.maximum(gx * gx + gy * gy, 1e-300)
    ax, ay = -gy / n2, gx / n2
    gRx = ax * c - ay * s
    gRy = ax * s + ay * c
    jth = ax * (c * l[:, 1] - s * l[:, 0]) + ay * (-s * l[:, 1] - c * l[:, 0])
    jp = np.stack([-gRx, -gRy, jth], 1)
    jl = np.stack([gRx, gRy], 1)
    return err, jp, jl


def _odo_terms(poses, o_src, o_dst, o_meas):
    sp, dp = poses[o_src], poses[o_dst]
    c, s = np.cos(sp[:, 2]), np.sin(sp[:, 2])
    rx, ry = dp[:, 0] - sp[:, 0], dp[:, 1] - sp[:, 1]
    e = np.stack(
        [
            c * rx + s * ry - o_meas[:, 0],
            -s * rx + c * ry - o_meas[:, 1],
            _wrap(dp[:, 2] - sp[:, 2] - o_meas[:, 2]),
        ],
        1,
    )
    tdx, tdy = dp[:, 0], dp[:, 1]
    thdx = -c * tdy + s * tdx
    thdy = s * tdy + c * tdx
    z = np.zeros_like(c)
    o = np.ones_like(c)
    js = np.stack(
        [
            np.stack([-c, -s, -thdx], 1),
            np.stack([s, -c, -thdy], 1),
            np.stack([z, z, -o], 1),
        ],
        1,
    )
    jd = np.stack(
        [
            np.stack([c, s, thdx], 1),
            np.stack([-s, c, thdy], 1),
            np.stack([z, z, o], 1),
        ],
        1,
    )
    return e, js, jd


def _coarsen_pose_jac(j3, cx, cy):
    """Fine 3-dof pose Jacobian -> 3-dof segment Jacobian.

    The segment perturbation (dt, dtheta) rotates about the segment
    anchor c; in the left-boxplus chart that is the pose perturbation
    (dt + dtheta*J*(-c), dtheta) with J the rotation generator, so the
    theta column picks up jx*cy - jy*cx.  ``j3`` [..., 3] or [..., r, 3].
    """
    out = j3.copy()
    out[..., 2] = j3[..., 0] * cy + j3[..., 1] * (-cx) + j3[..., 2]
    return out


def _robust_w(chi2, kt):
    if kt is None:
        return np.ones_like(chi2)
    w = np.sqrt(kt / np.maximum(chi2, 1e-300))
    return np.where(chi2 > kt, w, 1.0)


def robust_cost_np(chi2, kt):
    return np.minimum(chi2, kt) if kt is not None else chi2


def total_cost(poses, lms, g, kt=None):
    """Host f64 robust objective (threshold kernel when kt given); ``g`` a
    graph or its ``host_edges``."""
    g = host_edges(g)
    b_pose = np.asarray(g.b_pose)
    err, _, _ = _bearing_terms(
        poses, lms, b_pose, np.asarray(g.b_lm), np.asarray(g.b_meas, np.float64)
    )
    bchi2 = np.asarray(g.b_omega, np.float64) * err * err
    e, _, _ = _odo_terms(
        poses, np.asarray(g.o_src), np.asarray(g.o_dst),
        np.asarray(g.o_meas, np.float64),
    )
    om = np.asarray(g.o_omega, np.float64)
    ochi2 = np.einsum("ei,eij,ej->e", e, om, e)
    return float(
        robust_cost_np(bchi2, kt).sum() + robust_cost_np(ochi2, kt).sum()
    )


def _solve_coarse(poses, lms, g, seg, kt, lm_damping, c_damping):
    """Assemble + solve the landmark-eliminated coarse system in f64.

    Returns (dc f64[NS, 3], centers f64[NS, 2], seg_of_pose i64[NP]).
    ``g`` is the graph's ``host_edges``.
    """
    NP_ = poses.shape[0]
    NS = -(-NP_ // seg)
    seg_of = np.arange(NP_) // seg
    # segment anchors: mean position (any anchor works; the mean keeps the
    # rotation lever arms small -> better conditioning)
    cx = np.bincount(seg_of, poses[:, 0], NS) / np.bincount(seg_of, None, NS)
    cy = np.bincount(seg_of, poses[:, 1], NS) / np.bincount(seg_of, None, NS)

    b_pose = np.asarray(g.b_pose)
    b_lm = np.asarray(g.b_lm)
    NL = lms.shape[0]
    err, jp, jl = _bearing_terms(
        poses, lms, b_pose, b_lm, np.asarray(g.b_meas, np.float64)
    )
    om_b = np.asarray(g.b_omega, np.float64)
    w = _robust_w(om_b * err * err, kt)
    omw = om_b * w  # symmetric IRLS weight (coarse correction uses the
    # textbook form; the b-side-only quirk is a fine-solver parity detail)
    k_e = seg_of[b_pose]
    jc = _coarsen_pose_jac(jp, cx[k_e], cy[k_e])

    H = np.zeros((NS, NS, 3, 3))
    bvec = np.zeros((NS, 3))

    # --- bearing: segment-diagonal J^T Omega J and gradient ---
    HdiagC = np.zeros((NS, 3, 3))
    for i in range(3):
        bvec[:, i] += np.bincount(k_e, omw * err * jc[:, i], NS)
        for j in range(3):
            HdiagC[:, i, j] += np.bincount(
                k_e, omw * jc[:, i] * jc[:, j], NS
            )

    # --- landmark blocks + per-(landmark, segment) coupling aggregates ---
    Hll = np.zeros((NL, 2, 2))
    bl = np.zeros((NL, 2))
    for i in range(2):
        bl[:, i] = np.bincount(b_lm, omw * err * jl[:, i], NL)
        for j in range(2):
            Hll[:, i, j] = np.bincount(b_lm, omw * jl[:, i] * jl[:, j], NL)
    Hll[:, 0, 0] += lm_damping
    Hll[:, 1, 1] += lm_damping
    det = Hll[:, 0, 0] * Hll[:, 1, 1] - Hll[:, 0, 1] * Hll[:, 1, 0]
    Hinv = (
        np.stack(
            [
                np.stack([Hll[:, 1, 1], -Hll[:, 0, 1]], -1),
                np.stack([-Hll[:, 1, 0], Hll[:, 0, 0]], -1),
            ],
            -2,
        )
        / det[:, None, None]
    )

    key = b_lm.astype(np.int64) * NS + k_e
    uk, inv = np.unique(key, return_inverse=True)
    G = len(uk)
    ug = np.zeros((G, 3, 2))
    for i in range(3):
        for j in range(2):
            ug[:, i, j] = np.bincount(inv, omw * jc[:, i] * jl[:, j], G)
    gl = (uk // NS).astype(np.int64)
    gs = (uk % NS).astype(np.int64)

    # rhs correction: + U Hll^-1 bl  (solving H dc = -b + U Hinv bl)
    hb = np.einsum("lij,lj->li", Hinv, bl)  # [NL, 2]
    v = np.einsum("gij,gj->gi", ug, hb[gl])  # [G, 3]
    for i in range(3):
        bvec[:, i] -= np.bincount(gs, v[:, i], NS)

    # Schur cross terms over group pairs within each landmark
    counts = np.bincount(gl, minlength=NL)
    Smax = int(counts.max()) if G else 1
    # padded [NL, Smax] group table
    order = np.argsort(gl, kind="stable")
    seg_start = np.zeros(NL, np.int64)
    np.cumsum(counts[:-1], out=seg_start[1:])
    rank = np.arange(G) - seg_start[gl[order]]
    gtab = np.full((NL, Smax), -1, np.int64)
    gtab[gl[order], rank] = order
    valid = gtab >= 0
    gtab_c = np.where(valid, gtab, 0)
    U_pad = ug[gtab_c] * valid[:, :, None, None]  # [NL, Smax, 3, 2]
    corr = np.einsum("lsij,ljk,ltmk->lstim", U_pad, Hinv, U_pad)
    segpair = gs[gtab_c]  # [NL, Smax]
    ka = np.broadcast_to(segpair[:, :, None], corr.shape[:3]).reshape(-1)
    kb = np.broadcast_to(segpair[:, None, :], corr.shape[:3]).reshape(-1)
    pv = (valid[:, :, None] & valid[:, None, :]).reshape(-1)
    flat = corr.reshape(-1, 3, 3)[pv]
    np.add.at(H, (ka[pv], kb[pv]), -flat)

    # --- odometry ---
    o_src = np.asarray(g.o_src)
    o_dst = np.asarray(g.o_dst)
    e, js, jd = _odo_terms(poses, o_src, o_dst, np.asarray(g.o_meas, np.float64))
    om_o = np.asarray(g.o_omega, np.float64)
    ochi2 = np.einsum("ei,eij,ej->e", e, om_o, e)
    wo = _robust_w(ochi2, kt)
    a_e = seg_of[o_src]
    b_e = seg_of[o_dst]
    jcs = _coarsen_pose_jac(js, cx[a_e][:, None], cy[a_e][:, None])
    jcd = _coarsen_pose_jac(jd, cx[b_e][:, None], cy[b_e][:, None])
    Omw = om_o * wo[:, None, None]
    Hss = np.einsum("eai,eab,ebj->eij", jcs, Omw, jcs)
    Hdd = np.einsum("eai,eab,ebj->eij", jcd, Omw, jcd)
    Hsd = np.einsum("eai,eab,ebj->eij", jcs, Omw, jcd)
    ew = np.einsum("eab,eb->ea", Omw, e)
    gs_o = np.einsum("eai,ea->ei", jcs, ew)
    gd_o = np.einsum("eai,ea->ei", jcd, ew)
    np.add.at(H, (a_e, a_e), Hss)
    np.add.at(H, (b_e, b_e), Hdd)
    np.add.at(H, (a_e, b_e), Hsd)
    np.add.at(H, (b_e, a_e), np.swapaxes(Hsd, 1, 2))
    for i in range(3):
        bvec[:, i] += np.bincount(a_e, gs_o[:, i], NS)
        bvec[:, i] += np.bincount(b_e, gd_o[:, i], NS)

    # fold the bearing diagonal in, damp, gauge-fix the fixed segment
    idx = np.arange(NS)
    H[idx, idx] += HdiagC
    Hd = H.transpose(0, 2, 1, 3).reshape(3 * NS, 3 * NS)
    Hd[np.arange(3 * NS), np.arange(3 * NS)] += c_damping
    k_fix = int(np.asarray(g.fixed_pose_ix)) // seg
    m = np.ones(3 * NS)
    m[3 * k_fix : 3 * k_fix + 3] = 0.0
    Hd = Hd * m[:, None] * m[None, :]
    Hd[np.arange(3 * NS), np.arange(3 * NS)] += 1.0 - m
    rhs = -bvec.reshape(-1) * m

    L = np.linalg.cholesky(Hd)
    dc = np.linalg.solve(L.T, np.linalg.solve(L, rhs)).reshape(NS, 3)
    return dc, np.stack([cx, cy], 1), seg_of


def _apply_rigid(poses, dc, centers, seg_of, alpha):
    """Exact rigid prolongation (not the linearization): segment k rotates
    about ITS ANCHOR c_k — t' = c + R(a*dth)(t - c) + a*dt — matching the
    chart the coarse Jacobians were assembled in (the anchor-relative
    theta column of _coarsen_pose_jac)."""
    d = dc[seg_of] * alpha
    cen = centers[seg_of]
    c, s = np.cos(d[:, 2]), np.sin(d[:, 2])
    rx = poses[:, 0] - cen[:, 0]
    ry = poses[:, 1] - cen[:, 1]
    out = poses.copy()
    out[:, 0] = cen[:, 0] + c * rx - s * ry + d[:, 0]
    out[:, 1] = cen[:, 1] + s * rx + c * ry + d[:, 1]
    out[:, 2] = _wrap(poses[:, 2] + d[:, 2])
    return out


def coarse_correct(
    graph,
    seg: int = 64,
    rounds: int = 3,
    kt: "float | None" = None,
    lm_damping: float = 1e-6,
    c_damping: float = 1e-6,
):
    """Apply up to ``rounds`` rigid-segment coarse corrections.

    Returns (graph with updated poses and re-triangulated landmarks, on the
    graph's device; info dict).  Each round: assemble and solve the f64
    coarse system at the current state, backtrack alpha in {1, 1/2, 1/4,
    1/8} on the true (host f64) robust cost, stop early when no alpha
    improves.  The host reads the card inside ``device.host_sync``.
    """
    import torch

    from boslam_torch.init.triangulation import triangulate_landmarks

    dev, dtype = graph.device, graph.poses.dtype
    edges = host_edges(graph)
    with host_sync(dev):
        poses = graph.poses.cpu().numpy().astype(np.float64)
        lms = graph.landmarks.cpu().numpy().astype(np.float64)
        cost = total_cost(poses, lms, edges, kt)
        info = {"cost_trace": [cost], "alphas": []}
        for _ in range(rounds):
            dc, centers, seg_of = _solve_coarse(poses, lms, edges, seg, kt, lm_damping, c_damping)
            took = None
            for alpha in (1.0, 0.5, 0.25, 0.125):
                cand = _apply_rigid(poses, dc, centers, seg_of, alpha)
                cand_lms = triangulate_landmarks(
                    torch.as_tensor(cand.astype(np.float32), device=dev), graph.b_pose,
                    graph.b_lm, graph.b_meas, n_landmarks=graph.n_landmarks,
                ).cpu().numpy().astype(np.float64)
                c_new = total_cost(cand, cand_lms, edges, kt)
                if c_new < cost:
                    poses, lms, cost, took = cand, cand_lms, c_new, alpha
                    break
            info["alphas"].append(took)
            info["cost_trace"].append(cost)
            if took is None:
                break
        final = graph.with_state(torch.as_tensor(poses, dtype=dtype, device=dev),
                                 torch.as_tensor(lms, dtype=dtype, device=dev))
    return final, info
