"""Linear pose-graph initialization: rotation averaging and linear
translation (port of ``boslam/init/pose_graph.py``).

At survey scale the odometry-integrated heading drifts by several
radians, which puts the solve's starting point far from the global basin,
and the threshold robust kernel clamps the loop closures that could pull
it out.  So the pose graph is initialized first:

1. **Rotation averaging**: minimize sum_e w_e (theta_d - theta_s -
   dtheta_e - 2*pi*k_e)^2, linear in 2D once the integer wraps k_e are
   fixed; the wraps are re-rounded from the current guess to convergence.
2. **Linear translation**: given the headings, the odometry translations
   are linear constraints t_d - t_s = R(theta_s) dt_e, solved by the same
   weighted-Laplacian least squares per coordinate.
3. Landmarks are re-triangulated from the initialized poses
   (``init/triangulation.py``, on the graph's device).

Both solves run on the host in float64, as in the JAX package, so on one
host both packages give the same bits.  The Laplacian of a SLAM sequence
is a chain plus NC loop closures: the anchored chain solves in closed form
by two prefix sums, and the closures are a rank-NC Woodbury update whose
NC x NC capacity matrix is factored densely.  ``landmark_rounds`` adds
virtual closures between trajectory segments that re-observe the same
landmarks (``virtual_closures``).
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("boslam_torch.init")

_TWO_PI = 2.0 * np.pi


def _wrap(a):
    return a - _TWO_PI * np.floor((a + np.pi) / _TWO_PI)


class _ChainPlusClosures:
    """Anchored (node 0 eliminated) Laplacian of a chain + closures.

    ``w_chain`` f64[NP-1] > 0 chain edge weights (edge e joins e, e+1);
    ``c_src``/``c_dst`` i64[NC] closure endpoints; ``w_clo`` f64[NC] > 0.
    ``solve(b)`` returns x with x[0] == 0 and (C + U W U^T) x = b on
    nodes >= 1 (b[0] is ignored — the anchored system drops that row).
    """

    def __init__(self, w_chain, c_src, c_dst, w_clo):
        n = len(w_chain) + 1
        self.n = n
        self.w_chain = w_chain
        self.c_src = c_src
        self.c_dst = c_dst
        # p_m = sum_{e < m} 1/w_e  (p[0] = 0): the chain resistance prefix
        self.p = np.concatenate([[0.0], np.cumsum(1.0 / w_chain)])
        self.nc = len(c_src)
        if self.nc:
            pm = lambda a, b: self.p[np.minimum(a[:, None], b[None, :])]
            G = (
                pm(c_dst, c_dst)
                - pm(c_dst, c_src)
                - pm(c_src, c_dst)
                + pm(c_src, c_src)
            )
            M = G + np.diag(1.0 / w_clo)
            # dense Cholesky of the SPD capacity matrix (numpy only)
            self._M_chol = np.linalg.cholesky(M)

    def _chain_solve(self, b):
        """x = C^{-1} b for the anchored chain (two prefix sums)."""
        # u_e = sum_{i >= e+1} b_i  (stationarity telescoped from the end)
        u = np.cumsum(b[::-1])[::-1][1:]
        x = np.empty(self.n, b.dtype)
        x[0] = 0.0
        np.cumsum(u / self.w_chain, out=x[1:])
        return x

    def solve(self, b):
        y = self._chain_solve(b)
        if not self.nc:
            return y
        uty = y[self.c_dst] - y[self.c_src]
        z = self._cho_solve(uty)
        # corr = sum_c z_c * C^{-1}(e_dst - e_src), using
        # (C^{-1} e_i)_m = p_min(i, m) and the split
        #   p_min(i, m) = p_m * [i >= m] + p_i * [i < m]:
        idx = np.concatenate([self.c_dst, self.c_src])
        coef = np.concatenate([z, -z])
        cnt = np.bincount(idx, weights=coef, minlength=self.n)
        cntp = np.bincount(idx, weights=coef * self.p[idx], minlength=self.n)
        s1 = np.cumsum(cnt[::-1])[::-1]  # sum over idx >= m
        s2 = np.concatenate([[0.0], np.cumsum(cntp)[:-1]])  # idx < m
        return y - (self.p * s1 + s2)

    def _cho_solve(self, rhs):
        L = self._M_chol
        y = np.linalg.solve(L, rhs)
        return np.linalg.solve(L.T, y)


def _split_chain(o_src, o_dst, n_poses):
    """Pick one i->i+1 edge per chain slot; everything else is a closure.

    Returns (chain_edge_ix i64[NP-1] or None, closure_mask bool[NO]).
    None when some consecutive pair has no edge (no chain spanning tree —
    the initializer declines rather than building a general tree).
    """
    is_fwd = o_dst == o_src + 1
    chain_ix = np.full(n_poses - 1, -1, np.int64)
    cand = np.nonzero(is_fwd)[0]
    # first edge wins per slot (iterate reversed so earlier overwrites)
    chain_ix[o_src[cand[::-1]]] = cand[::-1]
    if (chain_ix < 0).any():
        return None, None
    closure = np.ones(len(o_src), bool)
    closure[chain_ix] = False
    return chain_ix, closure


def linear_pose_init(
    poses0: np.ndarray,
    o_src: np.ndarray,
    o_dst: np.ndarray,
    o_meas: np.ndarray,
    o_omega: np.ndarray,
    fixed_ix: int,
    wrap_rounds: int = 3,
    extra: "tuple | None" = None,
) -> np.ndarray:
    """Rotation-averaged + linearly-translated poses (f64 host math).

    ``extra`` optionally appends VIRTUAL closure edges
    (src, dst, meas[,3], w_th, w_tr) — e.g. the landmark-reobservation
    constraints of ``virtual_closures`` — to the measurement set.
    Falls back to ``poses0`` (with a warning) when the odometry graph has
    no full i->i+1 chain to use as the spanning tree.
    """
    NP_ = poses0.shape[0]
    o_src = np.asarray(o_src, np.int64)
    o_dst = np.asarray(o_dst, np.int64)
    if NP_ < 2 or len(o_src) == 0:
        return np.asarray(poses0)

    poses0 = np.asarray(poses0, np.float64)
    meas = np.asarray(o_meas, np.float64)
    omega = np.asarray(o_omega, np.float64)
    w_th = np.maximum(omega[:, 2, 2], 1e-12)
    w_tr = np.maximum(0.5 * (omega[:, 0, 0] + omega[:, 1, 1]), 1e-12)
    if extra is not None and len(extra[0]):
        e_src, e_dst, e_meas, e_wth, e_wtr = extra
        o_src = np.concatenate([o_src, np.asarray(e_src, np.int64)])
        o_dst = np.concatenate([o_dst, np.asarray(e_dst, np.int64)])
        meas = np.concatenate([meas, np.asarray(e_meas, np.float64)])
        w_th = np.concatenate([w_th, np.asarray(e_wth, np.float64)])
        w_tr = np.concatenate([w_tr, np.asarray(e_wtr, np.float64)])

    chain_ix, closure_mask = _split_chain(o_src, o_dst, NP_)
    if chain_ix is None:
        logger.warning(
            "pose-graph init skipped: odometry has no full i->i+1 chain"
        )
        return np.asarray(poses0)

    clo = np.nonzero(closure_mask)[0]
    c_src, c_dst = o_src[clo], o_dst[clo]

    # ---------------- rotation averaging (iterative wrap rounding) ------
    A_th = _ChainPlusClosures(w_th[chain_ix], c_src, c_dst, w_th[clo])
    dth = meas[:, 2]
    theta = poses0[:, 2].copy()
    k = np.round((theta[o_dst] - theta[o_src] - dth) / _TWO_PI)
    for _ in range(max(1, wrap_rounds)):
        m = dth + _TWO_PI * k
        bw = np.bincount(
            o_dst, weights=w_th * m, minlength=NP_
        ) - np.bincount(o_src, weights=w_th * m, minlength=NP_)
        theta = A_th.solve(bw)
        k_new = np.round((theta[o_dst] - theta[o_src] - dth) / _TWO_PI)
        if np.array_equal(k, k_new):
            break
        k = k_new
    theta = theta + (poses0[fixed_ix, 2] - theta[fixed_ix])

    # ---------------- linear translation given headings -----------------
    A_tr = _ChainPlusClosures(w_tr[chain_ix], c_src, c_dst, w_tr[clo])
    c, s = np.cos(theta[o_src]), np.sin(theta[o_src])
    mx = c * meas[:, 0] - s * meas[:, 1]  # R(theta_s) @ dt, world frame
    my = s * meas[:, 0] + c * meas[:, 1]
    t = np.empty((NP_, 2))
    for d, m in ((0, mx), (1, my)):
        b = np.bincount(o_dst, weights=w_tr * m, minlength=NP_) - np.bincount(
            o_src, weights=w_tr * m, minlength=NP_
        )
        t[:, d] = A_tr.solve(b)
    t += poses0[fixed_ix, :2] - t[fixed_ix]

    out = np.empty((NP_, 3), np.float64)
    out[:, :2] = t
    # wrap to [-pi, pi) for cleanliness (residuals wrap differences anyway)
    out[:, 2] = np.arctan2(np.sin(theta), np.cos(theta))
    return out


def _cluster_triangulate(poses, b_pose, b_lm, b_meas, gap=200):
    """Per-(landmark, temporal-cluster) triangulation from current poses.

    A landmark re-observed on a later trajectory pass gets one cluster per
    pass (split where consecutive observing-pose indices jump by > gap).
    Returns (cl_lm, cl_anchor, cl_xy, cl_ok, n_obs) over clusters.
    """
    order = np.lexsort((b_pose, b_lm))
    lm_s = b_lm[order]
    po_s = b_pose[order]
    me_s = b_meas[order]
    new_lm = np.diff(lm_s, prepend=-1) != 0
    brk = new_lm | (np.diff(po_s, prepend=0) > gap)
    cid = np.cumsum(brk) - 1
    C = int(cid[-1]) + 1 if len(cid) else 0

    p = poses[po_s]
    ang = p[:, 2] + me_s
    s, c = np.sin(ang), np.cos(ang)
    rhs = s * p[:, 0] - c * p[:, 1]
    a11 = np.bincount(cid, s * s, C)
    a12 = np.bincount(cid, -s * c, C)
    a22 = np.bincount(cid, c * c, C)
    b1 = np.bincount(cid, s * rhs, C)
    b2 = np.bincount(cid, -c * rhs, C)
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    ok = det > 1e-4 * np.maximum(tr * tr, 1e-12)
    d = np.where(ok, det, 1.0)
    xy = np.stack([(a22 * b1 - a12 * b2) / d, (a11 * b2 - a12 * b1) / d], 1)
    n_obs = np.bincount(cid, None, C)
    anchor = (
        np.bincount(cid, po_s.astype(np.float64), C) / np.maximum(n_obs, 1)
    ).astype(np.int64)
    cl_lm = lm_s[np.nonzero(brk)[0]]
    ok = ok & (n_obs >= 2)
    return cl_lm, anchor, xy, ok, n_obs


def virtual_closures(
    poses, b_pose, b_lm, b_meas, seg: int = 64, gap: int = 200,
    min_pairs: int = 4,
):
    """SE(2) constraints between trajectory segments from RE-OBSERVED
    landmarks (the r5 scale-campaign initializer upgrade).

    Why: the odometry-only rotation averaging leaves heading errors ~0.3
    rad at 100k (its posterior given 1000 closures), which puts the
    subsequent solve in a bent local basin 370 chi2 above the true one
    (PERF.md r5).  But the BEARINGS carry vastly more loop-closure
    information: every landmark seen on two passes ties those passes
    together.  Per landmark and pass we triangulate independently
    (_cluster_triangulate), then for each SEGMENT PAIR with >= min_pairs
    common landmarks a 2D Procrustes fit of the two point clouds yields a
    rigid relative-pose constraint (with a robust 3*median trim), emitted
    as a virtual odometry closure between the segments' anchor poses.
    """
    cl_lm, anchor, xy, ok, n_obs = _cluster_triangulate(
        poses, b_pose, b_lm, b_meas, gap
    )
    # pairs of clusters of the same landmark
    idx = np.nonzero(ok)[0]
    lm_o = cl_lm[idx]
    # landmarks sorted already; consecutive clusters of the same lm pair up
    src_list, dst_list, pa_list, pb_list = [], [], [], []
    starts = np.nonzero(np.diff(lm_o, prepend=-1) != 0)[0]
    counts = np.diff(np.append(starts, len(lm_o)))
    for st, ct in zip(starts, counts):
        if ct < 2:
            continue
        cl = idx[st : st + ct]
        for i in range(ct):
            for j in range(i + 1, ct):
                a, b = cl[i], cl[j]
                src_list.append(a)
                dst_list.append(b)
    if not src_list:
        return (np.zeros(0, np.int64),) * 2 + (
            np.zeros((0, 3)), np.zeros(0), np.zeros(0),
        )
    ca = np.asarray(src_list)
    cb = np.asarray(dst_list)
    key = (anchor[ca] // seg) * (2 ** 32) + (anchor[cb] // seg)
    uk, inv = np.unique(key, return_inverse=True)

    srcs, dsts, meass, wths, wtrs = [], [], [], [], []
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(uk) + 1))
    for gix in range(len(uk)):
        sl = order[bounds[gix] : bounds[gix + 1]]
        if len(sl) < min_pairs:
            continue
        A = xy[ca[sl]]  # earlier-pass landmark positions
        Bp = xy[cb[sl]]  # later-pass positions (same landmarks)
        aA = int(np.median(anchor[ca[sl]]))
        aB = int(np.median(anchor[cb[sl]]))
        if abs(aA - aB) <= seg:
            continue
        # Procrustes D: B -> A (with one robust re-fit)
        keep = np.ones(len(sl), bool)
        for _ in range(2):
            Am, Bm = A[keep].mean(0), Bp[keep].mean(0)
            dA, dB = A[keep] - Am, Bp[keep] - Bm
            dot = float((dA * dB).sum())
            crs = float((dB[:, 0] * dA[:, 1] - dB[:, 1] * dA[:, 0]).sum())
            phi = np.arctan2(crs, dot)
            cph, sph = np.cos(phi), np.sin(phi)
            R = np.array([[cph, -sph], [sph, cph]])
            res = A - ((Bp - Bm) @ R.T + Am)
            rn = np.linalg.norm(res, axis=1)
            med = np.median(rn[keep])
            new_keep = rn <= max(3.0 * med, 1e-6)
            if new_keep.sum() < min_pairs:
                break
            if (new_keep == keep).all():
                break
            keep = new_keep
        n = int(keep.sum())
        if n < min_pairs:
            continue
        r2 = float(np.mean(rn[keep] ** 2)) + 1e-4
        rho2 = float(np.mean((dA**2).sum(1))) + 1e-6
        # virtual measurement: relative pose of (D o X_b) in X_a's frame
        pa, pb = poses[aA], poses[aB]
        tb = (pb[:2] - Bm) @ R.T + Am
        thb = pb[2] + phi
        cA, sA = np.cos(pa[2]), np.sin(pa[2])
        dxy = tb - pa[:2]
        z = np.array(
            [
                cA * dxy[0] + sA * dxy[1],
                -sA * dxy[0] + cA * dxy[1],
                _wrap(thb - pa[2]),
            ]
        )
        # weights from the fit: translation ~ n/r2, heading ~ n*rho2/r2,
        # capped at the real odometry edge's information
        wtr = min(500.0, 0.5 * n / r2)
        wth = min(5000.0, 0.5 * n * rho2 / r2)
        srcs.append(aA)
        dsts.append(aB)
        meass.append(z)
        wths.append(wth)
        wtrs.append(wtr)
    if not srcs:
        return (np.zeros(0, np.int64),) * 2 + (
            np.zeros((0, 3)), np.zeros(0), np.zeros(0),
        )
    return (
        np.asarray(srcs, np.int64),
        np.asarray(dsts, np.int64),
        np.asarray(meass),
        np.asarray(wths),
        np.asarray(wtrs),
    )


def pgo_initialize(graph, wrap_rounds: int = 3, landmark_rounds: int = 0):
    """Return ``graph`` with rotation-averaged poses and re-triangulated
    landmarks, on the graph's device (the CLI's ``--pgo-init``).

    ``landmark_rounds > 0`` iterates the linear init with virtual closures
    derived from re-observed landmarks (``virtual_closures``), each round
    from the improved poses.  The edges are read to the host once; the
    triangulation runs on the graph's device.
    """
    import torch

    from boslam_torch.device import host_sync
    from boslam_torch.init.triangulation import triangulate_landmarks

    with host_sync(graph.device):
        o_args = tuple(t.cpu().numpy() for t in (graph.o_src, graph.o_dst, graph.o_meas,
                                                 graph.o_omega))
        b_pose = graph.b_pose.cpu().numpy()
        b_lm = graph.b_lm.cpu().numpy()
        b_meas = graph.b_meas.cpu().numpy().astype(np.float64)
        fixed = int(graph.fixed_pose_ix)
        poses0 = graph.poses.cpu().numpy()

        poses = linear_pose_init(poses0, *o_args, fixed, wrap_rounds=wrap_rounds)
        for _ in range(landmark_rounds):
            extra = virtual_closures(poses, b_pose, b_lm, b_meas)
            if not len(extra[0]):
                break
            poses = linear_pose_init(poses, *o_args, fixed, wrap_rounds=wrap_rounds, extra=extra)
        poses_t = torch.as_tensor(np.asarray(poses, np.float32), device=graph.device)
    landmarks = triangulate_landmarks(poses_t, graph.b_pose, graph.b_lm, graph.b_meas,
                                      n_landmarks=graph.n_landmarks)
    return graph.with_state(poses_t, landmarks)
