"""Synthetic bearing-only SLAM sequence generator (numpy copy of
``boslam/synth.py``, so the port makes the same graphs without JAX).

The reference ships only fixed datasets (SURVEY §2 C13); scaling runs need
10k/100k-pose sequences (BASELINE.json configs 4-5).  This generates a
Manhattan-world-style trajectory with landmark observations matching the
reference data's statistics (odometry Omega diag [500, 500, 5000], bearing
omega 1, ~7 bearing observations per pose, FIX on one pose), returns a
``ParsedG2O`` (so it flows through the exact same build path as file data),
and can also serve as a *noiseless* ground-truth fixture: with zero noise
the generated state is exactly the optimum, the contract the reference's
``testone`` fixture approximates (tests/testone.cpp:33-42).
"""

from __future__ import annotations

import numpy as np

from boslam_torch.io.g2o import ParsedG2O


def _knn_bruteforce(queries, points, k, max_range, chunk=2048):
    """k nearest ``points`` per query row, scipy-free.

    Matches cKDTree.query's contract with distance_upper_bound: entries
    beyond ``max_range`` carry inf distance and index == len(points).
    Chunked over queries so the [chunk, NL] distance matrix stays small.
    """
    nq, npt = queries.shape[0], points.shape[0]
    k_eff = min(k, npt)
    dists = np.full((nq, k), np.inf)
    near = np.full((nq, k), npt, dtype=np.int64)
    for s in range(0, nq, chunk):
        q = queries[s : s + chunk]
        d2 = ((q[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        idx = np.argpartition(d2, k_eff - 1, axis=1)[:, :k_eff]
        dd = np.take_along_axis(d2, idx, axis=1)
        order = np.argsort(dd, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        dd = np.sqrt(np.take_along_axis(dd, order, axis=1))
        bad = dd > max_range
        dd[bad] = np.inf
        idx[bad] = npt
        dists[s : s + chunk, :k_eff] = dd
        near[s : s + chunk, :k_eff] = idx
    return dists, near


def generate_sequence(
    n_poses: int,
    n_landmarks: int | None = None,
    *,
    seed: int = 0,
    step_len: float = 1.0,
    turn_every: int = 50,
    obs_per_pose: int = 7,
    max_range: float = 12.0,
    odom_noise: tuple[float, float] = (0.02, 0.005),
    bearing_noise: float = 0.01,
    init_noise: tuple[float, float] = (0.05, 0.01),
    loop_closures: int = 0,
    loop_closure_min_sep: int = 40,
) -> tuple[ParsedG2O, ParsedG2O]:
    """Returns (initial_guess, ground_truth) ParsedG2O pairs.

    The ground-truth parse carries exact poses + VERTEX_XY landmarks and
    *noisy* edges (mirroring the real data, where ig and gt files share the
    same edge set — verified byte-identical).  The initial guess carries
    odometry-integrated noisy poses and no landmarks.  Set all noises to 0
    for an exact noiseless fixture.

    ``loop_closures``: number of extra non-chain odometry edges between
    spatially-near, temporally-distant pose pairs (the general (i, j)
    topology of framework/observation.hpp:43-47), appended after the chain
    edges so the packed solver keeps its chain-prefix fast path.
    """
    rng = np.random.default_rng(seed)
    if n_landmarks is None:
        n_landmarks = max(8, n_poses // 2)

    # --- ground-truth trajectory: noisy Manhattan-ish walk ---
    # (fully vectorized: the heading is a cumsum of per-step increments and
    # the position a cumsum of unit steps — the 1M-pose regime needs this;
    # the per-pose Python loop took minutes at 300k and hours at 1M)
    inc = rng.normal(0, 0.01, n_poses)
    turn_ix = np.nonzero((np.arange(n_poses) + 1) % turn_every == 0)[0]
    inc[turn_ix] += rng.choice([-np.pi / 2, np.pi / 2], turn_ix.size)
    h_step = np.cumsum(inc)  # heading AFTER the i-th update
    h_rec = h_step - inc  # heading recorded at pose i
    steps = step_len * np.stack([np.cos(h_step), np.sin(h_step)], 1)
    pos_rec = np.concatenate(
        [np.zeros((1, 2)), np.cumsum(steps, 0)[:-1]]
    )
    xyt = np.concatenate([pos_rec, h_rec[:, None]], 1)

    # --- landmarks scattered around the trajectory ---
    t_ix = rng.integers(0, n_poses, n_landmarks)
    offs = rng.uniform(-max_range * 0.6, max_range * 0.6, (n_landmarks, 2))
    lms = xyt[t_ix, :2] + offs

    # --- bearing observations: k nearest landmarks per pose ---
    # (scipy's cKDTree when available; a chunked brute-force fallback keeps
    # a scipy-less install working — ADVICE r3: pyproject declares only
    # jax + numpy, so the generator must not hard-require scipy)
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        cKDTree = None
    if cKDTree is not None:
        tree = cKDTree(lms)
        dists, near = tree.query(
            xyt[:, :2], k=obs_per_pose, distance_upper_bound=max_range
        )
        if obs_per_pose == 1:
            dists, near = dists[:, None], near[:, None]
    else:
        dists, near = _knn_bruteforce(
            xyt[:, :2], lms, obs_per_pose, max_range
        )
    valid = np.isfinite(dists)
    b_pose = np.nonzero(valid)[0]
    b_lm = near[valid]
    dxy = lms[b_lm] - xyt[b_pose, :2]
    alpha = np.arctan2(dxy[:, 1], dxy[:, 0]) - xyt[b_pose, 2]
    alpha = (alpha + np.pi) % (2 * np.pi) - np.pi
    b_meas = alpha + rng.normal(0, bearing_noise, alpha.size)

    # drop landmarks never observed (keeps the problem well-posed)
    observed = np.zeros(n_landmarks, bool)
    observed[b_lm] = True
    remap = -np.ones(n_landmarks, int)
    remap[observed] = np.arange(observed.sum())
    lms = lms[observed]
    b_lm = remap[b_lm]
    n_landmarks = int(observed.sum())

    # --- odometry edges with the reference's information matrix ---
    o_src = np.arange(n_poses - 1)
    o_dst = o_src + 1
    c, sn = np.cos(xyt[:-1, 2]), np.sin(xyt[:-1, 2])
    dt = xyt[1:, :2] - xyt[:-1, :2]
    dth = (xyt[1:, 2] - xyt[:-1, 2] + np.pi) % (2 * np.pi) - np.pi
    o_meas = np.stack(
        [
            c * dt[:, 0] + sn * dt[:, 1]
            + rng.normal(0, odom_noise[0], n_poses - 1),
            -sn * dt[:, 0] + c * dt[:, 1]
            + rng.normal(0, odom_noise[0], n_poses - 1),
            dth + rng.normal(0, odom_noise[1], n_poses - 1),
        ],
        1,
    )
    # --- loop closures: near-revisit pose pairs, appended after the chain ---
    if loop_closures > 0 and n_poses > loop_closure_min_sep:
        lc_src, lc_dst, lc_meas = [], [], []
        seen_pairs = set()
        tries = 0
        while len(lc_src) < loop_closures and tries < 50 * loop_closures:
            tries += 1
            i = int(rng.integers(0, n_poses - loop_closure_min_sep))
            # spatially-nearest later pose outside the separation window
            # (the measurement comes from the ground truth, so the edge is
            # consistent whatever the revisit distance)
            cand = np.arange(i + loop_closure_min_sep, n_poses)
            d2 = ((xyt[cand, :2] - xyt[i, :2]) ** 2).sum(1)
            j = int(cand[np.argmin(d2)])
            if (i, j) in seen_pairs:
                continue
            seen_pairs.add((i, j))
            s, d = xyt[i], xyt[j]
            c, sn = np.cos(s[2]), np.sin(s[2])
            dt = d[:2] - s[:2]
            mx = c * dt[0] + sn * dt[1] + rng.normal(0, odom_noise[0])
            my = -sn * dt[0] + c * dt[1] + rng.normal(0, odom_noise[0])
            dth = (d[2] - s[2] + np.pi) % (2 * np.pi) - np.pi
            lc_src.append(i)
            lc_dst.append(j)
            lc_meas.append((mx, my, dth + rng.normal(0, odom_noise[1])))
        if lc_src:
            o_src = np.concatenate([o_src, np.asarray(lc_src)])
            o_dst = np.concatenate([o_dst, np.asarray(lc_dst)])
            o_meas = np.concatenate([o_meas, np.asarray(lc_meas, np.float64)])

    omega = np.broadcast_to(
        np.diag([500.0, 500.0, 5000.0]).astype(np.float32),
        (len(o_src), 3, 3),
    ).copy()

    # --- initial guess: integrate the noisy odometry (+ extra jitter) ---
    # vectorized: headings are a plain cumsum, and each step's world-frame
    # translation depends only on the (already known) integrated heading,
    # so positions are a second cumsum.
    chain = o_meas[: n_poses - 1]
    ig_th = np.concatenate([[xyt[0, 2]], xyt[0, 2] + np.cumsum(chain[:, 2])])
    ci, si = np.cos(ig_th[:-1]), np.sin(ig_th[:-1])
    world_steps = np.stack(
        [ci * chain[:, 0] - si * chain[:, 1], si * chain[:, 0] + ci * chain[:, 1]],
        1,
    )
    ig_xy = xyt[0, :2] + np.concatenate(
        [np.zeros((1, 2)), np.cumsum(world_steps, 0)]
    )
    ig = np.concatenate([ig_xy, ig_th[:, None]], 1)
    ig[:, :2] += rng.normal(0, init_noise[0], (n_poses, 2))
    ig[:, 2] += rng.normal(0, init_noise[1], n_poses)
    ig[0] = xyt[0]  # the gauge pose starts exact

    pose_ids = list(range(n_poses))
    lm_ids = list(range(n_poses, n_poses + n_landmarks))
    nb = len(b_meas)

    def mk(poses, with_lms):
        bound = float(np.abs(np.concatenate([poses[:, :2].ravel(), lms.ravel()])).max()) + 3.0
        return ParsedG2O(
            pose_ids=pose_ids,
            pose_xyt=poses.astype(np.float32),
            lm_ids=lm_ids if with_lms else [],
            lm_xy=lms.astype(np.float32) if with_lms else np.zeros((0, 2), np.float32),
            bearing_pose_id=np.asarray(b_pose, np.int64),
            bearing_lm_id=np.asarray(lm_ids, np.int64)[np.asarray(b_lm, int)]
            if nb
            else np.zeros(0, np.int64),
            bearing_meas=np.asarray(b_meas, np.float32),
            bearing_omega=np.ones(nb, np.float32),
            odom_src_id=o_src.astype(np.int64),
            odom_dst_id=o_dst.astype(np.int64),
            odom_meas=o_meas.astype(np.float32),
            odom_omega=omega,
            fixed_pose_id=0,
            bound=bound,
        )

    return mk(ig, with_lms=False), mk(xyt, with_lms=True)
