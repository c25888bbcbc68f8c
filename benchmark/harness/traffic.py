"""The traffic: seeded bearing-only SLAM inputs, and the pool a cell's
window cycles through.

``generate_sequence`` is a frozen copy of the project's synthetic
generator (``boslam_torch/synth.py``) with one neighbour search, the
brute-force k nearest, so that the graphs do not depend on whether scipy
is installed.  It returns ``Parsed``, a plain record with the fields of the
project's parse result; ``benchmark/tests`` holds it equal to the
project's generator.  The squared distances are summed per coordinate
over one block of queries at a time, which gives the values of the
project's ``((q - p) ** 2).sum(-1)`` bit for bit in a fraction of its
memory.

A traffic file (``benchmark/traffic/<name>.json``) says how many graphs the
pool holds and either ``graph_seeds``, the same graphs for every run in an
order the seed rotates, or nothing more: then the graphs' generator seeds
are drawn from the run's seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Parsed(NamedTuple):
    """One input, with the fields of the project's g2o parse result."""

    pose_ids: list
    pose_xyt: np.ndarray
    lm_ids: list
    lm_xy: np.ndarray
    bearing_pose_id: np.ndarray
    bearing_lm_id: np.ndarray
    bearing_meas: np.ndarray
    bearing_omega: np.ndarray
    odom_src_id: np.ndarray
    odom_dst_id: np.ndarray
    odom_meas: np.ndarray
    odom_omega: np.ndarray
    fixed_pose_id: int
    bound: float


def _knn_bruteforce(queries, points, k, max_range, budget=1 << 22):
    """k nearest ``points`` per query row: (distances, indices), entries
    beyond ``max_range`` at inf distance and index ``len(points)``."""
    nq, npt = queries.shape[0], points.shape[0]
    k_eff = min(k, npt)
    dists = np.full((nq, k), np.inf)
    near = np.full((nq, k), npt, dtype=np.int64)
    chunk = max(1, budget // max(npt, 1))
    for s in range(0, nq, chunk):
        q = queries[s: s + chunk]
        d2 = (q[:, None, 0] - points[None, :, 0]) ** 2
        d2 += (q[:, None, 1] - points[None, :, 1]) ** 2
        idx = np.argpartition(d2, k_eff - 1, axis=1)[:, :k_eff]
        dd = np.take_along_axis(d2, idx, axis=1)
        order = np.argsort(dd, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        dd = np.sqrt(np.take_along_axis(dd, order, axis=1))
        bad = dd > max_range
        dd[bad] = np.inf
        idx[bad] = npt
        dists[s: s + chunk, :k_eff] = dd
        near[s: s + chunk, :k_eff] = idx
    return dists, near


def generate_sequence(n_poses, n_landmarks=None, *, seed=0, step_len=1.0, turn_every=50,
                      obs_per_pose=7, max_range=12.0, odom_noise=(0.02, 0.005),
                      bearing_noise=0.01, init_noise=(0.05, 0.01), loop_closures=0,
                      loop_closure_min_sep=40):
    """(initial guess, ground truth) of a noisy Manhattan-style walk with
    landmarks around it: odometry information diag(500, 500, 5000),
    bearing information 1, the ``obs_per_pose`` nearest landmarks within
    ``max_range`` observed from each pose, pose 0 fixed and exact, and
    ``loop_closures`` extra odometry edges between near, distant poses."""
    rng = np.random.default_rng(seed)
    if n_landmarks is None:
        n_landmarks = max(8, n_poses // 2)

    inc = rng.normal(0, 0.01, n_poses)
    turn_ix = np.nonzero((np.arange(n_poses) + 1) % turn_every == 0)[0]
    inc[turn_ix] += rng.choice([-np.pi / 2, np.pi / 2], turn_ix.size)
    h_step = np.cumsum(inc)
    h_rec = h_step - inc
    steps = step_len * np.stack([np.cos(h_step), np.sin(h_step)], 1)
    pos_rec = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, 0)[:-1]])
    xyt = np.concatenate([pos_rec, h_rec[:, None]], 1)

    t_ix = rng.integers(0, n_poses, n_landmarks)
    offs = rng.uniform(-max_range * 0.6, max_range * 0.6, (n_landmarks, 2))
    lms = xyt[t_ix, :2] + offs

    dists, near = _knn_bruteforce(xyt[:, :2], lms, obs_per_pose, max_range)
    valid = np.isfinite(dists)
    b_pose = np.nonzero(valid)[0]
    b_lm = near[valid]
    dxy = lms[b_lm] - xyt[b_pose, :2]
    alpha = np.arctan2(dxy[:, 1], dxy[:, 0]) - xyt[b_pose, 2]
    alpha = (alpha + np.pi) % (2 * np.pi) - np.pi
    b_meas = alpha + rng.normal(0, bearing_noise, alpha.size)

    observed = np.zeros(n_landmarks, bool)
    observed[b_lm] = True
    remap = -np.ones(n_landmarks, int)
    remap[observed] = np.arange(observed.sum())
    lms = lms[observed]
    b_lm = remap[b_lm]
    n_landmarks = int(observed.sum())

    o_src = np.arange(n_poses - 1)
    o_dst = o_src + 1
    c, sn = np.cos(xyt[:-1, 2]), np.sin(xyt[:-1, 2])
    dt = xyt[1:, :2] - xyt[:-1, :2]
    dth = (xyt[1:, 2] - xyt[:-1, 2] + np.pi) % (2 * np.pi) - np.pi
    o_meas = np.stack([
        c * dt[:, 0] + sn * dt[:, 1] + rng.normal(0, odom_noise[0], n_poses - 1),
        -sn * dt[:, 0] + c * dt[:, 1] + rng.normal(0, odom_noise[0], n_poses - 1),
        dth + rng.normal(0, odom_noise[1], n_poses - 1),
    ], 1)
    if loop_closures > 0 and n_poses > loop_closure_min_sep:
        lc_src, lc_dst, lc_meas = [], [], []
        seen_pairs = set()
        tries = 0
        while len(lc_src) < loop_closures and tries < 50 * loop_closures:
            tries += 1
            i = int(rng.integers(0, n_poses - loop_closure_min_sep))
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

    omega = np.broadcast_to(np.diag([500.0, 500.0, 5000.0]).astype(np.float32),
                            (len(o_src), 3, 3)).copy()

    chain = o_meas[: n_poses - 1]
    ig_th = np.concatenate([[xyt[0, 2]], xyt[0, 2] + np.cumsum(chain[:, 2])])
    ci, si = np.cos(ig_th[:-1]), np.sin(ig_th[:-1])
    world_steps = np.stack([ci * chain[:, 0] - si * chain[:, 1],
                            si * chain[:, 0] + ci * chain[:, 1]], 1)
    ig_xy = xyt[0, :2] + np.concatenate([np.zeros((1, 2)), np.cumsum(world_steps, 0)])
    ig = np.concatenate([ig_xy, ig_th[:, None]], 1)
    ig[:, :2] += rng.normal(0, init_noise[0], (n_poses, 2))
    ig[:, 2] += rng.normal(0, init_noise[1], n_poses)
    ig[0] = xyt[0]

    pose_ids = list(range(n_poses))
    lm_ids = list(range(n_poses, n_poses + n_landmarks))
    nb = len(b_meas)

    def mk(poses, with_lms):
        bound = float(np.abs(np.concatenate([poses[:, :2].ravel(), lms.ravel()])).max()) + 3.0
        return Parsed(
            pose_ids=pose_ids,
            pose_xyt=poses.astype(np.float32),
            lm_ids=lm_ids if with_lms else [],
            lm_xy=lms.astype(np.float32) if with_lms else np.zeros((0, 2), np.float32),
            bearing_pose_id=np.asarray(b_pose, np.int64),
            bearing_lm_id=np.asarray(lm_ids, np.int64)[np.asarray(b_lm, int)]
            if nb else np.zeros(0, np.int64),
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


def graph_seed(seed: int, k: int) -> int:
    """The generator seed of the ``k``-th candidate graph of run ``seed``."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), k]).generate_state(1)[0])


def make_pool(config: dict, traffic: dict, seed: int) -> list:
    """[(graph seed, Parsed initial guess)] of the pool.

    With ``traffic["graph_seeds"]`` the pool is those graphs for every run,
    in an order rotated by ``seed``: where graphs of one size still differ
    in the work they ask (CG converging in fewer iterations on some), every
    seed gets the same work in another order.  Otherwise the graphs
    ``generate_sequence(**config["graph"], seed=graph_seed(seed, k))`` for
    k = 0, ..., ``traffic["pool"]`` - 1."""
    fixed = traffic.get("graph_seeds")
    if fixed:
        if len(fixed) != traffic["pool"]:
            raise ValueError(f"graph_seeds {fixed} is not a pool of {traffic['pool']}")
        k = int(seed) % len(fixed)
        return [(s, generate_sequence(**config["graph"], seed=s)[0]) for s in fixed[k:] + fixed[:k]]
    return [(gs, generate_sequence(**config["graph"], seed=gs)[0])
            for gs in (graph_seed(seed, k) for k in range(traffic["pool"]))]
