"""How far the coarse correction's cost trace moves under a change of
summation order in the f32 landmark triangulation, on the CPU.

    PYTHONPATH=. python tools/port_coarse_scan.py [--poses 10000] [--landmarks 3900]
        [--seed 3] [--loop-closures 100] [--orders 8]

Builds generate_sequence(poses, landmarks, seed, loop_closures), applies
pgo_initialize(landmark_rounds=2) and then coarse_correct(seg=64,
rounds=3) once as it stands and once per reordering of the bearing edges
fed to the triangulation (a random permutation: the same sums in another
order, as the card's atomics give).  Every coarse step is host f64 on the
same poses, so what moves the trace is the f32 triangulation alone.
Prints each run's step choices and relative cost gaps per round, and the
largest gap over the rounds whose step choices agree.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--poses", type=int, default=10000)
    ap.add_argument("--landmarks", type=int, default=3900)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--loop-closures", type=int, default=100)
    ap.add_argument("--orders", type=int, default=8)
    args = ap.parse_args()
    logging.disable(logging.WARNING)

    import boslam_torch.init.triangulation as tri
    from boslam_torch.graph.build import build_graph
    from boslam_torch.init.pose_graph import pgo_initialize
    from boslam_torch.solver.coarse import coarse_correct
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(args.poses, args.landmarks, seed=args.seed,
                              loop_closures=args.loop_closures)
    g, _ = build_graph(ig, init="triangulate", device="cpu")
    t0 = time.perf_counter()
    gp = pgo_initialize(g, landmark_rounds=2)
    t1 = time.perf_counter()
    _, ref = coarse_correct(gp, seg=64, rounds=3)
    t2 = time.perf_counter()
    print(f"pgo_initialize {t1 - t0:.2f} s, coarse_correct {t2 - t1:.2f} s (host, this CPU); "
          f"alphas {ref['alphas']}, cost trace {ref['cost_trace']}")

    plain = tri.triangulate_landmarks
    rng = np.random.default_rng(0)

    def reordered(poses, b_pose, b_lm, b_meas, *, n_landmarks):
        p = torch.from_numpy(rng.permutation(b_pose.shape[0]))
        return plain(poses, b_pose[p], b_lm[p], b_meas[p], n_landmarks=n_landmarks)

    tri.triangulate_landmarks = reordered
    worst = 0.0
    tr_ref = np.asarray(ref["cost_trace"])
    for k in range(args.orders):
        _, info = coarse_correct(gp, seg=64, rounds=3)
        same = 0
        for a, b in zip(info["alphas"], ref["alphas"]):
            if a != b:
                break
            same += 1
        tr = np.asarray(info["cost_trace"])
        rel = np.abs(tr[:same + 1] - tr_ref[:same + 1]) / tr_ref[:same + 1]
        worst = max(worst, float(rel.max()))
        print(f"order {k}: alphas {info['alphas']}, rel gap over the {same} agreeing rounds "
              f"{rel.tolist()}", flush=True)
    tri.triangulate_landmarks = plain
    print(f"largest gap over agreeing rounds: {worst:.3e}")


if __name__ == "__main__":
    main()
