"""The comparison that decides ``correct``.

Once the window has closed, the plain reference (``benchmark/reference``,
float64) solves each graph of the pool from its generated input, and every
answer the window produced is held against the reference's solve of its
graph.  Each answer gives these readings:

- ``landmark_init_gap``: the triangulated start,
  max |l - l_ref| / max(1, |l_ref|);
- ``chi2_step_gap``: the robust chi2 at the linearisation points of the
  first ``steps`` GN steps (the start, then the state after step 1, ...),
  max |c - c_ref| / c_ref: residuals, robust weights, assembly, the linear
  solve and boxplus of every step but the last, whose result is the final
  state;
- ``last_step_shortfall``: the share of the reference's last-step descent
  that the answer's last step falls short of.  The reference's robust
  cost of the returned final state over the chi2 the system reported at
  its last linearisation point (held to the reference's by
  ``chi2_step_gap``), against the reference's own final cost over its
  chi2 there: (r - r_ref) / (1 - r_ref).  A final state from before the
  last step reads 1, a last step as deep as the reference's 0;
- ``final_cost_gap``: the reference's robust cost of the final state the
  system returned against the cost of the reference's own final state,
  |c - c_ref| / c_ref.

A cell compares those its ``benchmark/checks/<cell>.json`` gives limits
for; each compared number of a run is the largest over its answers.  An
answer fails when a compared reading exceeds its limit or is not finite
(a malformed answer reads NaN), or when its final state is not finite.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

READINGS = ("landmark_init_gap", "chi2_step_gap", "last_step_shortfall", "final_cost_gap")


def host(answers: list) -> list:
    """The answers with their device tensors copied to the host."""
    def h(x):
        return None if x is None else x.detach().cpu().numpy().astype(np.float64)

    return [a._replace(landmarks0=h(a.landmarks0), chi2=h(a.chi2), cg_iters=h(a.cg_iters))
            for a in answers]


def reference_solutions(pool: list, config: dict, device) -> list:
    """The float64 reference's solve of each graph of the pool: exact GN
    steps, also where the system truncates its linear solve (what the
    truncation costs is then part of the gap)."""
    from benchmark.reference import slam

    s = config["solver"]
    out = []
    for _, parsed in pool:
        pb = slam.problem(parsed, torch.float64, device)
        sol = slam.solve(pb, int(s["iters"]), float(s["damping"]), float(s["kernel_threshold"]))
        out.append((pb, sol))
    return out


def _rel_max(mine, ref, floor=None) -> float:
    mine, ref = np.asarray(mine, np.float64), np.asarray(ref, np.float64)
    if mine.shape != ref.shape:
        return math.nan
    scale = np.abs(ref) if floor is None else np.maximum(floor, np.abs(ref))
    return float(np.max(np.abs(mine - ref) / scale, initial=0.0))


def readings_of(answer, pb, sol, config: dict, steps: int) -> dict:
    """Every reading of one answer (host arrays) against the reference's
    solve of its graph; NaN where the answer is malformed."""
    from benchmark.reference import slam

    kt = float(config["solver"]["kernel_threshold"])
    iters = int(config["solver"]["iters"])
    out = dict.fromkeys(READINGS, math.nan)
    out["landmark_init_gap"] = _rel_max(answer.landmarks0, sol.landmarks0.cpu().numpy(), 1.0)
    chi2_ok = np.shape(answer.chi2) == (iters,)
    if chi2_ok:
        k = min(steps, iters)
        out["chi2_step_gap"] = _rel_max(answer.chi2[:k], sol.chi2[:k])
    ref_poses, ref_lms = sol.poses.cpu().numpy(), sol.landmarks.cpu().numpy()
    if answer.poses.shape == ref_poses.shape and answer.landmarks.shape == ref_lms.shape:
        dt, dev = pb.poses.dtype, pb.poses.device
        cost = float(slam.robust_cost(pb, torch.as_tensor(answer.poses, dtype=dt, device=dev),
                                      torch.as_tensor(answer.landmarks, dtype=dt, device=dev), kt))
        out["final_cost_gap"] = abs(cost - sol.cost) / sol.cost
        if chi2_ok:
            r_ref = sol.cost / sol.chi2[-1]
            out["last_step_shortfall"] = float((cost / answer.chi2[-1] - r_ref) / (1.0 - r_ref))
    return out


def _worst(values: list) -> float | None:
    """The largest reading, None where one is not finite (or none came)."""
    if not values or not all(math.isfinite(v) for v in values):
        return None
    return max(values)


def judge(answers: list, pool: list, config: dict, checks: dict, device) -> dict:
    """{"correct", "failed", "numbers": {compared name: {"value", "limit"}},
    "readings": {every name: largest over the answers}} of the answers
    (host copies, ``host``) against the float64 reference."""
    limits = {n: float(v["limit"]) for n, v in checks["limits"].items()}
    unknown = set(limits) - set(READINGS)
    if unknown:
        raise SystemExit(f"checks: no reading named {sorted(unknown)}; known: {READINGS}")
    refs = reference_solutions(pool, config, device)
    seen = {n: [] for n in READINGS}
    failed = 0
    for a in answers:
        pb, sol = refs[a.graph]
        r = readings_of(a, pb, sol, config, int(checks["steps"]))
        bad = any(not math.isfinite(r[n]) or r[n] > lim for n, lim in limits.items())
        failed += bad or not (np.isfinite(a.poses).all() and np.isfinite(a.landmarks).all())
        for n, v in r.items():
            seen[n].append(v)
    worst = {n: _worst(v) for n, v in seen.items()}
    return {"correct": bool(answers) and failed == 0, "failed": failed,
            "reference_failed_steps": sum(sol.failed_steps for _, sol in refs),
            "numbers": {n: {"value": worst[n], "limit": lim} for n, lim in limits.items()},
            "readings": worst}


def print_numbers(verdict: dict) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for n, v in verdict["numbers"].items():
        print(f"check {n}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(f"check failed answers: {verdict['failed']} (limit 0); correct: {verdict['correct']}",
          file=sys.stderr, flush=True)
