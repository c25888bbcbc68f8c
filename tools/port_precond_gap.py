"""How far the packed solver's GN steps land from exact GN steps, by
preconditioner: a benchmark configuration's graphs (``--config``, the 10k
corridor by default) solved by ``solve_packed`` under each variant, held
against the benchmark's float64 reference (``benchmark/reference/slam.py``)
with the check's own readings (``benchmark/harness/check.py``).

    python tools/port_precond_gap.py [--config benchmark/configs/corridor_10k.json]
        [--seeds 0 1] [--variants block_jacobi btridiag two_level block_jacobi+bf16]
        [--repeats 1] [--device cuda|cpu] [--json-out FILE]

A variant is a preconditioner, with "+bf16" for bf16 coupling blocks; every
other solver field is the configuration's.  Each graph is built and solved
as the benchmark's system does it (``build_graph`` with triangulation, then
``solve_packed``), ``--repeats`` times, and the reference solves it once.
One JSON line per graph seed and variant: the four readings (the largest
over the repeats, and under "readings_min" the smallest), the last
repeat's CG iterations and breakdown events per outer, and both chi2
traces.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def variant_fields(variant: str) -> dict:
    name, _, extra = variant.partition("+")
    fields = {"preconditioner": name}
    if extra == "bf16":
        fields["coupling_dtype"] = "bfloat16"
    elif extra:
        raise SystemExit(f"unknown variant {variant!r}: <preconditioner>[+bf16]")
    return fields


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(REPO, "benchmark", "configs",
                                                     "corridor_10k.json"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--variants", nargs="+",
                    default=["block_jacobi", "btridiag", "two_level", "block_jacobi+bf16"])
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import logging
    from types import SimpleNamespace

    import numpy as np
    import torch

    from benchmark.harness import check, traffic
    from benchmark.reference import slam
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.io.g2o import ParsedG2O
    from boslam_torch.solver.optimizer import solve_packed

    # the build warns once per landmark with a single observation
    logging.getLogger("boslam_torch").setLevel(logging.ERROR)
    with open(args.config) as f:
        config = json.load(f)
    solver = config["solver"]
    steps = int(solver["iters"])
    host = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
    lines = []
    for seed in args.seeds:
        parsed = traffic.generate_sequence(**config["graph"], seed=seed)[0]
        t0 = time.perf_counter()
        pb = slam.problem(parsed, torch.float64, args.device)
        sol = slam.solve(pb, steps, float(solver["damping"]), float(solver["kernel_threshold"]))
        ref_s = time.perf_counter() - t0
        ig = ParsedG2O(**parsed._asdict())
        for variant in args.variants:
            cfg = SolverConfig(**{**solver, **variant_fields(variant)})
            readings = []
            for _ in range(args.repeats):
                g, _ = build_graph(ig, init="triangulate", device=args.device)
                out, stats = solve_packed(g, cfg)
                answer = SimpleNamespace(landmarks0=host(g.landmarks),
                                         chi2=host(stats["chi2_robust"]),
                                         poses=out.poses.cpu().numpy(),
                                         landmarks=out.landmarks.cpu().numpy())
                readings.append(check.readings_of(answer, pb, sol, config, steps))
            line = {"config": config["name"], "seed": seed, "variant": variant,
                    "repeats": args.repeats,
                    "readings": {n: max(r[n] for r in readings) for n in check.READINGS},
                    "readings_min": {n: min(r[n] for r in readings) for n in check.READINGS},
                    "cg_iters": stats["cg_iters"].tolist(),
                    "breakdown_events": stats["cg_breakdown_events"].tolist(),
                    "chi2": answer.chi2.tolist(), "chi2_reference": sol.chi2,
                    "reference_failed_steps": sol.failed_steps, "reference_s": ref_s,
                    "device": (torch.cuda.get_device_name(0)
                               if torch.device(args.device).type == "cuda" else "cpu")}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
