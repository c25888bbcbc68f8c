"""Readings for the limits of a cell's check, and its control.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> ... [--control <n> ...]
        [--fault <n> ...] [--triangulation <n> ...]

For each ``--seeds`` seed, one run of the cell as ``run.py`` makes it (set-up,
a window of ``--seconds``, the check); for each ``--control`` seed the same
with the control in the system's place: the system with its own
lower-precision path switched on (the ``control`` fields of the cell's
checks file); for each ``--fault`` seed once with each planted fault
(``harness/faults.py``); and for each ``--triangulation`` seed the
triangulated start's reading of the reference's own triangulation in
float32 with TF32 products, the control of that stage (the cell's control
leaves the start as the system makes it).  The control and
the faults have to come out as not correct.  One JSON line per run: every
reading (``harness/check.py``), ``correct`` and the answers judged.  The
lower reading of a number is the largest over sound runs of the system,
the upper the smallest over the control's and the faults'
(``benchmark/checks/<cell>.json``).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def triangulation_f32(workload: str, seed: int, device) -> float:
    """``landmark_init_gap`` of the reference's triangulation of the
    pool's graphs in float32 with TF32 products, against float64's."""
    import torch

    from benchmark.harness import check, spec, traffic
    from benchmark.reference import slam

    cell = spec.load_cell(ROOT, workload)
    torch.backends.cuda.matmul.allow_tf32 = True
    gaps = []
    for _, parsed in traffic.make_pool(cell.config, cell.traffic, seed):
        ref = slam.triangulate(slam.problem(parsed, torch.float64, device))
        low = slam.triangulate(slam.problem(parsed, torch.float32, device))
        gaps.append(check._rel_max(low.double().cpu().numpy(), ref.cpu().numpy(), 1.0))
    torch.backends.cuda.matmul.allow_tf32 = False
    return max(gaps)


def main(argv=None) -> int:
    import torch

    from benchmark.harness import runner

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=int, nargs="*", default=[])
    ap.add_argument("--triangulation", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness.faults import FAULTS

    runs = ([(s, "port") for s in args.seeds] + [(s, "control") for s in args.control]
            + [(s, f) for s in args.fault for f in FAULTS])
    for seed, what in runs:
        t0 = time.perf_counter()
        r = runner.run(ROOT, args.workload, seed, args.seconds, False, device=args.device,
                       control=what == "control", fault=what if what in FAULTS else None)
        v = r["_verdict"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "system": what,
            "correct": v["correct"], "answers": r["attempted"], "failed": v["failed"],
            "readings": v["readings"],
            "reference_failed_steps": v["reference_failed_steps"],
            "metrics": {n: m["value"] for n, m in r["metrics"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)
    for seed in args.triangulation:
        print(json.dumps({"workload": args.workload, "seed": seed, "system": "triangulation_f32",
                          "readings": {"landmark_init_gap": triangulation_f32(
                              args.workload, seed, args.device)}}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "benchmark_cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "benchmark_cache" / "triton")
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
