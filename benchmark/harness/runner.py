"""One run of a cell: set-up, the measured window, the traced phase, the
check, and the result line.

Set-up makes the pool from ``--seed`` on the host, hands it to the system
and solves each graph once, so that every kernel is built and loaded and
every size warmed before the window.  The window is a closed loop with one
client: solves one after another, cycling through the pool, until
``seconds`` have passed; the last solve is let finish, and the window ends
with it.  With ``trace`` a traced phase follows the window: the traffic's
``trace_solves`` further solves under the profiler (``devtrace``).  Then
the peak of device memory is read, the system's state is freed, and the
answers of every solve are judged (``check``).
"""

from __future__ import annotations

import gc
import json
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.harness import check, devtrace, spec, traffic

# top-level module names that may not be loaded in the process that prints
# the result (compared whole: the system's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "boslam")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def solver_fields(cell: spec.Cell) -> dict:
    return {**cell.config["solver"], **cell.traffic.get("solver", {})}


def make_system(cell: spec.Cell, device, control: bool = False, fault: str | None = None):
    """The system under test, or the control (the system with the fields of
    the cell's ``checks["control"]`` set), or the system with ``fault``."""
    from benchmark.harness import system

    if control:
        if not cell.checks.get("control"):
            raise SystemExit(f"{cell.name}: its checks file names no control")
        return system.Port(device, {**solver_fields(cell), **cell.checks["control"]},
                           cell.traffic["entry"])
    if fault is not None:
        from benchmark.harness import faults

        return faults.Faulty(device, solver_fields(cell), cell.traffic["entry"], fault)
    return system.Port(device, solver_fields(cell), cell.traffic["entry"])


def window(sys_, prepared: list, seconds: float) -> tuple:
    """(answers, window seconds): solves cycling through ``prepared`` until
    ``seconds`` have passed; the window runs from its start to the end of
    its last solve."""
    answers = []
    t_start = time.perf_counter()
    i = 0
    while True:
        k = i % len(prepared)
        answers.append(sys_.solve(k, prepared[k]))
        i += 1
        if answers[-1].t_end - t_start >= seconds:
            return answers, answers[-1].t_end - t_start


def run(root, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_process: float | None = None, control: bool = False, fault: str | None = None) -> dict:
    """The result record of one run (``main`` prints it); ``control`` or
    ``fault`` put the control or a broken system in the system's place."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = spec.load_cell(root, workload)
    cuda = torch.device(device).type == "cuda"
    pool = traffic.make_pool(cell.config, cell.traffic, seed)
    sys_ = make_system(cell, device, control, fault)
    prepared = [sys_.prepare(p) for _, p in pool]
    for k, p in enumerate(prepared):  # warm every graph: kernels built and loaded, sizes met
        sys_.solve(k, p)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    log(f"set-up {setup_s:.3f} s: {len(pool)} graphs (generator seeds {[k for k, _ in pool]})")

    answers, window_s = window(sys_, prepared, seconds)
    log(f"window {window_s:.3f} s: {len(answers)} solves")
    tr, traced = None, []
    if trace:
        n = int(cell.traffic["trace_solves"])

        def phase():
            traced.clear()
            for j in range(n):
                k = (len(answers) + j) % len(prepared)
                traced.append(sys_.solve(k, prepared[k], traced=True))

        tr = devtrace.trace(phase, cuda)
        log(f"traced phase: {len(traced)} solves, {tr.n_ops} device operations, busy "
            f"{tr.busy_s:.6f} s of {tr.window_s:.6f} s, {tr.sessions} session(s), "
            f"{tr.wall_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    n_window = len(answers)
    done = check.host(answers + traced)
    del answers, traced, prepared, sys_
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.judge(done, pool, cell.config, cell.checks, device)
    log(f"check {time.perf_counter() - t_check:.3f} s over {len(done)} answers; reference "
        f"steps that failed: {verdict['reference_failed_steps']}")

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    # what the metrics' readers read (benchmark/metrics/<name>.py)
    record = SimpleNamespace(
        cell=cell, seed=seed, setup_s=setup_s, window_s=window_s,
        solves=done[:n_window], traced=done[n_window:], trace=tr, pool=pool)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(record)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    result = {"correct": verdict["correct"], "attempted": len(done),
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = verdict["numbers"]
    result["_verdict"] = verdict
    return result


def main(argv=None, t_process: float | None = None) -> int:
    import argparse
    from pathlib import Path

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    cell = spec.load_cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"no measurement: the cell needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(root, args.workload, args.seed, args.seconds, bool(args.trace),
                 t_process=t_process)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process loaded {', '.join(bad)}")
        return 3
    verdict = result.pop("_verdict")
    for name, m in result["metrics"].items():
        log(f"metric {name}: {m['value']!r} {m['unit']}")
    check.print_numbers(verdict)  # the last lines on standard error
    print(json.dumps(result), flush=True)
    return 0
