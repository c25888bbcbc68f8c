"""Where does the packed outer iteration go?  The build, one S matvec and
the preconditioner, each timed alone (port of
``tools/packed_split_probe.py``).

On ``generate_sequence(n, max(8, 2n/5), seed=0)`` packed by
``pack_edges``, for block-Jacobi and two_level
(``SolverConfig(linear_solver="schur_cg", preconditioner=which,
cg_iters=8)``), four phases:

  build          ``build_packed_blocks`` at ``cfg.damping``
  matvec         ``packed_s_matvec`` under the gauge mask
  factor+apply   ``_packed_preconditioner`` and one apply
  apply          one apply of the factored preconditioner

The first line of each preconditioner is the JAX tool's.  Its times are
eager: CUDA events around a run of calls (``utils/profiling.time_ms``),
which is what the port's CG loop pays, the host's launches included.  The
JAX tool times a ``jit``-scanned chain, one compiled program with no host
dispatch per step; the port's counterpart of that is a CUDA-graph replay of
the calls (``time_ms(graph=True)``), the device-paced time, on the second
line beside each phase's device operations (one profiled call,
``utils/profiling.device_time_by_kernel``).  A phase that cannot be
captured (a wait for the host inside) reads ``not capturable: <reason>``.
On the CPU (``--device cpu``, a rehearsal) the times are the host clock's
and the replay column reads ``n/a (cpu)``.

    python tools/port_packed_split_probe.py [n_poses] [--device cuda|cpu] [--json-out FILE]

``--json-out`` writes the numbers of both preconditioners as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PRECONDITIONERS = ("block_jacobi", "two_level")
PHASES = ("build", "matvec", "factor+apply", "apply")
# calls per timed run: the JAX tool's chain lengths
REPS = {"build": 10, "matvec": 20, "factor+apply": 5, "apply": 20}
ROUNDS = 4  # the JAX tool's best of 4; here the median of 4


def walk(n_poses, device):
    """(graph, packed edges) of the default walk at ``n_poses``."""
    from boslam_torch.device import host_sync
    from boslam_torch.graph.build import build_graph
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(n_poses, max(8, n_poses * 2 // 5), seed=0)
    graph, _ = build_graph(ig, init="triangulate", device=device)
    with host_sync(graph.device):
        pk, _ = pack_edges(graph)
    return graph, pk


def phases(graph, pk, which) -> dict:
    """{phase: () -> tensor} for preconditioner ``which``."""
    import torch

    from boslam_torch.config import SolverConfig
    from boslam_torch.solver.schur import _pose_mask
    from boslam_torch.solver.schur_packed import (_packed_preconditioner, build_packed_blocks,
                                                  packed_s_matvec)

    cfg = SolverConfig(linear_solver="schur_cg", preconditioner=which, cg_iters=8)
    mask = _pose_mask(graph.n_poses, graph.fixed_pose_ix, torch.float32)
    blocks, _ = build_packed_blocks(graph, pk, cfg, cfg.damping)
    x0 = torch.ones((graph.n_poses, 3), dtype=torch.float32, device=graph.device)

    def apply(M, x):
        return M(x) if callable(M) else torch.einsum("pij,pj->pi", M, x)

    M = _packed_preconditioner(blocks, pk, cfg, mask)
    return {
        "build": lambda: build_packed_blocks(graph, pk, cfg, cfg.damping)[0].bp,
        "matvec": lambda: packed_s_matvec(blocks, pk, x0, mask),
        "factor+apply": lambda: apply(_packed_preconditioner(blocks, pk, cfg, mask), x0),
        "apply": lambda: apply(M, x0),
    }


def probe(graph, pk, which) -> dict:
    """{"eager_ms", "replay_ms", "device_ops"} by phase; ``replay_ms`` holds
    None on the CPU and the reason where a phase cannot be captured."""
    from boslam_torch.utils.profiling import device_time_by_kernel, time_ms

    dev = graph.device
    fns = phases(graph, pk, which)
    ops = {k: device_time_by_kernel(fn, dev).n_ops for k, fn in fns.items()}
    eager = time_ms(fns, REPS, ROUNDS, device=dev)
    replay = dict.fromkeys(PHASES)
    if dev.type == "cuda":
        for k, fn in fns.items():
            try:
                replay[k] = time_ms({k: fn}, REPS[k], ROUNDS, graph=True, device=dev)[k]
            except RuntimeError as exc:
                replay[k] = f"not capturable: {type(exc).__name__}: {str(exc)[:160]}"
    return {"eager_ms": eager, "replay_ms": replay, "device_ops": ops}


def lines(which, n, r) -> tuple[str, str]:
    """The JAX tool's line, and the line of device operations and
    graph-replay times."""
    t = r["eager_ms"]
    first = (f"{which:13s} n={n}: build {t['build']:7.2f} ms | matvec {t['matvec']:6.2f} ms | "
             f"factor+apply {t['factor+apply']:7.2f} ms | apply {t['apply']:6.2f} ms")

    def replay(k):
        v = r["replay_ms"][k]
        return "n/a (cpu)" if v is None else v if isinstance(v, str) else f"{v:.4f} ms"

    second = (f"{which:13s} n={n}: device ops " + " | ".join(
        f"{k} {r['device_ops'][k]}" for k in PHASES) + "; graph replay " + " | ".join(
        f"{k} {replay(k)}" for k in PHASES))
    return first, second


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_poses", nargs="?", type=int, default=100_000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import torch

    import boslam_torch  # noqa: F401  (full-f32 matmul precision)
    from boslam_torch.device import resolve_device

    dev = resolve_device(args.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({card})", file=sys.stderr)
    graph, pk = walk(args.n_poses, dev)
    results = {}
    for which in PRECONDITIONERS:
        results[which] = probe(graph, pk, which)
        for line in lines(which, args.n_poses, results[which]):
            print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"n_poses": args.n_poses, "device": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
