"""Device time per kernel on each solver path of the PyTorch port, set
beside the roofline models (port of ``tools/trace_validate.py``, its trace
half).

The JAX tool reads two ground truths from the compiled program: XLA's cost
analysis (the compiler's FLOP and byte counts) and a ``jax.profiler``
device trace.  The port has no compiler: PyTorch runs eagerly, one
operator after another, so no compiled program exists whose cost could be
counted, and ``xla_cost_analysis`` and ``model_vs_xla`` are null in every
record.  The trace half ports: one ``torch.profiler`` run of the chain
(``utils/profiling.device_time_by_kernel``) gives the device time by
kernel, its sum (busy), the span from the first kernel's start to the last
one's end, and the number of device operations, counting only those the
chain launched; beside them the chain's window on the clock its
operations are read on (``trace.window_ms``: on the card from a mark
launched before the chain to one launched after it), the same window on
the host's side of the profiler's timeline (``trace.host_window_ms``: the
chain and its wait for the card, a ``record_function`` range), the
session's device operations the chain did not launch
(``trace.n_ops_outside``) and where all of them lie (``trace.timeline_ms``).
``profiled_wall_ms`` is the host's ``perf_counter`` around the same call.

Paths:
  dense   GN, linear_solver="dense": the Cholesky kernel, one launch per step
  schur   GN, linear_solver="schur", fused_step="auto": on the card the
          whole-step kernel, 8 launches per step; S's band is computed once
          per chain (``schur.kernel_band``, as ``solve`` does), so the step
          takes the band route where the band fits
  packed  ``packed_gn_step`` on ``generate_sequence(n, max(8, 2n/5), seed=0)``
          at --poses: btridiag PCG (50, 1e-4), warm start, plain gathers
          (the default walk, whose grids the windowed planner refuses)

The graph of dense and schur is ``--g2o``, else the reference dataset where
it exists, else ``generate_sequence(301, 141, seed=3)``
(``boslam_torch.bench.load_graph``).  Per path: a warm run of one step,
then the best of 3 chained runs of --iters steps (packed: max(5, iters //
3)), each ending in a wait for the card, then one profiled run of the chain.

Each record carries the JAX tool's keys (``model`` from
``utils/roofline.py``'s models with the JAX tool's arguments; packed reads
the CG count of the warm step), the chain's final chi2, the port's kernel
launches in the trace and, where the path runs a kernel of the port,
``kernel_work``: its work (``cholesky_work``, ``gn_step_work``), its bound
on this card (``bound_ms``), its device time per step in the trace, and the
shares of that time which the kernel's bound and the JAX model's least time
make.  On the CPU (``--device cpu``, a rehearsal) the "device" is the CPU's
operators, no card's peaks apply, and the bounds are null.

    python tools/port_trace_validate.py [--device cuda|cpu] [--paths dense schur packed]
        [--poses 10000] [--iters 30] [--g2o PATH] [--json-out FILE]

Prints one JSON record per path; exits 1 if a path failed.  A trace that
stays empty after ``profiling.SESSIONS`` sessions fails its path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PATHS = ("dense", "schur", "packed")
REPEATS = 3
TOP = 12
# the port's kernels each path launches on the card (profiler names)
PATH_KERNELS = {"dense": ("cholesky_solve_padded", ("chol_solve_kernel",)),
                "schur": ("fused_gn_step", None)}  # None: every kernel of the port


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def path_config(name):
    from boslam_torch.config import SolverConfig

    if name == "dense":
        return SolverConfig(linear_solver="dense")
    if name == "schur":
        return SolverConfig(linear_solver="schur")  # fused_step="auto"
    return SolverConfig(linear_solver="schur_cg", cg_iters=50, cg_tol=1e-4,
                        preconditioner="btridiag", cg_warm_start=True)


def walk_graph(n_poses, device):
    """The packed path's graph: the default walk at ``n_poses``."""
    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(n_poses, max(8, n_poses * 2 // 5), seed=0)
    return build_graph(ig, init="triangulate", device=device)[0]


class Chain:
    """``run(n)``: ``n`` chained steps of path ``name`` from ``graph``, the
    final graph returned.  The schur path's band (``band_tiles``) and the
    packed path's packing are made once, here; the packed path keeps its
    last step's stats in ``last_stats``."""

    def __init__(self, name, graph):
        import torch

        from boslam_torch.device import host_sync

        self.name, self.graph, self.cfg = name, graph, path_config(name)
        self.band_tiles, self.pk, self.last_stats = None, None, None
        with host_sync(graph.device):
            if name == "schur":
                from boslam_torch.solver.schur import kernel_band

                self.band_tiles = kernel_band(graph, self.cfg)
            elif name == "packed":
                from boslam_torch.graph.packed import pack_edges

                self.pk, _ = pack_edges(graph, split_lm=self.cfg.lm_split)
        self.dp0 = torch.zeros((graph.n_poses, 3), dtype=graph.poses.dtype, device=graph.device)

    def run(self, n):
        from boslam_torch.solver.optimizer import gn_step
        from boslam_torch.solver.schur_packed import packed_gn_step

        g, dp = self.graph, self.dp0
        for _ in range(n):
            if self.pk is None:
                g, _st = gn_step(g, self.cfg, self.band_tiles)
            else:
                g, self.last_stats, dp = packed_gn_step(g, self.pk, self.cfg, dp_prev=dp)
        return g

    def route(self):
        """The step's route: "band" or "dense" for the whole-step kernel on
        the card (schur), "kernel" for the Cholesky kernel (dense), "plain"
        where no kernel of the port runs (the CPU, packed)."""
        from boslam_torch.solver.optimizer import _fused_step_applicable

        if not self.graph.poses.is_cuda or self.name == "packed":
            return "plain"
        if self.name == "schur" and _fused_step_applicable(self.graph, self.cfg):
            return "dense" if self.band_tiles is None else "band"
        return "kernel"


def model(name, graph, chain, cg):
    """The JAX tool's model of one step of ``name``: {"flops", "hbm_bytes",
    "fn", "args"}."""
    from boslam_torch.utils import roofline

    dims = [graph.n_poses, graph.n_landmarks, graph.n_bearing, graph.n_odometry]
    if name == "packed":
        pk = chain.pk
        fn, args, kw = "packed_outer_model", [graph.n_poses, graph.n_landmarks, pk.K, pk.K2,
                                              graph.n_odometry, cg], {"lm_rows": pk.l_pose.shape[0]}
    else:
        fn, args, kw = f"{name}_step_model", dims, {}
    flops, nbytes = getattr(roofline, fn)(*args, **kw)
    return {"flops": flops, "hbm_bytes": nbytes, "fn": fn, "args": args, "kwargs": kw}


def kernel_work(name, graph, tr, iters, spec, model_rec):
    """The path's kernel of the port: its work and bound (None without a
    card's peaks) beside its device time per step in the trace ``tr``."""
    from boslam_torch.device import host_sync
    from boslam_torch.ops.cholesky import pad_dim
    from boslam_torch.utils import roofline
    from boslam_torch.utils.profiling import PORT_KERNELS, port_launches

    kernel, names = PATH_KERNELS[name]
    if name == "dense":
        shape = [pad_dim(graph.state_dim)]
        fmas, nbytes = roofline.cholesky_work(shape[0])
    else:
        shape = [graph.n_poses, graph.n_landmarks]
        with host_sync(graph.device):
            fmas, nbytes = roofline.gn_step_work(graph)
    launches, ms = port_launches(tr, names or PORT_KERNELS)
    rec = {"kernel": kernel, "shape": shape, "fmas": fmas, "bytes": nbytes, "bound_ms": None,
           "bound_by": None, "launches": launches, "launches_per_step": launches / iters,
           "device_ms_per_step": ms / iters if launches else None, "model_ms": None,
           "bound_share_of_kernel": None, "model_share_of_device_busy": None}
    if spec is not None:
        rec["bound_ms"], rec["bound_by"] = roofline.bound_ms(fmas, nbytes, spec)
        # the JAX model's least time: its FLOPs (FMAs = FLOPs / 2) and bytes
        rec["model_ms"], _ = roofline.bound_ms(model_rec["flops"] / 2, model_rec["hbm_bytes"],
                                               spec)
        rec["model_share_of_device_busy"] = rec["model_ms"] / (tr.busy_ms / iters)
        if launches:
            rec["bound_share_of_kernel"] = rec["bound_ms"] / (ms / iters)
    return rec


def trace_record(tr, iters, best_s):
    """The JAX tool's ``trace`` and ``trace_vs_wall`` of one profiled run."""
    from boslam_torch.utils.profiling import port_launches

    top = sorted(tr.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    launches, ms = port_launches(tr)
    trace = {
        "device_planes": tr.planes,
        "n_host_planes": tr.n_host_threads,
        "device_time_ms": tr.busy_ms,
        "device_span_ms": tr.span_ms,
        "top_kernels_ms": [[n[:80], v[0]] for n, v in top],
        "device_ops": tr.n_ops,
        "device_ops_per_iter": tr.n_ops / iters,
        "port_kernel_launches": launches,
        "port_kernel_ms": ms,
        "profiled_wall_ms": tr.wall_ms,
        "window_ms": tr.window_ms,
        "host_window_ms": tr.host_window_ms,
        "n_ops_outside": tr.n_ops_outside,
        "timeline_ms": tr.timeline,
    }
    vs_wall = {
        "wall_ms": 1e3 * best_s,
        "device_busy_ms": tr.busy_ms,
        "device_busy_frac_of_span": tr.busy_ms / tr.span_ms,
        "profiled_wall_ms": tr.wall_ms,
        "device_busy_frac_of_profiled_wall": tr.busy_ms / tr.wall_ms,
    }
    return trace, vs_wall


def trace_path(name, graph, iters, spec=None):
    """One path's record on ``graph``'s device (``spec``: the card's peaks,
    None on the CPU)."""
    from boslam_torch.bench import final_chi2
    from boslam_torch.device import host_sync
    from boslam_torch.utils.profiling import device_time_by_kernel, sync

    dev = graph.device
    chain = Chain(name, graph)
    chain.run(1)  # warm
    cg = None
    if name == "packed":
        with host_sync(dev):
            cg = int(chain.last_stats["cg_iters"])
    best = float("inf")
    for _ in range(REPEATS):
        sync(dev)
        t0 = time.perf_counter()
        chain.run(iters)
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    out = {}
    tr = device_time_by_kernel(lambda: out.update(g=chain.run(iters)), dev)
    with host_sync(dev):
        chi2 = final_chi2(out["g"], chain.cfg)
    m = model(name, graph, chain, cg)
    trace, vs_wall = trace_record(tr, iters, best)
    rec = {
        "path": name,
        "iters": iters,
        "ms_per_iter": 1e3 * best / iters,
        "model": m,
        "xla_cost_analysis": None,  # no compiler in the port (module docstring)
        "model_vs_xla": None,
        "trace": trace,
        "trace_vs_wall": vs_wall,
        "route": chain.route(),
        "band_tiles": chain.band_tiles,
        "chi2_final": chi2,
        "dims": {"n_poses": graph.n_poses, "n_landmarks": graph.n_landmarks,
                 "n_bearing": graph.n_bearing, "n_odometry": graph.n_odometry},
    }
    if cg is not None:
        rec["cg_iters_warm_step"] = cg
    if name in PATH_KERNELS:
        rec["kernel_work"] = kernel_work(name, graph, tr, iters, spec, m)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=list(PATHS))
    ap.add_argument("--poses", type=int, default=10_000)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--g2o", default=None)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import torch

    import boslam_torch  # noqa: F401  (full-f32 matmul precision)
    from boslam_torch.bench import load_graph
    from boslam_torch.device import resolve_device
    from boslam_torch.graph.build import build_graph
    from boslam_torch.utils.roofline import chip_spec

    dev = resolve_device(args.device)
    spec = chip_spec() if dev.type == "cuda" else None
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {dev} ({card})")
    records, failed = [], []
    ref = None
    for name in args.paths:
        try:
            if name == "packed":
                graph = walk_graph(args.poses, dev)
                source = f"generate_sequence({args.poses}, {max(8, args.poses * 2 // 5)}, seed=0)"
                iters = max(5, args.iters // 3)
            else:
                if ref is None:
                    parsed, src = load_graph(args.g2o)
                    ref = build_graph(parsed, init="triangulate", device=dev)[0], src
                (graph, source), iters = ref, args.iters
            rec = {**trace_path(name, graph, iters, spec), "graph": source, "device": card}
        except Exception:  # noqa: BLE001 -- recorded, and the other paths run
            log(f"{name}: FAILED\n{traceback.format_exc()}")
            failed.append(name)
            continue
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"chip": None if spec is None else spec.name, "device": card,
                       "records": records}, f, indent=1)
        log(f"wrote {args.json_out}")
    if failed:
        log(f"failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
