#!/usr/bin/env python3
"""Smoke run of the PyTorch port (boslam_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout
(boslam_torch/ops/csrc, into build/boslam_torch_kernels/), holds each
kernel against its plain PyTorch version and an f64 solve on the card (the
Cholesky at every size a path gives it, 1024 to 1664, and at 2048, and on
a system whose last pivot is negative), times each beside its library call (medians of interleaved
rounds; the gather as CUDA-graph replays) and counts its launches per
call, then drives the port's paths at the reference dataset's size:
GN under the exact Schur solve with the whole-step kernel off (gn-schur)
for 50 iterations, GN under the dense solve for 50, LM under the Schur
solve for 50, and the main path, GN under the exact Schur solve with the
default fused_step="auto", which takes the whole-step kernel (gn-fused),
for 50 on a chain graph and 50 on a graph with four loop closures.  Each
path is checked against the port's own CPU run of the same graph.  Right
after GN-dense, 50 calls of ``gn_step_dense`` (the reference's step(),
one Cholesky launch each) are held to GN-dense's chi2 on the card and on
the CPU, and the four whole-graph residual forms to their ``_from`` forms,
to the bit.  The
whole step is also held against its plain version under each robust
kernel, and driven on a closure graph where the f32 reduced system fails
at an iterate, where a failed step must keep the state.

Then the scale path: the windowed gather against its plain version, to
the bit, at the 100k corridor graph's slot grids and on edge cases; GN on
the dual-packed Schur+PCG path with windowed gathers (solve_packed,
gather="windowed") on 10k and 100k corridor graphs, its launches held to
5 + 2 per CG matvec per outer iteration and its chi2 to the CPU run and
the card's plain-gather run; and, on a 10k default walk whose grids the
planner refuses, packed GN, packed LM, flat schur_cg and a GNC LM run.
The two-level preconditioner runs on the 10k corridor (both cycles, held
to the CPU run) and on the 100k corridor beside block-Jacobi (CG
breakdowns, iterations, ms and memory per outer iteration).

The block-banded preconditioner (bband, width 8) runs on the 10k corridor
(held to the CPU run) and on the 100k corridor beside block-Jacobi, and
both corridors run again with bf16 coupling blocks beside their f32 runs
(chi2, ms per outer iteration, peak memory, the clamped CG tolerance).

At the reference size, autodiff Jacobians are held against the analytic
ones, and GN-schur 50 and GN-dense 50 run with autodiff Jacobians and
under cholesky_backend "xla" and "pallas", each against the analytic
"auto" run and with its launches ("xla" launches neither the Schur nor the
Cholesky kernel).

Then the survey-scale path: pgo_initialize and coarse_correct on a 10k
walk with 100 loop closures, each held against the CPU's run (the poses of
the init to the bit), and packed GNC LM under two_level from there; the
native g2o parser (built with g++) against the Python parser on the 100k
corridor's g2o; a resumed gn-fused run (5, save_npz, load_npz, 5) against
10 straight, to the bit; and ``python -m boslam_torch bench`` and
``python -m boslam_torch solve --profile`` as subprocesses (the trace must
name the whole step's kernels).  Nothing imports matplotlib.

Last, the multi-device layouts at world size 1 under NCCL: edge-sharded
gn-dense 50, gn-schur 50 and lm-schur 50 at 301/141 (the Cholesky kernel
on the rank, 50 launches each; the Schur, whole-step and gather kernels
none), their converged chi2 held to the card's single-device runs and the
CPU's; edge-sharded packed GN 10 (btridiag) and LM 5 (warm start) on the
10k corridor, held to solve_packed(gather="take") on the card; pose-range
GN 5 on the 100k corridor and LM 3 under two_level at
POSE_RANGE_r05.json's configuration, held at iteration 0 to the port's CPU
pose-range run (gloo), and against the single-device packed path on the
card over its first step and the pieces of its first build (blocks, S
matvec, diag(S), chain band, preconditioner); each with ms per outer,
per-rank shard bytes, peak memory, collective bytes per CG matvec and, for
one run of each sharded scale layout, a profile of the solve loop apart
from the preparation; the host's cost of one collective call; and
``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
boslam_torch solve ... --pose-range`` as a subprocess.

Between the bench subcommand and the multi-device layouts runs the
measurement layer: the card's ``utils/roofline.chip_spec()`` beside
nvidia-smi, the four kernels' bounds through ``utils/roofline`` (held to
the kernel table's on an H100 SXM), ``boslam_torch.bench``'s headline (its
keys, its chi2 check, 0 < roofline_util <= 1.05, the whole-step kernel's
launches), the six paths of ``tools/port_headline_ab.py`` at one repeat,
each held to the CPU with its kernel's launches, and
``tools/port_scaling_bench.py`` config 4.  After it, the trace + split
phase: ``tools/port_trace_validate.py``'s dense, schur and packed chains,
each profiled once, their launches of the port's kernels counted in the
trace and their chi2 held to the CPU's chains, and
``tools/port_packed_split_probe.py`` at 10k and 100k poses (the packed
build, matvec and preconditioner, eager beside CUDA-graph replays).

Prints the card, the build, one line per check, then a JSON line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}.  Any failed
phase raises and the script exits non-zero; it also exits non-zero, before
printing any result, when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import subprocess
import sys
import time

import numpy as np

from boslam_torch.utils.profiling import (PORT_KERNELS, launches_per_call, profile_path,
                                          time_ms)

SEED = 3  # generate_sequence(301, 141, seed=3): 301 poses, 141 landmarks, N = 1185
ITERS = 50
# generate_sequence(301, 141, seed=16, loop_closures=4): on seed 3 the
# closure graph is still descending at iteration 50, and on seed 0 the f32
# Cholesky of the reduced system fails at some iterate, after which the
# whole step keeps its state (PERF.md, section 7)
CLOSURE_SEED = 16
STALL_SEED = 0  # driven too: a failed step must keep the state
# The scale path (PERF.md, section 4): corridors of generate_sequence, whose
# slot grids the windowed planner accepts, and its default walk, whose it
# refuses.  (n_poses, n_landmarks, seed[, turn_every]).  The 10k corridor is
# seed 2: on seed 3 the port's own CPU windowed and take runs part by 3.1e-3
# at iteration 7 (CG at its cap, rel. residual^2 up to 0.3), so no 2e-3
# bound between two f32 runs holds there (tools/port_packed_scan.py).
MID = (10000, 3900, 2, 10**9)
BIG = (100000, 39000, 3, 10**9)
WALK = (10000, 3900, 3)
# The survey phase: pose-graph init, coarse correction and GNC LM under
# two_level on a default walk with 100 loop closures (n_poses, n_landmarks,
# seed, loop_closures), the JAX package's 10k sizing of both host steps
SURVEY = (10000, 3900, 3, 100)
# The coarse correction's cost trace on the card against the CPU run from
# the same state: twice the largest gap that reordering the f32
# triangulation's sums alone gives on the CPU at SURVEY's size (4.7e-3 over
# 10 orders, tools/port_coarse_scan.py)
COARSE_RTOL = 1e-2
# Iterations held against the CPU run on the walk: 0 at rtol 1e-5 and 1 (the
# first whole step) at 2e-3.  Past the first step the trace is decided by
# rounding: two orderings of the same sums on the CPU part by up to 2.7e-3
# (flat vs packed) and 4.7e-3 (LM, split vs unsplit landmark rows) within
# 10 iterations (tools/port_packed_scan.py), and on the card the walk's
# segment sums run with atomics, so the later gaps change from run to run.
WALK_HELD = 2
# Iterations of two_level on the 10k corridor held against the CPU run: the
# CPU's own windowed and take runs stay within 8.6e-5 over all 10 additive
# iterations, and within 4.3e-4 over the first 9 V-cycle iterations, the
# 10th parting by 5.1e-3 (tools/port_packed_scan.py --preconditioner two_level)
TWO_LEVEL_HELD = {"additive": 10, "vcycle": 9}
# Iterations of bband (width 8) on the 10k corridor held against the CPU
# run: the CPU's own windowed and take runs stay within 7.7e-4 over the
# first 9, the 10th parting by 6.3e-3 (tools/port_packed_scan.py
# --preconditioner bband).  On the 100k corridor, and with bf16 coupling
# blocks on either, the two CPU runs part by 1.1e-2 to 3.5e-2 from the
# second iteration on, so only iteration 0 is held there.
BBAND_HELD = 9
# Multi-device phase, world size 1 under NCCL on the card (PERF.md section 4)
# pose-range at POSE_RANGE_r05.json's configuration: generate_sequence(20000,
# 8000, seed=0, loop_closures=50) (7732 landmarks after triangulation), LM 3
# under two_level, cg_iters 60, cg_tol 1e-7, warm start; its JAX record
POSE_RANGE_R05 = (20000, 8000, 0, 50)
POSE_RANGE_R05_JAX_CHI2 = 26778.3671875
# pose-range at world size 1 against the single-device packed path on the
# card (chip_smoke.range_pieces; PERF.md section 6; on the CPU
# tools/port_packed_scan.py --what pose_range).  The damped blocks, one S
# matvec and the chain band agree to f32 rounding (blocks to the bit or
# 2.4e-9, the rest within 6e-8, card and CPU)
RANGE_PIECE_RTOL = 1e-6
RANGE_EXACT = ("Hpp_diag", "bp", "Hll_inv", "bl", "Bp", "Bl", "matvec", "chain_band")
# diag(S) and the block-Jacobi apply cancel in f32 (1.1e-2 and 3.3e-2 from
# f64 on the packed path at 100k): pose-range's gap to f64 within this
# factor of the packed path's (0.44-0.82 on the card, up to 1.7 on the CPU);
# and the first CG solve's residual, measured by the packed matvec at its
# delta, within this factor of what CG reports (2.1 at 100k, where CG breaks
# down, 1.00 at 20k on the card)
RANGE_RATIO = 4.0
# two_level's apply against the packed path's and, where CG does not break
# down, the chi2 after the first step against the take run: twice the
# largest gap of the card probe and the CPU scan (apply 1.4e-2 on the
# card, 4.0e-3 on the CPU; first step 3.6e-4 on the card, 1.2e-3 on the
# CPU on this graph).  At 100k, where the first outer's CG breaks down,
# two orders of the same sums part by 11% at iteration 1 (the scan), so
# no bound holds there
RANGE_TWO_LEVEL_APPLY = 2.8e-2
RANGE_FIRST_STEP = 2.4e-3
DEV = "cuda"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _bound_ms(fmas: float, nbytes: float) -> tuple[float, str]:
    """Least time on this card for ``fmas`` f32 FMAs (2 flops each) and
    ``nbytes`` moved, from its peaks (``utils/roofline.chip_spec``)."""
    from boslam_torch.utils import roofline

    return roofline.bound_ms(fmas, nbytes, roofline.chip_spec())


def _spd(n, rng, cond=1e4):
    A = rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(A)
    return ((Q * np.geomspace(1.0, cond, n)) @ Q.T).astype(np.float32)


def _check_error(name, err_k, err_p):
    bound = 10.0 * err_p + 1e-4
    if not err_k <= bound:
        raise AssertionError(f"{name}: kernel error {err_k:.3e} vs f64 exceeds {bound:.3e}")


def check_cholesky(torch, chol, H, b, label):
    """Kernel vs plain vs f64 on one system; returns the measurements."""
    from boslam_torch.utils import roofline

    n = H.shape[0]
    x_k = chol.cholesky_solve_padded(H, b)
    x_p = chol.cholesky_solve_padded_plain(H, b)
    torch.cuda.synchronize()
    x64 = torch.linalg.solve(H.double(), b.double())
    err_k = (x_k.double() - x64).abs().max().item()
    err_p = (x_p.double() - x64).abs().max().item()
    if not torch.isfinite(x_k).all():
        raise AssertionError(f"cholesky {label}: non-finite kernel result")
    _check_error(f"cholesky {label}", err_k, err_p)
    if not torch.equal(chol.cholesky_solve_padded(H, b), x_k):
        raise AssertionError(f"cholesky {label}: a second solve gives other bits")
    t = time_ms({
        "kernel": lambda: chol.cholesky_solve_padded(H, b),
        "library": lambda: torch.cholesky_solve(b[:, None], torch.linalg.cholesky(H))})
    plain_ms = time_ms({"plain": lambda: chol.cholesky_solve_padded_plain(H, b)},
                       reps=3, rounds=3)["plain"]
    bound, by = _bound_ms(*roofline.cholesky_work(n))
    r = dict(shape=[n], tile=chol.TILE, max_abs_err=(x_k - x_p).abs().max().item(),
             err_vs_f64=err_k, plain_err_vs_f64=err_p, ms=t["kernel"], plain_ms=plain_ms,
             bound_ms=bound, bound_by=by, library_ms=t["library"],
             vs_library=t["kernel"] / t["library"])
    print(f"cholesky {label} n={n}: " + json.dumps(r))
    return r


def check_cholesky_not_spd(torch, chol, n, rng):
    """A negative pivot in the last tile: x must come out non-finite."""
    H = torch.from_numpy(_spd(n, rng)).cuda()
    H[n - 1, n - 1] = -1.0
    b = torch.ones(n, device="cuda")
    if torch.isfinite(chol.cholesky_solve_padded(H, b)).all():
        raise AssertionError(f"cholesky not SPD (last tile, n={n}): finite result")
    print(f"cholesky not SPD, bad pivot in the last tile, n={n}: x non-finite")


def _schur_f64(torch, Hpp, U, Hb, bp, bl, m, lam):
    Hpp, U, Hb, bp, bl, m = (t.double() for t in (Hpp, U, Hb, bp, bl, m))
    HllD = torch.block_diag(*Hb)
    W = U @ HllD
    eye = torch.eye(Hpp.shape[0], dtype=torch.float64, device=Hpp.device)
    S = (Hpp - W @ U.T + lam * eye) * (m[:, None] * m[None, :]) + eye * (1.0 - m)
    x = torch.linalg.solve(S, m * (W @ bl - bp))
    return x, HllD @ (-bl - U.T @ x)


def _route(band_tiles):
    return "dense" if band_tiles is None else "band"


def check_schur(torch, ss, inputs, lam, label, band_tiles=None, graph=None):
    """The Schur kernel on one route against its plain version (the same
    route) and an f64 solve; on the band route also against the dense
    route on the same inputs, to the bit, and timed beside it.  ``graph``:
    the bound is counted on the graph's envelope (as row 3's), else on the
    dense algorithm."""
    from boslam_torch.utils import roofline

    Np, Ml = inputs[1].shape
    x_k, dl_k = ss.fused_schur_solve_blocks(*inputs, lam, band_tiles)
    x_p, dl_p = ss.fused_schur_solve_blocks_plain(*inputs, lam, band_tiles)
    torch.cuda.synchronize()
    x64, dl64 = _schur_f64(torch, *inputs, float(lam))
    if not (torch.isfinite(x_k).all() and torch.isfinite(dl_k).all()):
        raise AssertionError(f"schur {label}: non-finite kernel result")
    if not bool((x_k[inputs[5] == 0] == 0).all()):
        raise AssertionError(f"schur {label}: masked rows are not exactly 0")
    dense = list(inputs)
    dense[2] = torch.block_diag(*inputs[2])
    x_d, dl_d = ss.fused_schur_solve_padded(*dense, lam)  # the dense route
    if not (torch.equal(x_d, x_k) and torch.equal(dl_d, dl_k)):
        raise AssertionError(f"schur {label}: the dense route (dense-HllD signature) gives "
                             f"another result than the {_route(band_tiles)} route")
    err_k = max((x_k.double() - x64).abs().max().item(), (dl_k.double() - dl64).abs().max().item())
    err_p = max((x_p.double() - x64).abs().max().item(), (dl_p.double() - dl64).abs().max().item())
    _check_error(f"schur {label}", err_k, err_p)
    # the Cholesky share of the work, by the library, as a yardstick only
    S = torch.eye(Np, device=inputs[0].device) * 4.0
    fns = {"kernel": lambda: ss.fused_schur_solve_blocks(*inputs, lam, band_tiles),
           "chol_library": lambda: torch.cholesky_solve(inputs[3][:, None], torch.linalg.cholesky(S))}
    if band_tiles is not None:
        fns["dense"] = lambda: ss.fused_schur_solve_blocks(*inputs, lam)
        # wider bands than S's compute the same numbers over more zero tiles:
        # what each added band tile costs
        for bt in (b for b in range(band_tiles + 1, 8) if ss.band_fits(b, Np)):
            if not all(torch.equal(a, r) for a, r in zip(
                    ss.fused_schur_solve_blocks(*inputs, lam, bt), (x_k, dl_k))):
                raise AssertionError(f"schur {label}: band {bt} differs from band {band_tiles}")
            fns[f"band {bt}"] = lambda bt=bt: ss.fused_schur_solve_blocks(*inputs, lam, bt)
    t = time_ms(fns)
    ms, chol_lib_ms = t["kernel"], t["chol_library"]
    plain_ms = time_ms({"plain": lambda: ss.fused_schur_solve_blocks_plain(
        *inputs, lam, band_tiles)}, reps=3, rounds=3)["plain"]
    bound, by = _bound_ms(*(roofline.schur_solve_work(graph) if graph is not None
                            else roofline.schur_solve_dense_work(Np, Ml)))
    err = max((x_k - x_p).abs().max().item(), (dl_k - dl_p).abs().max().item())
    r = dict(shape=[Np, Ml], route=_route(band_tiles), band_tiles=band_tiles,
             max_abs_err=err, err_vs_f64=err_k, plain_err_vs_f64=err_p, ms=ms,
             dense_route_ms=t.get("dense"), bitwise_vs_dense_route=True,
             wider_band_ms={k: v for k, v in t.items() if k.startswith("band ")},
             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
             bound_basis="envelope" if graph is not None else "dense", library_ms=None,
             cholesky_only_library_ms=chol_lib_ms,
             launches_per_call=launches_per_call(
                 lambda: ss.fused_schur_solve_blocks(*inputs, lam, band_tiles)))
    print(f"schur {label} Np={Np} Ml={Ml}: " + json.dumps(r))
    return r


def _f64_step(g, cfg):
    """The same GN step solved in f64 on the CPU (the port's dense path)."""
    from boslam_torch.solver.optimizer import gn_step

    g = g.to("cpu")
    g64 = dataclasses.replace(g, **{f.name: getattr(g, f.name).double()
                                    for f in dataclasses.fields(g)
                                    if getattr(g, f.name).is_floating_point()})
    return gn_step(g64, cfg.replace(linear_solver="dense", fused_step="off"))[0]


def check_gn_step(torch, gs, g, cfg, label):
    """One whole step on the card: the kernel against its plain version and
    the unfused Schur step, on the card and on the CPU, all five against the
    f64 step.

    The state is held to the f64 step: the kernel's distance from it at most
    twice the largest of the four other f32 steps' distances.  The distance
    between two f32 steps (printed) is no measure: at the ~1e7 condition of
    the system each lands 5e-4 to 5e-3 from the f64 step, in its own
    direction, and the plain and unfused steps on the card sum with atomics,
    so theirs changes from run to run (tools/gn_step_accuracy.py).  ``g`` is
    built on the CPU, so the kernel's reading repeats."""
    from boslam_torch.solver.optimizer import gn_step
    from boslam_torch.utils import roofline

    prep = gs.prep_static(g, gs.tile_band(g))
    poses, lms = g.poses.clone(), g.landmarks.clone()
    kern = gs.GNStepKernel(prep, poses, lms, cfg)
    row = torch.zeros(gs.STATS_WIDTH, device=g.device)
    kern.step(row)
    if prep.band_tiles is not None:
        # the dense route on the same step: the same bits
        prep_d = dataclasses.replace(prep, band_tiles=None)
        p_d, l_d = g.poses.clone(), g.landmarks.clone()
        kern_d = gs.GNStepKernel(prep_d, p_d, l_d, cfg)
        row_d = torch.zeros_like(row)
        kern_d.step(row_d)
        if not (torch.equal(p_d, poses) and torch.equal(l_d, lms) and torch.equal(row_d, row)):
            raise AssertionError(f"gn_step {label}: the band route (bt {prep.band_tiles}) and the "
                                 f"dense route part: {row.tolist()} vs {row_d.tolist()}")
    p_p, l_p, row_p = gs.fused_gn_step_plain(prep, g.poses, g.landmarks, cfg)
    g_u, _ = gn_step(g, cfg.replace(fused_step="off"))
    g_cpu = g.to("cpu")
    p_c, l_c, _ = gs.fused_gn_step_plain(gs.prep_static(g_cpu, prep.band_tiles), g_cpu.poses, g_cpu.landmarks, cfg)
    g_uc, _ = gn_step(g_cpu, cfg.replace(fused_step="off"))
    torch.cuda.synchronize()
    rk, rp = row.cpu().numpy(), row_p.cpu().numpy()
    if not (np.allclose(rk[:3], rp[:3], rtol=1e-5, atol=1e-6) and np.array_equal(rk[3:5], rp[3:5])
            and rk[6] == 1.0 and rp[6] == 1.0):
        raise AssertionError(f"gn_step {label}: stats {rk.tolist()} vs plain {rp.tolist()}")

    def dist(a, b):
        return (a.double().cpu() - b.double().cpu()).abs().max().item()

    x64 = _f64_step(g, cfg)
    states = {"kernel": (poses, lms), "plain": (p_p, l_p), "unfused": (g_u.poses, g_u.landmarks),
              "plain cpu": (p_c, l_c), "unfused cpu": (g_uc.poses, g_uc.landmarks)}
    err64 = {k: max(dist(P, x64.poses), dist(L, x64.landmarks)) for k, (P, L) in states.items()}
    max_abs_err = max(dist(poses, p_p), dist(lms, l_p))
    gap = max(dist(g_u.poses, p_p), dist(g_u.landmarks, l_p))
    if not err64["kernel"] <= 2.0 * max(v for k, v in err64.items() if k != "kernel"):
        raise AssertionError(f"gn_step {label}: kernel-plain {max_abs_err:.3e}, unfused-plain "
                             f"{gap:.3e}, vs f64 {err64}")
    fns = {"kernel": lambda: kern.step(row)}
    if prep.band_tiles is not None:
        fns["dense"] = lambda: kern_d.step(row_d)
    t = time_ms(fns)
    ms = t["kernel"]
    plain_ms = time_ms({"plain": lambda: gs.fused_gn_step_plain(prep, g.poses, g.landmarks,
                                                                       cfg)}, reps=3, rounds=3)["plain"]
    fmas, nbytes = roofline.gn_step_work(g)
    bound, by = _bound_ms(fmas, nbytes)
    r = dict(shape=[prep.Np, prep.Ml], graph=[g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry],
             route=_route(prep.band_tiles), band_tiles=prep.band_tiles,
             band_of_s=gs.structural_band(g), dense_route_ms=t.get("dense"),
             bitwise_vs_dense_route=prep.band_tiles is not None,
             robust=[cfg.robust, cfg.kernel_threshold, cfg.reference_kernel_quirk],
             clamped=[int(rk[3]), int(rk[4])],
             max_abs_err=max_abs_err, unfused_vs_plain=gap, err_vs_f64=err64, ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by=by, fmas=fmas, bytes=nbytes,
             dense_algorithm_bound_ms=_bound_ms(roofline.dense_step_fmas(prep.Np, prep.Ml),
                                                0.0)[0], library_ms=None,
             launches_per_call=launches_per_call(lambda: kern.step(row)))
    print(f"gn_step {label}: " + json.dumps(r))
    return r


def run_fused(torch, solve, g, g_cpu, cfg, counters, chi2_schur, meta, gt, label):
    """The whole-step path for cfg.iters iterations, twice: launch counts,
    the converged chi2 against the CPU run (fused_step="force", the plain
    version) and the card's gn-schur run, and a bitwise repeat."""
    from boslam_torch.metrics import ate_metrics, match_gt_poses

    st_cpu = _stats(solve(g_cpu, cfg.replace(fused_step="force"))[1])
    band = _band_route(_graph_band(g), label)
    g2, st, counts, secs = _run_path(torch, solve, g, cfg, counters)
    want = _want(counts, gn_step=cfg.iters, gn_step_band=cfg.iters)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    c, c_cpu = st["chi2_robust"], st_cpu["chi2_robust"]
    rel_cpu = abs(c[-1] - c_cpu[-1]) / c_cpu[-1]
    rel_schur = abs(c[-1] - chi2_schur) / chi2_schur
    if not (np.isfinite(c).all() and st["spd_ok"].all() and c[-1] < c[0]
            and rel_cpu < 1e-4 and rel_schur < 1e-4):
        raise AssertionError(f"{label}: chi2 {c[0]} -> {c[-1]}, CPU {c_cpu[-1]} (rel {rel_cpu:.2e}), "
                             f"gn-schur {chi2_schur} (rel {rel_schur:.2e}), spd {st['spd_ok'].all()}")
    g3, st2, _, secs_warm = _run_path(torch, solve, g, cfg, counters)
    if not (np.array_equal(st2["chi2_robust"], c) and torch.equal(g3.poses, g2.poses)
            and torch.equal(g3.landmarks, g2.landmarks)):
        raise AssertionError(f"{label}: a second run is not bitwise identical")
    ate = ate_metrics(g2.poses.cpu().numpy(), match_gt_poses(meta, gt))
    print(f"{label}: " + json.dumps(dict(
        launches=counts, route="band", band_tiles=band, chi2_first=float(c[0]),
        chi2_final=float(c[-1]), chi2_final_cpu=float(c_cpu[-1]), rel_vs_cpu=float(rel_cpu),
        chi2_final_gn_schur=float(chi2_schur), rel_vs_gn_schur=float(rel_schur),
        bitwise_repeat=True, ate_rmse_aligned=ate["ate_rmse_aligned"],
        ms_per_iter_first_run=secs / cfg.iters * 1e3, ms_per_iter=secs_warm / cfg.iters * 1e3)))
    return counts["gn_step"]


def _first_failed_step(st, repeats):
    """Index of the first step whose new state was not finite, or None.

    A failed step keeps the state (the guard of pallas_gn_step.py:911-915).
    With ``repeats``, for a step that gives the same bits from the same
    inputs, every later step then starts from the same state, fails the
    same way and reads the same chi2."""
    ok, c = st["spd_ok"], st["chi2_robust"]
    if not np.isfinite(c).all():
        raise AssertionError(f"non-finite chi2 {c}")
    if ok.all():
        return None
    k = int(np.argmin(ok))
    if repeats and (ok[k:].any() or not (c[k:] == c[k]).all()):
        raise AssertionError(f"steps after the failed step {k} moved: spd_ok {ok[k:]}, chi2 {c[k:]}")
    return k


def run_stall(torch, solve, g, g_cpu, cfg, counters, label):
    """The whole step on a graph where the f32 Cholesky of the reduced
    system S = Hpp - U Hll^-1 U^T can fail (NaN) at an iterate (PERF.md,
    section 7): the kernel keeps the state from its first failed step on.
    Its plain version on the CPU (whose f32 products need not repeat to the
    bit) and the card's unfused path are printed beside it."""
    band = _band_route(_graph_band(g), label)
    g2, st, counts, secs = _run_path(torch, solve, g, cfg, counters)
    want = _want(counts, gn_step=cfg.iters, gn_step_band=cfg.iters)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    if not (torch.isfinite(g2.poses).all() and torch.isfinite(g2.landmarks).all()):
        raise AssertionError(f"{label}: non-finite final state")
    k = _first_failed_step(st, repeats=True)
    st_cpu = _stats(solve(g_cpu, cfg.replace(fused_step="force"))[1])
    k_cpu = _first_failed_step(st_cpu, repeats=False)
    _, st_u, _, _ = _run_path(torch, solve, g, cfg.replace(fused_step="off"), counters)
    print(f"{label}: " + json.dumps(dict(
        launches=counts, route="band", band_tiles=band, first_failed_step=k,
        chi2_at_stall=float(st["chi2_robust"][-1]),
        plain_cpu_first_failed_step=k_cpu, plain_cpu_chi2_final=float(st_cpu["chi2_robust"][-1]),
        unfused_spd_ok=bool(st_u["spd_ok"].all()),
        unfused_chi2_final=float(st_u["chi2_robust"][-1]), ms_per_iter=secs / cfg.iters * 1e3)))


def _random_schur_inputs(torch, Np, Ml, rng):
    U = (0.1 * rng.standard_normal((Np, Ml))).astype(np.float32)
    HllD = np.zeros((Ml, Ml), np.float32)
    for l in range(Ml // 2):
        HllD[2 * l:2 * l + 2, 2 * l:2 * l + 2] = _spd(2, rng, cond=3.0)
    Hpp = (_spd(Np, rng) + U @ HllD @ U.T).astype(np.float32)  # S is SPD, cond ~1e4
    bp = rng.standard_normal(Np).astype(np.float32)
    bl = rng.standard_normal(Ml).astype(np.float32)
    m = np.ones(Np, np.float32)
    m[:3] = 0.0
    m[Np - 40:] = 0.0
    Hb = np.stack([HllD[2 * l:2 * l + 2, 2 * l:2 * l + 2] for l in range(Ml // 2)])
    return tuple(torch.from_numpy(a).cuda() for a in (Hpp, U, Hb, bp, bl, m))


def _stats(st):
    return {k: v.cpu().numpy() for k, v in st.items()}


def _run_path(torch, solve, g, cfg, counters):
    """Drive one path with every count at 0; returns (graph, stats, counts, seconds).

    The solve runs under CUDA sync-debug mode "error": an operation that
    makes the host wait for the card inside the iterations raises."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "band_launches"):
            fn.band_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g2, st = solve(g, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    counts.update({f"{k}_band": fn.band_launches for k, fn in counters.items()
                   if hasattr(fn, "band_launches")})
    return g2, _stats(st), counts, seconds


def run_gn_step_dense_phase(torch, g, counters, st_d, st_cpu_d):
    """50 calls of ``gn_step_dense`` on the card from the triangulated state,
    under sync-debug "error" with every count at 0: every step SPD, chi2
    falling, the last within 1e-4 of GN-dense's on the card (``st_d``) and
    on the CPU (``st_cpu_d``), exactly one Cholesky launch per step.  Then
    the whole-graph residual forms against their ``_from`` forms, to the
    bit.  Returns the Cholesky launches."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver import residuals as res
    from boslam_torch.solver.gauss_newton import gn_step_dense

    cfg = SolverConfig(linear_solver="dense")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gi, trace = g, []
        for _ in range(ITERS):
            gi, st = gn_step_dense(gi, cfg)
            trace.append(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    c = torch.stack([s["chi2_robust"] for s in trace]).cpu().numpy()
    spd = all(bool(s["spd_ok"]) for s in trace)
    cd, cd_cpu = st_d["chi2_robust"], st_cpu_d["chi2_robust"]
    rel, rel_cpu = abs(c[-1] - cd[-1]) / cd[-1], abs(c[-1] - cd_cpu[-1]) / cd_cpu[-1]
    if counts != _want(counts, cholesky=ITERS):
        raise AssertionError(f"gn-step-dense: launches {counts}, want {ITERS} of the Cholesky")
    if not (spd and np.isfinite(c).all() and c[-1] < c[0] and rel < 1e-4 and rel_cpu < 1e-4):
        raise AssertionError(f"gn-step-dense: spd_ok {spd}, chi2 {c[0]} -> {c[-1]}, GN-dense "
                             f"{cd[-1]} (rel {rel:.2e}), CPU {cd_cpu[-1]} (rel {rel_cpu:.2e})")
    p, l = g.poses[g.b_pose], g.landmarks[g.b_lm]
    src, dst = g.poses[g.o_src], g.poses[g.o_dst]
    pairs = {
        "bearing_error": (res.bearing_error(g.poses, g.landmarks, g.b_pose, g.b_lm, g.b_meas),
                          res.bearing_error_from(p, l, g.b_meas)),
        "odometry_error": (res.odometry_error(g.poses, g.o_src, g.o_dst, g.o_meas),
                           res.odometry_error_from(src, dst, g.o_meas)),
        "bearing_jacobians": (res.bearing_jacobians(g.poses, g.landmarks, g.b_pose, g.b_lm),
                              res.bearing_jacobians_from(p, l)),
        "odometry_jacobians": (res.odometry_jacobians(g.poses, g.o_src, g.o_dst),
                               res.odometry_jacobians_from(src, dst)),
    }
    for name, (whole, parts) in pairs.items():
        whole, parts = (whole, parts) if isinstance(whole, tuple) else ((whole,), (parts,))
        if not all(torch.equal(a, b) for a, b in zip(whole, parts, strict=True)):
            raise AssertionError(f"{name}: the whole-graph form differs from the _from form")
    print("gn-step-dense: " + json.dumps(dict(
        launches=counts, ms_per_step=secs / ITERS * 1e3, chi2_first=float(c[0]),
        chi2_final=float(c[-1]), chi2_final_gn_dense=float(cd[-1]),
        chi2_final_cpu=float(cd_cpu[-1]), rel_vs_gn_dense=float(rel), rel_vs_cpu=float(rel_cpu),
        max_abs_diff_chi2_vs_gn_dense=float(np.abs(c - cd).max()),
        same_bits_as_gn_dense=bool(np.array_equal(c, cd)),
        residual_forms_bit_equal=sorted(pairs))))
    return counts["cholesky"]


def _want(counts, **nonzero):
    """Every count of ``counts`` at 0 but those named."""
    return {**dict.fromkeys(counts, 0), **nonzero}


def _graph_band(g):
    """The band route's ``band_tiles`` for ``g``'s whole step (None: dense)."""
    from boslam_torch.ops import gn_step as gs

    return gs.tile_band(g)


def _band_route(band, label):
    if band is None:
        raise AssertionError(f"{label}: the graph takes the dense route, not the band route")
    return band


def _corridor(generate_sequence, build_graph, n_poses, n_landmarks, seed, turn_every=50, **kw):
    """A synthetic graph built on the CPU (the triangulation sums with
    atomics on the card): (graph on the CPU, meta, ground truth).  A
    ``turn_every`` past the pose count makes a corridor."""
    ig, gt = generate_sequence(n_poses, n_landmarks, seed=seed, turn_every=turn_every, **kw)
    g_cpu, meta = build_graph(ig, init="triangulate", device="cpu")
    return g_cpu, meta, gt


def _card_plan(torch, wg, plan):
    return wg.WindowPlan(plan.starts.to(DEV), plan.window, plan.tile_rows)


def _hold_exact(torch, wg, values, idx, plan, label, valid=None):
    """The kernel against its plain version on the card: equal to the bit,
    and on the valid slots equal to values[idx].  Returns max |diff|."""
    out = wg.windowed_take(values, idx, plan)
    ref = wg.windowed_take_plain(values, idx, plan)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    if not torch.equal(out, ref):
        raise AssertionError(f"windowed_take {label}: kernel differs from its plain version "
                             f"by {err:.3e}")
    if valid is not None and not torch.equal(out[valid], values[idx][valid]):
        raise AssertionError(f"windowed_take {label}: a valid slot is not values[idx]")
    return out, err


def check_windowed(torch, wg, pk, n_poses, n_landmarks, rng):
    """windowed_take at the 100k corridor graph's grids (the pose grid, K 7,
    C 2 and 4; the landmark grid, K 24, C 3) and on edge cases: 128-row
    tiles, a window wider than the values, poisoned and -1 slots.  Every
    result must equal the plain version to the bit.  Returns the rows."""
    from boslam_torch.utils import roofline

    rows = {}
    for name, idx_c, omega, plan_c, M, chans in (
            ("pose grid", pk.p_lm, pk.p_omega, pk.p_plan, n_landmarks, (2, 4)),
            ("landmark grid", pk.l_pose, pk.l_omega, pk.l_plan, n_poses, (3,))):
        idx, valid, plan = idx_c.to(DEV), (omega > 0).to(DEV), _card_plan(torch, wg, plan_c)
        R, K = idx.shape
        for C in chans:
            values = torch.from_numpy(rng.standard_normal((M, C)).astype(np.float32)).to(DEV)
            _, err = _hold_exact(torch, wg, values, idx, plan, f"{name} C={C}", valid)
            t = time_ms({"kernel": lambda: wg.windowed_take(values, idx, plan),
                         "library": lambda: values[idx]}, graph=True)
            ms, lib_ms = t["kernel"], t["library"]
            plain_ms = time_ms({"plain": lambda: wg.windowed_take_plain(values, idx, plan)},
                               reps=5, rounds=3)["plain"]
            nbytes = roofline.windowed_take_bytes(R, K, M, C)
            bound, by = _bound_ms(0.0, nbytes)
            r = dict(shape=[R, K, C], values_rows=M, window=plan.window, tile_rows=plan.tile_rows,
                     n_tiles=plan.n_tiles, last_tile_rows=R - (plan.n_tiles - 1) * plan.tile_rows,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     library_ms=lib_ms, vs_library=ms / lib_ms, no_slower_than_library=ms <= lib_ms,
                     bound_fraction=bound / ms, bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
            print(f"windowed_take {name} C={C}: " + json.dumps(r))
            rows[(name, C)] = r

    # edge cases: 128-row tiles (landmark grid), window > M, poisoned slots
    edges = {}
    lp = pk.l_pose.numpy()
    plan128 = wg.plan_windows(lp, pk.l_omega.numpy() > 0, n_poses, tile_rows=128, device=DEV)
    if plan128 is None or plan128.tile_rows != 128:
        raise AssertionError("windowed_take: no 128-row plan for the landmark grid")
    values = torch.from_numpy(rng.standard_normal((n_poses, 3)).astype(np.float32)).to(DEV)
    idx = pk.l_pose.to(DEV)
    edges["tile_rows_128"] = _hold_exact(torch, wg, values, idx, plan128, "128-row tiles",
                                         (pk.l_omega > 0).to(DEV))[1]
    M, R, K = 90, 1001, 5
    idx_s = rng.integers(0, M, (R, K)).astype(np.int32)
    plan_s = wg.plan_windows(idx_s, np.ones((R, K), bool), M, device=DEV)
    if not (plan_s.window > M and R % plan_s.tile_rows):
        raise AssertionError(f"windowed_take: window {plan_s.window} vs M {M}, R {R}")
    for C in (2, 3, 4):
        vals = torch.from_numpy(rng.standard_normal((M, C)).astype(np.float32)).to(DEV)
        edges[f"window_past_values_C{C}"] = _hold_exact(
            torch, wg, vals, torch.from_numpy(idx_s).to(DEV), plan_s, f"window > M, C={C}",
            torch.ones((R, K), dtype=torch.bool, device=DEV))[1]
    plan_l = _card_plan(torch, wg, pk.l_plan)
    poisoned = pk.l_pose.clone()
    start0 = int(pk.l_plan.starts[0])
    poisoned[3, 1] = start0 + pk.l_plan.window + 7  # past tile 0's window
    poisoned[5, 2] = -1
    out, edges["poisoned"] = _hold_exact(torch, wg, values, poisoned.to(DEV), plan_l, "poisoned")
    if not (bool((out[3, 1] == 0).all()) and bool((out[5, 2] == 0).all())):
        raise AssertionError("windowed_take: a poisoned slot did not give zeros")
    print("windowed_take edge cases: " + json.dumps(dict(
        max_abs_err=edges, tile_rows_128_tiles=plan128.n_tiles, window_past_values=[plan_s.window, M],
        ragged_last_tile=[R, plan_s.tile_rows])))
    return rows


def _packed_launches(st, cfg):
    """Windowed-gather launches the packed path makes: 5 + 2 per matvec per
    GN outer iteration (2 in the build, the rhs, diag(S), the
    back-substitution), one more per LM trial (its cost check) and one more
    under "bband" (its assembly's take of Hll^-1)."""
    per = 5 + (cfg.optimizer == "lm") + (cfg.preconditioner == "bband")
    return int(sum(per + 2 * int(m) for m in st["cg_matvecs"]))


def _rel_trace(c, ref):
    return np.abs(np.asarray(c, np.float64) - ref) / np.abs(np.asarray(ref, np.float64))


def _hold_trace(c, ref, held, label, what):
    """chi2 at iteration 0 within rtol 1e-5 and iterations 1..held-1 within 2e-3."""
    rel = _rel_trace(c, ref)
    if not (np.isfinite(c).all() and rel[0] < 1e-5 and (rel[1:held] < 2e-3).all()):
        raise AssertionError(f"{label}: chi2 {c.tolist()} vs {what} {np.asarray(ref).tolist()} "
                             f"(rel {rel.tolist()}, held {held})")
    return rel


def run_packed(torch, solve, g, cfg, counters, label, windowed):
    """One packed or flat CG path on the card with every count at 0: checks
    the windowed launches against the formula (0 when not ``windowed``)."""
    g2, st, counts, secs = _run_path(torch, solve, g, cfg, counters)
    want = _want(counts)
    if windowed:
        want["windowed_take"] = _packed_launches(st, cfg)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return g2, st, counts, secs


def _cg_summary(st, cfg, secs):
    iters = cfg.iters
    return dict(ms_per_outer=secs / iters * 1e3, cg_iters=st["cg_iters"].tolist(),
                sum_cg_iters=int(st["cg_iters"].sum()), sum_matvecs=int(st["cg_matvecs"].sum()),
                polls_per_outer=float(st["cg_polls"].mean()),
                breakdowns=int(st["cg_breakdown"].sum()))


def per_outer_run(st, cfg, secs, peak):
    """A packed run's trace per outer iteration, its ms per outer and peak."""
    return dict(chi2=st["chi2_robust"].tolist(), breakdown=st["cg_breakdown"].tolist(),
                breakdown_events=st["cg_breakdown_events"].tolist(),
                cg_iters=st["cg_iters"].tolist(), cg_rel_res2=st["cg_rel_res2"].tolist(),
                ms_per_outer=secs / cfg.iters * 1e3, max_memory_allocated=peak)


def run_bband(torch, solve_packed, g, g_cpu, cfg, counters, size, held, beside):
    """Packed-windowed GN under "bband" (band width 8, the JAX default):
    launches by the formula, chi2 held to the CPU run (``g_cpu``; iteration
    0 at 1e-5, iterations 1..held-1 at 2e-3) or, without one, iteration 0
    to the ``beside`` run's (the same initial state); CG iterations,
    breakdowns, ms per outer and the peak beside the slot-match mask's
    size.  Returns its gather launches."""
    label = f"bband packed-windowed {size}"
    cfg_bb = cfg.replace(preconditioner="bband")
    q = cfg_bb.band_group or cfg_bb.band_width
    torch.cuda.reset_peak_memory_stats()
    _, st, counts, secs = run_packed(torch, solve_packed, g, cfg_bb, counters, label, True)
    peak = torch.cuda.max_memory_allocated()
    c = st["chi2_robust"]
    if g_cpu is not None:
        ref = _stats(solve_packed(g_cpu, cfg_bb)[1])["chi2_robust"]
        what = "CPU"
    else:
        ref = np.asarray(next(iter(beside.values()))["chi2"])
        what = next(iter(beside))
    rel = _hold_trace(c, ref, held, label, what)
    if not c[-1] < c[0]:
        raise AssertionError(f"{label}: chi2 {c.tolist()} did not descend")
    K = int(torch.bincount(g.b_pose, minlength=g.n_poses).max())  # pose-grid slots
    print(f"{label}: " + json.dumps(dict(
        launches=counts["windowed_take"], launches_expected=_packed_launches(st, cfg_bb),
        band_width=q, held_iterations=held, held_against=what, rel=rel.tolist(),
        # the largest [NP-d, K, K] f32 slot-match mask of the assembly (d = 1)
        slot_match_mask_bytes=4 * (g.n_poses - 1) * K * K, pose_grid_slots=K,
        bband=per_outer_run(st, cfg_bb, secs, peak), **beside)))
    return counts["windowed_take"]


def run_bf16(torch, solve_packed, g, cfg, counters, size, f32, f32_name):
    """The same packed-windowed run with bf16 coupling blocks, beside its f32
    run of this call (``f32``, a ``per_outer_run``): chi2 after the run, ms
    per outer, peak, and the clamped CG tolerance (4e-3, the floor).  The
    first chi2 is the initial state's, held to the f32 run's at 1e-5.
    Returns its gather launches."""
    from boslam_torch.config import BF16_CG_TOL_FLOOR

    label = f"bf16 coupling packed-windowed {size} ({f32_name})"
    cfg16 = cfg.replace(coupling_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    _, st, counts, secs = run_packed(torch, solve_packed, g, cfg16, counters, label, True)
    peak = torch.cuda.max_memory_allocated()
    c = st["chi2_robust"]
    _hold_trace(c, np.asarray(f32["chi2"]), 1, label, f"f32 {f32_name}")
    tol = st["cg_tol_effective"]
    if not (c[-1] < c[0] and (tol == np.float32(BF16_CG_TOL_FLOOR)).all()):
        raise AssertionError(f"{label}: chi2 {c.tolist()}, cg_tol_effective {tol.tolist()}")
    print(f"{label}: " + json.dumps(dict(
        launches=counts["windowed_take"], launches_expected=_packed_launches(st, cfg16),
        cg_tol_effective=float(tol[0]), chi2_last=float(c[-1]), chi2_last_f32=f32["chi2"][-1],
        rel_chi2_last_vs_f32=abs(float(c[-1]) - f32["chi2"][-1]) / f32["chi2"][-1],
        ms_per_outer=secs / cfg.iters * 1e3, ms_per_outer_f32=f32["ms_per_outer"],
        peak_mb=peak / 2**20, peak_mb_f32=f32["max_memory_allocated"] / 2**20,
        bf16=per_outer_run(st, cfg16, secs, peak))))
    return counts["windowed_take"]


def run_scale_phases(torch, wg, counters, solve, generate_sequence, build_graph, SolverConfig):
    """Slice 3: windowed_take at the 100k grids, then the packed Schur+PCG
    path with windowed gathers at 10k and 100k corridor poses, and the
    packed-take, LM, flat CG and GNC runs on the default walk, whose plans
    the planner refuses.  Returns (the kernel's row, its launches on the
    packed-windowed runs)."""
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.graph.reorder import reorder_landmarks_by_pose
    from boslam_torch.metrics import ate_metrics, match_gt_poses
    from boslam_torch.solver.optimizer import solve_packed

    def windowed_packing(g_cpu):
        return pack_edges(reorder_landmarks_by_pose(g_cpu)[0], windows=True)

    # ---- phase 1: the kernel at the 100k corridor's grids, and edge cases ----
    t0 = time.perf_counter()
    g100_cpu, _, _ = _corridor(generate_sequence, build_graph, *BIG)
    pk100, meta100 = windowed_packing(g100_cpu)
    if not meta100.windowed or meta100.n_virt_rows is not None:
        raise AssertionError(f"100k corridor: {meta100}")
    rows = check_windowed(torch, wg, pk100, g100_cpu.n_poses, g100_cpu.n_landmarks,
                          np.random.default_rng(1))
    print(f"phase windowed_take: {time.perf_counter() - t0:.1f} s wall")

    # ---- phase 2: packed-windowed 10k corridor, GN, "auto" = btridiag ----
    t0 = time.perf_counter()
    g_cpu, meta, gt = _corridor(generate_sequence, build_graph, *MID)
    g = g_cpu.to(DEV)
    _, pmeta = windowed_packing(g_cpu)
    if not pmeta.windowed or pmeta.n_virt_rows is not None:
        raise AssertionError(f"10k corridor: {pmeta}")
    cfg = SolverConfig(linear_solver="schur_cg", gather="windowed", iters=10)
    st_cpu = _stats(solve_packed(g_cpu, cfg)[1])
    g2, st, counts, secs = run_packed(torch, solve_packed, g, cfg, counters, "packed-windowed 10k",
                                      True)
    launches = counts["windowed_take"]
    c = st["chi2_robust"]
    rel_cpu = _hold_trace(c, st_cpu["chi2_robust"], cfg.iters, "packed-windowed 10k", "CPU")
    _, st_t, _, secs_t = run_packed(torch, solve_packed, g, cfg.replace(gather="take"), counters,
                                    "packed-take 10k corridor", False)
    rel_take = _hold_trace(c, st_t["chi2_robust"], cfg.iters, "packed-windowed 10k", "take run")
    torch.cuda.reset_peak_memory_stats()
    g3, st2, _, secs2 = run_packed(torch, solve_packed, g, cfg, counters,
                                   "packed-windowed 10k repeat", True)
    peak2 = torch.cuda.max_memory_allocated()
    bitwise = bool(np.array_equal(st2["chi2_robust"], c) and torch.equal(g3.poses, g2.poses)
                   and torch.equal(g3.landmarks, g2.landmarks))
    ate = ate_metrics(g2.poses.cpu().numpy(), match_gt_poses(meta, gt))
    prof = profile_path(solve_packed, g, cfg, iters=1)
    print("packed-windowed 10k: " + json.dumps(dict(
        graph=[g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry], seed=MID[2],
        launches=counts["windowed_take"], launches_expected=_packed_launches(st, cfg),
        chi2_first=float(c[0]), chi2_last=float(c[-1]), chi2_last_cpu=float(st_cpu["chi2_robust"][-1]),
        rel_vs_cpu=rel_cpu.tolist(), rel_vs_take=rel_take.tolist(),
        matvecs_wasted_by_masking=int(st["cg_matvecs"].sum() - st["cg_iters"].sum()),
        ms_per_outer_first_run=secs / cfg.iters * 1e3, ms_per_outer_take=secs_t / cfg.iters * 1e3,
        bitwise_repeat=bitwise, ate_rmse_aligned=ate["ate_rmse_aligned"],
        device_busy_share=prof["device_busy_share"], profile=prof, max_memory_allocated=peak2,
        **_cg_summary(st2, cfg, secs2))))
    print(f"phase packed-windowed 10k: {time.perf_counter() - t0:.1f} s wall")

    # ---- phase 2b: the same runs under the two-level preconditioner, both cycles ----
    t0 = time.perf_counter()
    for cycle in ("additive", "vcycle"):
        label = f"two_level {cycle} packed-windowed 10k"
        cfg_tl = cfg.replace(preconditioner="two_level", two_level_cycle=cycle)
        st_cpu_tl = _stats(solve_packed(g_cpu, cfg_tl)[1])
        _, st_tl, counts_tl, secs_tl = run_packed(torch, solve_packed, g, cfg_tl, counters, label,
                                                  True)
        launches += counts_tl["windowed_take"]
        c_tl = st_tl["chi2_robust"]
        rel_tl = _hold_trace(c_tl, st_cpu_tl["chi2_robust"], TWO_LEVEL_HELD[cycle], label, "CPU")
        if not c_tl[-1] < c_tl[0]:
            raise AssertionError(f"{label}: chi2 {c_tl.tolist()} did not descend")
        print(f"{label}: " + json.dumps(dict(
            launches=counts_tl["windowed_take"], launches_expected=_packed_launches(st_tl, cfg_tl),
            held_iterations=TWO_LEVEL_HELD[cycle], rel_vs_cpu=rel_tl.tolist(),
            chi2_first=float(c_tl[0]), chi2_last=float(c_tl[-1]),
            chi2_last_btridiag=float(st2["chi2_robust"][-1]),
            cg_iters_btridiag=st2["cg_iters"].tolist(),
            breakdown_events=st_tl["cg_breakdown_events"].tolist(),
            **_cg_summary(st_tl, cfg_tl, secs_tl))))
    print(f"phase two_level 10k: {time.perf_counter() - t0:.1f} s wall")

    # ---- phase 2c: bband (width 8) and bf16 coupling storage on the 10k corridor ----
    t0 = time.perf_counter()
    launches += run_bband(torch, solve_packed, g, g_cpu, cfg, counters, "10k", BBAND_HELD,
                          dict(btridiag=per_outer_run(st2, cfg, secs2, peak2)))
    launches += run_bf16(torch, solve_packed, g, cfg, counters, "10k",
                         per_outer_run(st2, cfg, secs2, peak2), "btridiag")
    print(f"phase bband + bf16 10k: {time.perf_counter() - t0:.1f} s wall")

    # ---- phase 3: packed-windowed 100k corridor, GN, "auto" = block-Jacobi ----
    t0 = time.perf_counter()
    g = g100_cpu.to(DEV)
    cfg = SolverConfig(linear_solver="schur_cg", gather="windowed", iters=5)
    torch.cuda.reset_peak_memory_stats()
    g2, st, counts, secs = run_packed(torch, solve_packed, g, cfg, counters, "packed-windowed 100k",
                                      True)
    peak = torch.cuda.max_memory_allocated()
    launches += counts["windowed_take"]
    _, st_t, _, secs_t = run_packed(torch, solve_packed, g, cfg.replace(gather="take"), counters,
                                    "packed-take 100k", False)
    # CG breaks down in every outer iteration here (block-Jacobi, as in the
    # JAX package): the trace after iteration 0 is not reproducible under a
    # change of summation order (PERF.md), so only iteration 0 is held
    c = st["chi2_robust"]
    rel_take = _hold_trace(c, st_t["chi2_robust"], 1, "packed-windowed 100k", "take run")
    if not c[-1] < c[0]:
        raise AssertionError(f"packed-windowed 100k: chi2 {c.tolist()} did not descend")
    print("packed-windowed 100k: " + json.dumps(dict(
        graph=[g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry], seed=BIG[2],
        launches=counts["windowed_take"], launches_expected=_packed_launches(st, cfg),
        chi2=c.tolist(), chi2_take=st_t["chi2_robust"].tolist(), rel_vs_take=rel_take.tolist(),
        breakdown=st["cg_breakdown"].tolist(), breakdown_take=st_t["cg_breakdown"].tolist(),
        ms_per_outer_take=secs_t / cfg.iters * 1e3, max_memory_allocated=peak,
        **_cg_summary(st, cfg, secs))))
    print(f"phase packed-windowed 100k: {time.perf_counter() - t0:.1f} s wall")

    # ---- phase 3b: two_level on the 100k corridor beside block-Jacobi ----
    t0 = time.perf_counter()
    label = "two_level packed-windowed 100k"
    cfg_tl = cfg.replace(preconditioner="two_level")
    torch.cuda.reset_peak_memory_stats()
    _, st_tl, counts_tl, secs_tl = run_packed(torch, solve_packed, g, cfg_tl, counters, label, True)
    peak_tl = torch.cuda.max_memory_allocated()
    launches += counts_tl["windowed_take"]
    _, st_tlt, _, secs_tlt = run_packed(torch, solve_packed, g, cfg_tl.replace(gather="take"),
                                        counters, "two_level packed-take 100k", False)
    c_tl = st_tl["chi2_robust"]
    rel_tl = _hold_trace(c_tl, st_tlt["chi2_robust"], 1, label, "take run")
    if not c_tl[-1] < c_tl[0]:
        raise AssertionError(f"{label}: chi2 {c_tl.tolist()} did not descend")

    print("100k corridor, two_level vs block-Jacobi: " + json.dumps(dict(
        launches=counts_tl["windowed_take"], launches_expected=_packed_launches(st_tl, cfg_tl),
        rel_vs_take=rel_tl.tolist(), ms_per_outer_take=secs_tlt / cfg.iters * 1e3,
        two_level=per_outer_run(st_tl, cfg, secs_tl, peak_tl),
        block_jacobi=per_outer_run(st, cfg, secs, peak))))
    print(f"phase two_level 100k: {time.perf_counter() - t0:.1f} s wall")

    # ---- phase 3c: bband and bf16 coupling storage on the 100k corridor ----
    t0 = time.perf_counter()
    bj = per_outer_run(st, cfg, secs, peak)
    launches += run_bband(torch, solve_packed, g, None, cfg, counters, "100k", 1,
                          dict(block_jacobi=bj))
    launches += run_bf16(torch, solve_packed, g, cfg, counters, "100k", bj, "block_jacobi")
    del g, g2, g100_cpu, pk100
    print(f"phase bband + bf16 100k: {time.perf_counter() - t0:.1f} s wall")

    # ---- phase 4: the default walk (plans refused): packed GN, LM, flat CG, GNC ----
    t0 = time.perf_counter()
    g_cpu, _, _ = _corridor(generate_sequence, build_graph, *WALK)
    g = g_cpu.to(DEV)
    wpk, wmeta = windowed_packing(g_cpu)
    if wmeta.windowed or wpk.p_plan is not None or wpk.l_plan is not None:
        raise AssertionError(f"default walk: the planner did not refuse both grids ({wmeta})")
    for label, fn, cfg in (
            ("packed-take 10k walk (windowed asked, refused)", solve_packed,
             SolverConfig(linear_solver="schur_cg", gather="windowed", iters=10)),
            ("packed-take LM 10k walk", solve_packed,
             SolverConfig(linear_solver="schur_cg", optimizer="lm", iters=10)),
            ("flat schur_cg 10k walk", solve, SolverConfig(linear_solver="schur_cg", iters=10))):
        st_cpu = _stats(fn(g_cpu, cfg)[1])
        _, st, counts, secs = run_packed(torch, fn, g, cfg, counters, label, False)
        c = st["chi2_robust"]
        rel = _hold_trace(c, st_cpu["chi2_robust"], WALK_HELD, label, "CPU")
        if not c[-1] < c[0]:
            raise AssertionError(f"{label}: chi2 {c.tolist()} did not descend")
        print(f"{label}: " + json.dumps(dict(
            launches=counts, held_iterations=WALK_HELD, rel_vs_cpu=rel.tolist(),
            chi2_first=float(st["chi2_robust"][0]), chi2_last=float(st["chi2_robust"][-1]),
            accepted=st["accepted"].astype(int).tolist(), **_cg_summary(st, cfg, secs))))
    g_cpu, _, _ = _corridor(generate_sequence, build_graph, *WALK, loop_closures=8)
    g = g_cpu.to(DEV)
    cfg = SolverConfig(linear_solver="schur_cg", optimizer="lm", iters=10, gnc_kt0=100.0,
                       gnc_anneal_iters=6)
    _, st, counts, secs = run_packed(torch, solve_packed, g, cfg, counters, "GNC LM 8 closures",
                                     False)
    kt_host = np.array([cfg.kt_at(i) for i in range(cfg.iters)], np.float32)
    if not (np.isfinite(st["chi2_robust"]).all() and np.array_equal(st["kt"], kt_host)):
        raise AssertionError(f"GNC LM: chi2 {st['chi2_robust'].tolist()}, kt {st['kt'].tolist()} "
                             f"vs {kt_host.tolist()}")
    print("GNC LM 10k walk 8 loop closures: " + json.dumps(dict(
        launches=counts, kt=st["kt"].tolist(), chi2=st["chi2_robust"].tolist(),
        accepted=st["accepted"].astype(int).tolist(), **_cg_summary(st, cfg, secs))))
    print(f"phase default walk: {time.perf_counter() - t0:.1f} s wall")
    return rows[("landmark grid", 3)], launches


def _held_coarse(label, info, info_ref):
    """The coarse correction's trace against a run from the same state on
    the CPU: the same starting cost, the same first step, a cost that never
    rises, and the rounds up to the first step choice that differs at
    COARSE_RTOL.  Each round re-triangulates the landmarks in f32, and the
    card's sums run in another order than the CPU's: that alone moves a
    round's cost by up to 4.7e-3 at this size and can turn a later round's
    accept-or-stop either way (tools/port_coarse_scan.py)."""
    tr, tr_ref = np.asarray(info["cost_trace"]), np.asarray(info_ref["cost_trace"])
    same = 0
    for a, b in zip(info["alphas"], info_ref["alphas"]):
        if a != b:
            break
        same += 1
    rel = np.abs(tr[:same + 1] - tr_ref[:same + 1]) / tr_ref[:same + 1]
    if not (tr[0] == tr_ref[0] and same >= 1 and info["alphas"][0] is not None
            and (rel < COARSE_RTOL).all() and (np.diff(tr) <= 0).all()):
        raise AssertionError(f"{label}: cost trace {tr.tolist()} alphas {info['alphas']} vs "
                             f"{tr_ref.tolist()} {info_ref['alphas']} (rel {rel.tolist()})")
    return same, rel


def run_survey_phase(torch, counters, build_graph, generate_sequence, SolverConfig, size=SURVEY):
    """pgo_initialize (2 landmark rounds) on the card's graph, held against
    the same call on the CPU's (poses to the bit, landmarks at the
    triangulation bound); one coarse_correct (seg 64, 3 rounds) from its
    result, held against the CPU's from the same state; then packed GNC LM
    under two_level, with the host seconds of each step."""
    from boslam_torch.init.pose_graph import pgo_initialize
    from boslam_torch.solver.coarse import coarse_correct
    from boslam_torch.solver.optimizer import solve_packed

    t0 = time.perf_counter()
    n_poses, n_landmarks, seed, closures = size
    g_cpu, _, _ = _corridor(generate_sequence, build_graph, n_poses, n_landmarks, seed, 50,
                            loop_closures=closures)
    g = g_cpu.to(DEV)
    secs = {}
    t1 = time.perf_counter()
    gp = pgo_initialize(g, landmark_rounds=2)
    torch.cuda.synchronize()
    secs["pgo_card"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    gp_cpu = pgo_initialize(g_cpu, landmark_rounds=2)
    secs["pgo_cpu"] = time.perf_counter() - t1
    lm_gap = (gp.landmarks.cpu() - gp_cpu.landmarks).abs()
    if not (torch.equal(gp.poses.cpu(), gp_cpu.poses) and torch.isfinite(gp.landmarks).all()
            and bool((lm_gap <= 2e-2 + 1e-3 * gp_cpu.landmarks.abs()).all())):
        raise AssertionError(f"pgo_initialize: poses equal {torch.equal(gp.poses.cpu(), gp_cpu.poses)}, "
                             f"landmark gap {lm_gap.max().item():.3e}")
    t1 = time.perf_counter()
    gc, info = coarse_correct(gp, seg=64, rounds=3)
    torch.cuda.synchronize()
    secs["coarse_card"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    _, info_cpu = coarse_correct(gp.to("cpu"), seg=64, rounds=3)  # from the card's state
    secs["coarse_cpu"] = time.perf_counter() - t1
    held, rel = _held_coarse("coarse_correct", info, info_cpu)
    cfg = SolverConfig(linear_solver="schur_cg", optimizer="lm", iters=10, cg_iters=100,
                       cg_tol=1e-3, cg_warm_start=True, preconditioner="two_level",
                       kernel_threshold=100.0, gnc_kt0=1e6, gnc_anneal_iters=30)
    _, st, counts, secs_lm = run_packed(torch, solve_packed, gc, cfg, counters,
                                        "GNC LM two_level 10k", False)
    c = st["chi2_robust"]
    if not (np.isfinite(c).all() and c[-1] < c[0]):
        raise AssertionError(f"GNC LM two_level: chi2 {c.tolist()} did not descend")
    secs["gnc_lm_card"] = secs_lm
    print(f"survey {n_poses} poses {closures} loop closures: " + json.dumps(dict(
        graph=[g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry], seed=seed,
        pgo_poses_bitwise_vs_cpu=True, pgo_landmark_gap=lm_gap.max().item(),
        coarse_cost_trace=info["cost_trace"], coarse_alphas=info["alphas"],
        coarse_cost_trace_cpu=info_cpu["cost_trace"], coarse_alphas_cpu=info_cpu["alphas"],
        coarse_rounds_held=held, coarse_rel_vs_cpu=rel.tolist(), launches=counts,
        chi2=c.tolist(), accepted=st["accepted"].astype(int).tolist(), kt=st["kt"].tolist(),
        host_seconds=secs, **_cg_summary(st, cfg, secs_lm))))
    print(f"phase survey: {time.perf_counter() - t0:.1f} s wall")


def run_autodiff_backend_phase(torch, solve, g, counters, runs):
    """Autodiff Jacobians and the cholesky_backend switch at 301/141.

    The Jacobians on the graph's state against the analytic ones (within
    1e-5 of the largest entry); GN-schur 50 (fused off) and GN-dense 50
    with autodiff, and under cholesky_backend "xla" and "pallas", each
    against the analytic "auto" run of this call (``runs``: label ->
    chi2 trace) at rel 1e-4 after 50, with its launches: autodiff and
    "pallas" take the Schur kernel (schur) and the Cholesky kernel (dense)
    50 times, "xla" neither.  Returns {label: launches}."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver.normal_eq import edge_terms

    t0 = time.perf_counter()
    cfg_s = SolverConfig(linear_solver="schur", fused_step="off", iters=ITERS)
    t_an = edge_terms(g, cfg_s)
    t_ad = edge_terms(g, cfg_s.replace(use_autodiff_jacobians=True))
    jac_err = {}
    for name in ("bjp", "bjl", "ojs", "ojd"):
        a, b = getattr(t_ad, name), getattr(t_an, name)
        jac_err[name] = ((a - b).abs().max() / b.abs().max()).item()
    if not max(jac_err.values()) < 1e-5:
        raise AssertionError(f"autodiff Jacobians: {jac_err}")
    print("autodiff Jacobians vs analytic, max |diff| / max |analytic|: " + json.dumps(jac_err))
    launches = {}
    for ls in ("schur", "dense"):
        base = cfg_s.replace(linear_solver=ls)
        for label, cfg, want_kernel in (
                ("autodiff", base.replace(use_autodiff_jacobians=True), True),
                ("cholesky_backend xla", base.replace(cholesky_backend="xla"), False),
                ("cholesky_backend pallas", base.replace(cholesky_backend="pallas"), True)):
            label = f"gn-{ls} {label}"
            _, st, counts, secs = _run_path(torch, solve, g, cfg, counters)
            if not want_kernel:
                want = _want(counts)
            elif ls == "schur":
                want = _want(counts, schur=ITERS, schur_band=ITERS)
            else:
                want = _want(counts, cholesky=ITERS)
            c, ref = st["chi2_robust"], runs[f"gn-{ls}"]
            rel = abs(c[-1] - ref[-1]) / ref[-1]
            if counts != want or not (st["spd_ok"].all() and c[-1] < c[0] and rel < 1e-4):
                raise AssertionError(f"{label}: launches {counts} (want {want}), chi2 {c[0]} -> "
                                     f"{c[-1]}, analytic auto {ref[-1]} (rel {rel:.2e})")
            print(f"{label}: " + json.dumps(dict(
                launches=counts, chi2_final=float(c[-1]), chi2_final_auto=float(ref[-1]),
                rel_vs_auto=float(rel), ms_per_iter_first_run=secs / ITERS * 1e3)))
            launches[label] = counts
    print(f"phase autodiff + cholesky_backend: {time.perf_counter() - t0:.1f} s wall")
    return launches


def run_native_phase(generate_sequence, size=BIG):
    """The native g2o tokenizer on the 100k corridor's g2o: built here with
    g++, arrays equal to the Python parser's, and both parsers' host
    seconds."""
    import tempfile

    from boslam_torch.io import native
    from boslam_torch.io.g2o import parse_g2o, write_g2o

    t0 = time.perf_counter()
    n_poses, n_landmarks, seed, turn_every = size
    ig, _ = generate_sequence(n_poses, n_landmarks, seed=seed, turn_every=turn_every)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/corridor.g2o"
        write_g2o(path, ig.pose_ids, ig.pose_xyt, ig.lm_ids, ig.lm_xy, parsed=ig,
                  fixed_pose_id=ig.fixed_pose_id)
        t1 = time.perf_counter()
        native.build()
        build_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        a = parse_g2o(path, use_native=True)
        native_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        b = parse_g2o(path, use_native=False)
        python_s = time.perf_counter() - t1
    same = (a.pose_ids == b.pose_ids and a.lm_ids == b.lm_ids
            and a.fixed_pose_id == b.fixed_pose_id and abs(a.bound - b.bound) < 1e-4)
    for name in ("pose_xyt", "lm_xy", "bearing_pose_id", "bearing_lm_id", "bearing_meas",
                 "bearing_omega", "odom_src_id", "odom_dst_id", "odom_meas", "odom_omega"):
        x, y = getattr(a, name), getattr(b, name)
        same = same and x.dtype == y.dtype and np.array_equal(x, y)
    if not same:
        raise AssertionError("native g2o parser: arrays differ from the Python parser's")
    print(f"native g2o parser {n_poses} poses: " + json.dumps(dict(
        edges=int(len(a.bearing_meas) + len(a.odom_meas)), equal_to_python=True,
        build_seconds=build_s, native_seconds=native_s, python_seconds=python_s)))
    print(f"phase native parser: {time.perf_counter() - t0:.1f} s wall")


def run_resume_phase(torch, solve, g, cfg, counters, meta):
    """Resume on the card: gn-fused 10 straight against 5, save_npz,
    load_npz into a fresh graph, 5 more: the same bits."""
    import tempfile

    from boslam_torch.io.checkpoint import load_npz, save_npz

    cfg = cfg.replace(iters=10)
    g10, st10, counts10, _ = _run_path(torch, solve, g, cfg, counters)
    g5, st5a, _, _ = _run_path(torch, solve, g, cfg.replace(iters=5), counters)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/state.npz"
        save_npz(path, g5, meta, iteration=5)
        blank = g.with_state(torch.zeros_like(g.poses), torch.zeros_like(g.landmarks))
        g_r, _, it, _, _ = load_npz(path, blank, meta)
    g_r10, st5b, counts5b, _ = _run_path(torch, solve, g_r, cfg.replace(iters=5), counters)
    trace = np.concatenate([st5a["chi2_robust"], st5b["chi2_robust"]])
    if not (it == 5 and torch.equal(g_r10.poses, g10.poses)
            and torch.equal(g_r10.landmarks, g10.landmarks)
            and np.array_equal(trace, st10["chi2_robust"]) and counts5b["gn_step"] == 5):
        raise AssertionError(f"resume: chi2 {trace.tolist()} vs {st10['chi2_robust'].tolist()}, "
                             f"launches {counts5b}")
    print("resume gn-fused 5 + save_npz + load_npz + 5 vs 10: " + json.dumps(dict(
        bitwise=True, launches_straight=counts10, launches_resumed=counts5b,
        chi2_final=float(trace[-1]))))


def run_bench_phase(torch, generate_sequence, chi2_fused):
    """``python -m boslam_torch bench`` on the 301/141 seed-3 graph's g2o,
    as a subprocess: its one JSON line, and its chi2 against gn-fused's."""
    import os
    import tempfile

    from boslam_torch.io.g2o import write_g2o

    t0 = time.perf_counter()
    ig, _ = generate_sequence(301, 141, seed=SEED)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/ref_size.g2o"
        write_g2o(path, ig.pose_ids, ig.pose_xyt, ig.lm_ids, ig.lm_xy, parsed=ig,
                  fixed_pose_id=ig.fixed_pose_id)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-m", "boslam_torch", "bench", path, "--linear-solver",
                              "schur", "--iters", str(ITERS)], cwd=root, env=env,
                             capture_output=True, text=True, timeout=300)
        prof_dir = f"{d}/profile"
        t1 = time.perf_counter()
        prof = subprocess.run([sys.executable, "-m", "boslam_torch", "solve", path,
                               "--linear-solver", "schur", "--iters", "5", "--profile", prof_dir],
                              cwd=root, env=env, capture_output=True, text=True, timeout=300)
        prof_s = time.perf_counter() - t1
        if prof.returncode != 0:
            raise AssertionError(f"solve --profile: exit {prof.returncode}: {prof.stderr[-2000:]}")
        from boslam_torch.utils.profiling import TRACE_FILE

        with open(f"{prof_dir}/{TRACE_FILE}") as f:
            events = json.load(f)["traceEvents"]
        kernels = sorted({k for e in events if e.get("cat") == "kernel"
                          for k in PORT_KERNELS if k in str(e.get("name", ""))})
        if "gn_edge_kernel" not in kernels:
            raise AssertionError(f"solve --profile: the trace names none of the whole step's "
                                 f"kernels ({kernels})")
        print(f"solve --profile ({prof_s:.1f} s wall): " + json.dumps(dict(
            trace_events=len(events), port_kernels_in_trace=kernels)))
    if out.returncode != 0:
        raise AssertionError(f"bench: exit {out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    rel = abs(rec["final_chi2"] - chi2_fused) / chi2_fused
    if not (len(lines) == 1 and rec["iters"] == ITERS and rel < 1e-4):
        raise AssertionError(f"bench: {out.stdout!r}, gn-fused chi2 {chi2_fused}")
    print(f"bench (python -m boslam_torch bench, {time.perf_counter() - t0:.1f} s wall): "
          + lines[-1])


# PERF.md section 6's bounds of the four kernels on an H100 SXM (67 TFLOP/s
# f32, 3.35 TB/s), to three significant figures: the Cholesky at the graph's
# dense system (n = 1280), the Schur solve and the whole step on the
# 301/141 graph's envelope, the gather on the 100k corridor's landmark grid
TABLE_BOUNDS_SXM = {"cholesky_solve_padded": 0.0105, "fused_schur_solve_blocks": 0.0000423,
                    "fused_gn_step": 0.0000497, "windowed_take": 0.00478}
# the kernel each A/B path launches, 50 times in a run; the CG paths none
AB_LAUNCHES = {"dense": "cholesky", "schur": "schur", "schur_fused": "gn_step"}


def _tool(name):
    """A module of tools/ by file (tools/ is no package)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_measurement_phase(torch, counters, g, g_cpu, chi2_cpu, bounds):
    """The measurement layer on the card: ``chip_spec()`` beside
    nvidia-smi; the kernels' bounds (``bounds``, computed by
    ``utils/roofline``) against the kernel table's on an H100 SXM;
    ``boslam_torch.bench``'s main path (its JSON line, the chi2 check,
    0 < roofline_util <= 1.05, 50 whole-step launches per run);
    ``tools/port_headline_ab.py``'s six paths at one repeat on the 301/141
    graph (the CG paths without their first run), each held to the CPU (``chi2_cpu``: the CPU references the
    script already has) with its kernel's launches; and
    ``tools/port_scaling_bench.py`` config 4 with its roofline."""
    from boslam_torch import bench
    from boslam_torch.utils import roofline

    t0 = time.perf_counter()
    spec = roofline.chip_spec()
    print("measurement: chip_spec() " + json.dumps(spec._asdict()) + f" beside nvidia-smi: "
          f"{_card_line()}")
    print("measurement: kernel bounds (ms) from utils/roofline on this card: " + json.dumps(bounds))
    if spec.name == "NVIDIA H100 SXM":
        table = {k: float(f"{v:.3g}") for k, v in bounds.items()}
        if table != TABLE_BOUNDS_SXM:
            raise AssertionError(f"measurement: bounds {table} differ from the kernel table's "
                                 f"{TABLE_BOUNDS_SXM}")

    for fn in counters.values():
        fn.launches = 0
    rec, info = bench.run("cuda")
    runs = 1 + len(info["times_s"])
    launches = {k: fn.launches for k, fn in counters.items()}
    util = rec["roofline_util"]
    if not (set(bench.KEYS) <= set(rec) and rec["chi2_check"]["passed"]
            and util is not None and 0 < util <= 1.05
            and launches == _want(launches, gn_step=bench.ITERS * runs)):
        raise AssertionError(f"measurement bench: {rec}, launches {launches} over {runs} runs")
    print(f"measurement bench (boslam_torch.bench.run, {runs} runs of {bench.ITERS}, launches "
          f"{launches}): " + json.dumps(rec))

    ab = _tool("port_headline_ab")
    # every kernel is built and every path has run by now: the three CG
    # paths, which build none, run once, without the untimed first run
    results = ab.run_paths(g, g_cpu, repeats=1, spec=spec, chi2_cpu=chi2_cpu, cg_warmup=False)
    bad = ab.failures(results)
    for name, r in results.items():
        if "error" in r:
            continue
        want = _want(r["launches"], **({AB_LAUNCHES[name]: ab.ITERS} if name in AB_LAUNCHES
                                      else {}))
        # the JAX tool's models: all but dense read packed_outer_model, which
        # at cg 0 (the direct Schur paths) counts the build only, so their
        # share may round to 0
        if r["launches"] != want or not 0 <= r["model_util"] <= 1.05:
            bad.append(name)
        print(f"measurement headline_ab {name}: " + json.dumps(r))
    if bad:
        raise AssertionError(f"measurement headline_ab: {bad} failed, missed the CPU's chi2 or "
                             f"launched other kernels: {results}")

    sb = _tool("port_scaling_bench")
    r4 = sb.config_4_5(4, torch.device(DEV), spec=spec)
    roof = r4["roofline"]
    if not (r4["chi2_after"] < r4["chi2_initial"] and r4["tol_controlled"]["chi2_after"]
            < r4["chi2_initial"] and 0 < roof["roofline_util"] <= 1.05):
        raise AssertionError(f"measurement scaling config 4: {r4}")
    print("measurement scaling_bench config 4: " + json.dumps(r4))
    print(f"phase measurement: {time.perf_counter() - t0:.1f} s wall")


# The trace + split phase (PERF.md section 6): tools/port_trace_validate.py's
# dense and schur chains at 301/141 for TRACE_ITERS steps and its packed
# chain on the 10k default walk for TRACE_PACKED[1] outer steps; then
# tools/port_packed_split_probe.py on the walk at each of SPLIT_SIZES
TRACE_ITERS = 30
TRACE_PACKED = (10000, 5)
SPLIT_SIZES = (10000, 100000)
# launches of the port's kernels per step in each path's trace: the
# Cholesky once (dense), the whole step's pipeline on the band route (schur)
TRACE_LAUNCHES = {"dense": 1, "schur": 8, "packed": 0}
# each chain's final chi2 against the same chain on the CPU.  The packed
# chain's truncated f32 CG parts two orders of the same sums (the card's
# segment sums use atomics) by 0.8e-4 to 2.2e-4 after 5 outers on the H100
# (PERF.md section 6), so it is held at the walk's bound past its first
# step (WALK_HELD)
TRACE_CHI2_RTOL = {"dense": 1e-4, "schur": 1e-4, "packed": 2e-3}
# the span is read on the device's clock (CUPTI's timestamps), the wall on
# the host's: on the H100 the span of a run read up to 1.0e-4 longer than
# the wall around it (0.26 ms over 2558 ms), so span <= wall is held to this
# share of the wall
CLOCK_RTOL = 1e-3
# a phase's CUDA-graph replay against its eager time: the replay drops the
# host's launches, so it may not be slower than the eager run beyond noise
REPLAY_SLACK = 1.10


def run_trace_split_phase(torch, g_cpu):
    """The trace of each solver path and the split of the packed outer on
    the card.  ``tools/port_trace_validate.py``: each chain from the CPU
    graph's state, under sync-debug mode "error", holding exact launch
    counts of the port's kernels in the trace (``TRACE_LAUNCHES``; schur on
    the band route), 0 < busy <= span <= the profiled wall (``CLOCK_RTOL``),
    and the final chi2 within ``TRACE_CHI2_RTOL`` of the same chain on the
    CPU.
    ``tools/port_packed_split_probe.py`` at ``SPLIT_SIZES``, both
    preconditioners, each size in a process of its own (in this one, after
    the earlier phases, its short profiler sessions came back empty three
    times running on the H100; PERF.md section 7): every time positive, the
    matvec and the apply captured, and every replay within
    ``REPLAY_SLACK`` of its eager time."""
    import os
    import tempfile

    from boslam_torch.bench import final_chi2
    from boslam_torch.utils import roofline

    t0 = time.perf_counter()
    tv = _tool("port_trace_validate")
    spec = roofline.chip_spec()
    walk_cpu = tv.walk_graph(TRACE_PACKED[0], "cpu")
    bad = []
    for name, gc, iters in (("dense", g_cpu, TRACE_ITERS), ("schur", g_cpu, TRACE_ITERS),
                            ("packed", walk_cpu, TRACE_PACKED[1])):
        g_card = gc.to(DEV)
        torch.cuda.set_sync_debug_mode("error")
        try:
            rec = tv.trace_path(name, g_card, iters, spec)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        chain = tv.Chain(name, gc)
        rec["chi2_final_cpu"] = final_chi2(chain.run(iters), chain.cfg)
        rec["chi2_rel_vs_cpu"] = abs(rec["chi2_final"] - rec["chi2_final_cpu"]) / rec["chi2_final_cpu"]
        tr = rec["trace"]
        if not (tr["port_kernel_launches"] == TRACE_LAUNCHES[name] * iters
                and (name != "schur" or rec["route"] == "band")
                and (name != "dense" or rec["kernel_work"]["launches"] == iters)
                and 0 < tr["device_time_ms"] <= tr["device_span_ms"]
                <= tr["profiled_wall_ms"] * (1 + CLOCK_RTOL)
                and rec["chi2_rel_vs_cpu"] < TRACE_CHI2_RTOL[name]):
            bad.append(name)
        print(f"trace {name}: " + json.dumps(rec))
    del walk_cpu
    t_trace = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    for n in SPLIT_SIZES:
        with tempfile.TemporaryDirectory() as d:
            out = subprocess.run([sys.executable, os.path.join(root, "tools",
                                                               "port_packed_split_probe.py"),
                                  str(n), "--json-out", f"{d}/split.json"], cwd=root,
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"split probe {n}: exit {out.returncode}: "
                                     f"{out.stderr[-2000:]}")
            with open(f"{d}/split.json") as f:
                results = json.load(f)["results"]
        for line in out.stdout.splitlines():
            print(f"split {line}")
        for which, r in results.items():
            eager, replay = r["eager_ms"], r["replay_ms"]
            if not (all(v > 0 for v in eager.values())
                    and all(isinstance(replay[k], float) for k in ("matvec", "apply"))
                    and all(0 < v <= REPLAY_SLACK * eager[k] for k, v in replay.items()
                            if isinstance(v, float))):
                bad.append(f"split {which} {n}")
            print(f"split {which} n={n}: " + json.dumps(r))
    if bad:
        raise AssertionError(f"trace + split: {bad} failed their checks (records above)")
    print(f"trace + split: the traces and their CPU chains {t_trace:.1f} s, the split probe "
          f"{time.perf_counter() - t0 - t_trace:.1f} s")
    print(f"phase trace + split: {time.perf_counter() - t0:.1f} s wall")


def _graph_bytes(g):
    return sum(t.numel() * t.element_size()
               for t in (getattr(g, f.name) for f in dataclasses.fields(g)))


def _matvec_bytes(mesh, fn):
    """Collective bytes of one CG matvec (``fn``), by kind."""
    mesh.reset_counts()
    fn()
    return {k: v for k, v in mesh.bytes.items() if v}


def range_pieces(torch, g, cfg, mesh):
    """Pose-range's pieces on ``mesh`` (one rank) beside the single-device
    packed path's (plain gathers, no hot-landmark rows) at ``g``'s state
    and ``cfg``'s first damping, as norm-relative gaps.

    Against the packed path: the damped blocks, one S matvec on a random
    vector, the chain band and the preconditioner's apply.  diag(S) and
    the block-Jacobi apply cancel (Hpp - B Hll^-1 B^T nears zero on a pose
    whose landmarks it alone observes), so both paths' are also taken
    against an f64 evaluation from the same f32 blocks (``*_f64``, the
    packed path's beside it).  The first CG solve: its relative residual
    squared as CG reports it and as the packed path's matvec measures it
    at its delta, for both paths.  Runs on ``g``'s device;
    ``tools/port_packed_scan.py --what pose_range`` runs it on the CPU."""
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.parallel.pose_range import (
        _local_mask, _range_build, _range_matvec, _range_s_diag, _range_two_level,
        prepare_pose_range, range_build_and_solve)
    from boslam_torch.solver import schur, schur_packed as sp

    def gap(a, b):
        return float(torch.linalg.norm((a.double() - b.double()))
                     / torch.linalg.norm(b.double()))

    def apply(precond, r):
        return precond(r) if callable(precond) else torch.einsum("pij,pj->pi", precond, r)

    damping = cfg.damping if cfg.optimizer == "gn" else cfg.lm_lambda0
    sh, meta = prepare_pose_range(g, mesh)
    pk, _ = pack_edges(g, split_lm=0)
    br, _ = _range_build(sh, cfg, damping, meta, mesh)
    bp, _ = sp.build_packed_blocks(g, pk, cfg, damping)
    gaps = {f: gap(getattr(br, f), getattr(bp, f))
            for f in ("Hpp_diag", "bp", "Hll_inv", "bl", "Bp", "Bl")}
    NP_ = g.n_poses
    mask_r = _local_mask(sh, meta, mesh)
    mask = schur._pose_mask(NP_, g.fixed_pose_ix, g.poses.dtype)

    def matvec(x):
        return sp.packed_s_matvec(bp, pk, x, mask)

    gen = torch.Generator(device=g.device).manual_seed(0)
    x = torch.randn((NP_, 3), generator=gen, device=g.device)
    gaps["matvec"] = gap(_range_matvec(br, sh, x, mask_r, meta, mesh), matvec(x))
    gaps["chain_band"] = gap(br.Ho[1:NP_], sp._chain_band(bp, pk, NP_))
    B64 = bp.Bp.double()
    s64 = bp.Hpp_diag.double() - torch.einsum("pkij,pkjl,pkml->pim", B64,
                                              bp.Hll_inv.double()[pk.p_lm], B64)
    d_r = _range_s_diag(br, sh, mesh)
    gaps["s_diag"] = gap(d_r, sp.packed_s_diag(bp, pk))
    gaps["s_diag_f64"] = gap(d_r, s64)
    gaps["s_diag_packed_f64"] = gap(sp.packed_s_diag(bp, pk), s64)
    eye3 = torch.eye(3, dtype=d_r.dtype, device=d_r.device)
    d = mask_r[..., None] * d_r + (1.0 - mask_r[..., None]) * eye3
    precond = (_range_two_level(br, sh, d, mask_r, meta, mesh, cfg)
               if cfg.preconditioner == "two_level" else schur._inv3x3(d))
    precond_p = sp._packed_preconditioner(bp, pk, cfg, mask)
    gaps["precond_apply"] = gap(apply(precond, x * mask_r), apply(precond_p, x * mask))
    if cfg.preconditioner != "two_level":
        d64 = mask.double()[..., None] * s64 + (1.0 - mask.double()[..., None]) * eye3.double()
        y64 = torch.linalg.solve(d64, (x * mask).double())
        gaps["precond_apply_f64"] = gap(apply(precond, x * mask_r), y64)
        gaps["precond_apply_packed_f64"] = gap(apply(precond_p, x * mask), y64)
    # the first CG solve of each path, its residual measured by one matvec
    w0 = torch.einsum("lij,lj->li", bp.Hll_inv, bp.bl)
    rhs = (-bp.bp + torch.einsum("pkij,pkj->pi", bp.Bp, w0[pk.p_lm])) * mask
    for name, (dp, _, st, _) in (
            ("range", range_build_and_solve(sh, cfg, damping, meta, mesh)),
            ("packed", sp.schur_packed_build_and_solve(g, pk, cfg, damping))):
        r = rhs - matvec(dp)
        gaps[f"cg_rel_res2_{name}"] = float(st["cg_rel_res2"])
        gaps[f"true_rel_res2_{name}"] = float(torch.sum(r.double() ** 2)
                                              / torch.sum(rhs.double() ** 2))
    return gaps


def _range_failures(pieces, rel_t, cfg):
    """The names of ``range_pieces``' gaps (and "first_step", the chi2
    after it against the take run) outside their bounds."""
    failed = [k for k in RANGE_EXACT if not pieces[k] < RANGE_PIECE_RTOL]
    pairs = [("s_diag_f64", "s_diag_packed_f64"), ("true_rel_res2_range", "cg_rel_res2_range")]
    if cfg.preconditioner == "two_level":
        failed += [k for k, v, bound in (("precond_apply", pieces["precond_apply"],
                                          RANGE_TWO_LEVEL_APPLY),
                                         ("first_step", rel_t[1], RANGE_FIRST_STEP))
                   if not v < bound]
    else:
        pairs.append(("precond_apply_f64", "precond_apply_packed_f64"))
    return failed + [a for a, b in pairs
                     if not pieces[a] <= RANGE_RATIO * pieces[b] + RANGE_PIECE_RTOL]


def _collective_ms(torch, mesh, reps=200):
    """Host ms per call of each collective at world size 1, by CUDA-synced
    wall clock over ``reps`` calls: psum of 1 float (a CG dot) and of the
    packed 10k matvec's 37730, pmax of a flag (the CG poll), all_gather of
    pose-range's 100k matvec vector (300000 floats), psum_scatter of the
    20k closures' 240000 bytes.  Returns (the readings, ms by kind: the
    larger psum reading)."""
    calls = {"psum 1": (mesh.psum, 1), "psum 37730": (mesh.psum, 37730),
             "pmax 1": (mesh.pmax, 1), "all_gather 300000": (mesh.all_gather, 300000),
             "psum_scatter 60000": (mesh.psum_scatter, 60000)}
    out = {}
    for name, (fn, n) in calls.items():
        x = torch.zeros(n, device=mesh.device)
        fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    by_kind = {"psum": max(out["psum 1"], out["psum 37730"]), "pmax": out["pmax 1"],
               "all_gather": out["all_gather 300000"],
               "psum_scatter": out["psum_scatter 60000"]}
    return out, by_kind


def _mesh_run(torch, solve, g, cfg, counters, mesh, label, want, per_call_ms=None):
    """One multi-device run on the card with every count at 0: its launches
    against ``want`` (every other kernel 0), its collectives' bytes, ms per
    outer iteration and peak memory; with ``per_call_ms`` (host ms per call
    by kind) the collectives' estimated share of the wall time."""
    mesh.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    g2, st, counts, secs = _run_path(torch, solve, g, cfg, counters)
    peak = torch.cuda.max_memory_allocated()
    expected = _want(counts, **want)
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected}")
    if not np.isfinite(st["chi2_robust"]).all():
        raise AssertionError(f"{label}: chi2 {st['chi2_robust'].tolist()}")
    run = dict(launches=counts, ms_per_outer=secs / cfg.iters * 1e3, peak_mb=peak / 2**20,
               collective_bytes=dict(mesh.bytes), collective_calls=dict(mesh.calls))
    if per_call_ms is not None:  # the calls' host time at their measured cost
        est = sum(n * per_call_ms[k] for k, n in mesh.calls.items())
        run.update(collective_host_ms_estimate=est, collective_share_of_wall=est / (secs * 1e3))
    return g2, st, run


def run_multi_device_phase(torch, counters, g, g_cpu, single, generate_sequence, build_graph,
                           SolverConfig):
    """Slice 8: the three multi-device layouts at world size 1 under NCCL.
    ``single`` maps "gn-dense", "gn-schur", "lm-schur" to (the card's
    single-device stats, the CPU's stats, cfg).  Returns the Cholesky
    kernel's launches on the sharded runs."""
    import os
    import tempfile

    import torch.distributed as dist

    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.io.g2o import write_g2o
    from boslam_torch.parallel.mesh import make_mesh
    from boslam_torch.parallel.pose_range import (
        _local_mask, _range_build, _range_matvec, make_pose_range_solve, pose_range_solve,
        prepare_pose_range)
    from boslam_torch.parallel.sharded import shard_graph, sharded_solve
    from boslam_torch.parallel.sharded_packed import (
        make_sharded_packed_solve, shard_packed, sharded_packed_solve)
    from boslam_torch.solver import schur, schur_packed as sp
    from boslam_torch.solver.optimizer import solve_packed

    t0 = time.perf_counter()
    mesh = make_mesh(DEV)  # NCCL; its communicator is set up here, before any solve
    if (mesh.backend, mesh.size) != ("nccl", 1):
        raise AssertionError(f"mesh: {mesh.backend} over {mesh.size} rank(s)")
    chol_launches = {}
    # what one collective call costs the host at one rank, at the layouts' sizes
    readings, per_call = _collective_ms(torch, mesh)
    print("collective host ms per call: " + json.dumps(readings))

    # ---- edge-sharded flat at 301/141: the Cholesky kernel on every rank ----
    gs = shard_graph(g, mesh)
    for label, (st1, st_cpu, cfg) in single.items():
        name = f"sharded {label}"
        _, st, run = _mesh_run(torch, lambda gg, c: sharded_solve(gg, c, mesh), g, cfg, counters,
                               mesh, name, {"cholesky": cfg.iters}, per_call)
        chol_launches[name] = run["launches"]["cholesky"]
        c = st["chi2_robust"]
        rel1 = _rel_trace(c, st1["chi2_robust"])
        relc = _rel_trace(c, st_cpu["chi2_robust"])
        # converged: GN and LM run 50 (LM's chi2 after 10 trials moves by
        # up to 2.6e-4 between runs on the card, and the CPU's LM rejects
        # trials the card accepts, 2.59 against 0.306 there: PERF.md)
        if not (rel1[-1] < 1e-4 and relc[-1] < 1e-4 and st["spd_ok"].all() and c[-1] < c[0]):
            raise AssertionError(f"{name}: chi2 {c.tolist()}, single device "
                                 f"{st1['chi2_robust'].tolist()}, CPU {st_cpu['chi2_robust'].tolist()}")
        print(f"{name}: " + json.dumps(dict(
            chi2_first=float(c[0]), chi2_last=float(c[-1]),
            chi2_last_single_device=float(st1["chi2_robust"][-1]),
            chi2_last_cpu=float(st_cpu["chi2_robust"][-1]), rel_last_vs_single=float(rel1[-1]),
            rel_last_vs_cpu=float(relc[-1]), accepted=int(st["accepted"].sum()),
            shard_bytes_per_rank=_graph_bytes(gs),
            collective_bytes_per_outer={k: v / cfg.iters for k, v in run["collective_bytes"].items()
                                        if v}, **run)))
    print(f"phase sharded flat 301/141: {time.perf_counter() - t0:.1f} s wall")

    # ---- edge-sharded packed on the 10k corridor, plain gathers ----
    t0 = time.perf_counter()
    g10_cpu, _, _ = _corridor(generate_sequence, build_graph, *MID)
    g10 = g10_cpu.to(DEV)
    pk10, _ = pack_edges(g10_cpu)
    gs10, pks10 = shard_packed(g10_cpu, pk10, mesh)
    for label, cfg, held in (
            ("GN 10 btridiag", SolverConfig(linear_solver="schur_cg", iters=10,
                                            preconditioner="btridiag"), 10),
            ("LM 5 warm start", SolverConfig(linear_solver="schur_cg", iters=5, optimizer="lm",
                                             cg_warm_start=True), 2)):
        name = f"sharded packed 10k {label}"
        _, st1, counts1, secs1 = _run_path(torch, solve_packed, g10, cfg.replace(gather="take"),
                                           counters)
        _, st, run = _mesh_run(torch, lambda gg, c: sharded_packed_solve(gg, c, mesh), g10, cfg,
                               counters, mesh, name, {}, per_call)
        rel = _hold_trace(st["chi2_robust"], st1["chi2_robust"], held, name, "take run")
        bl, _ = sp.build_packed_blocks(gs10, pks10, cfg, cfg.damping, mesh=mesh)
        mask = schur._pose_mask(g10.n_poses, g10.fixed_pose_ix, torch.float32)
        per_mv = _matvec_bytes(mesh, lambda: sp.packed_s_matvec(
            bl, pks10, torch.ones((g10.n_poses, 3), device=DEV), mask, mesh=mesh))
        shard = _graph_bytes(gs10) + sum(getattr(pks10, f).numel() * 4 for f in (
            "p_lm", "p_meas", "p_omega", "l_pose", "l_meas", "l_omega"))
        if cfg.optimizer == "gn":  # the loop's time by kernel, apart from the preparation
            run["profile"] = profile_path(
                lambda gg, c: make_sharded_packed_solve(mesh, c)(gs10, pks10), g10, cfg,
                iters=2)
        print(f"{name}: " + json.dumps(dict(
            held_iterations=held, rel_vs_take=rel.tolist(), chi2=st["chi2_robust"].tolist(),
            chi2_take=st1["chi2_robust"].tolist(), ms_per_outer_take=secs1 / cfg.iters * 1e3,
            cg_iters=st["cg_iters"].tolist(), breakdowns=int(st["cg_breakdown"].sum()),
            accepted=int(st["accepted"].sum()), shard_bytes_per_rank=shard,
            collective_bytes_per_cg_matvec=per_mv, **run)))
    del gs10, pks10
    print(f"phase sharded packed 10k: {time.perf_counter() - t0:.1f} s wall")

    # ---- pose-range: the 100k corridor, and POSE_RANGE_r05.json's configuration ----
    t0 = time.perf_counter()
    mesh_cpu = make_mesh("cpu")  # gloo, for the CPU reference
    g100_cpu, _, _ = _corridor(generate_sequence, build_graph, *BIG)
    n, nl, seed, lc = POSE_RANGE_R05
    ig20, _ = generate_sequence(n, nl, seed=seed, loop_closures=lc)
    g20_cpu, _ = build_graph(ig20, init="triangulate", device="cpu")
    for label, g_cpu_r, cfg, ref_chi2 in (
            ("100k corridor GN 5 block-Jacobi", g100_cpu,
             SolverConfig(linear_solver="schur_cg", iters=5, preconditioner="block_jacobi",
                          lm_split=0), None),
            (f"{n // 1000}k, {lc} closures, LM 3 two_level (POSE_RANGE_r05)", g20_cpu,
             SolverConfig(linear_solver="schur_cg", iters=3, optimizer="lm", cg_tol=1e-7,
                          cg_iters=60, lm_split=0, cg_warm_start=True,
                          preconditioner="two_level"), POSE_RANGE_R05_JAX_CHI2)):
        name = f"pose-range {label}"
        gd = g_cpu_r.to(DEV)
        _, st, run = _mesh_run(torch, lambda gg, c: pose_range_solve(gg, c, mesh), gd, cfg,
                               counters, mesh, name, {}, per_call)
        c = st["chi2_robust"]
        # the single-device packed path on the same system (plain gathers, no
        # hot-landmark rows): the first step, and the pieces of the first build
        _, st_t, _, secs_t = _run_path(torch, solve_packed, gd, cfg.replace(gather="take"),
                                       counters)
        rel_t = _rel_trace(c, st_t["chi2_robust"])
        pieces = range_pieces(torch, gd, cfg, mesh)
        # iteration 0 against the port's CPU pose-range run (its chi2 before the first step)
        c_cpu = pose_range_solve(g_cpu_r, cfg.replace(iters=1, cg_iters=1), mesh_cpu)[1]
        rel0 = _rel_trace(c[:1], c_cpu["chi2_robust"].numpy()[:1])
        failed = _range_failures(pieces, rel_t, cfg)
        if failed or not (rel0[0] < 1e-5 and rel_t[0] < 1e-5 and c[-1] < c[0]
                          and st["spd_ok"].all()):
            raise AssertionError(f"{name}: failed {failed}, chi2 {c.tolist()}, take run "
                                 f"{st_t['chi2_robust'].tolist()}, CPU iteration 0 "
                                 f"{float(c_cpu['chi2_robust'][0])}, pieces {pieces}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sh, meta = prepare_pose_range(gd, mesh)  # the once-per-solve preparation
        torch.cuda.synchronize()
        prep_ms = (time.perf_counter() - t1) * 1e3
        bl, _ = _range_build(sh, cfg, cfg.damping, meta, mesh)
        per_mv = _matvec_bytes(mesh, lambda: _range_matvec(
            bl, sh, torch.ones_like(sh.poses), _local_mask(sh, meta, mesh), meta, mesh))
        rec = dict(graph=[gd.n_poses, gd.n_landmarks, gd.n_bearing, gd.n_odometry],
                   rel_iteration0_vs_cpu=float(rel0[0]), rel_vs_take=rel_t.tolist(),
                   pieces=pieces, first_step_held=cfg.preconditioner == "two_level",
                   chi2=c.tolist(), chi2_take=st_t["chi2_robust"].tolist(),
                   cg_iters=st["cg_iters"].tolist(), cg_iters_take=st_t["cg_iters"].tolist(),
                   breakdown=st["cg_breakdown"].astype(int).tolist(),
                   breakdown_take=st_t["cg_breakdown"].astype(int).tolist(),
                   accepted=int(st["accepted"].sum()), ms_per_outer_take=secs_t / cfg.iters * 1e3,
                   prepare_ms=prep_ms, shard_bytes_per_rank=sh.nbytes(),
                   collective_bytes_per_cg_matvec=per_mv,
                   collective_bytes_per_cg_matvec_formula=12 * meta.np_pad + 8 * meta.nl_pad,
                   **run)
        if ref_chi2 is not None:
            rec["jax_record_chi2_final_not_a_check"] = ref_chi2
        else:  # the loop's time by kernel, apart from the preparation
            dp0 = torch.zeros_like(sh.poses)
            rec["profile"] = profile_path(
                lambda gg, c: make_pose_range_solve(mesh, c, meta)(sh, dp0)[:2], gd, cfg,
                iters=2)
        print(f"{name}: " + json.dumps(rec))
        del sh, bl, gd
    print(f"phase pose-range: {time.perf_counter() - t0:.1f} s wall")
    dist.destroy_process_group()

    # ---- the CLI under torchrun, one rank on the card ----
    t0 = time.perf_counter()
    ig, _ = generate_sequence(301, 141, seed=SEED)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/ref_size.g2o"
        write_g2o(path, ig.pose_ids, ig.pose_xyt, ig.lm_ids, ig.lm_xy, parsed=ig,
                  fixed_pose_id=ig.fixed_pose_id)
        root = os.path.dirname(os.path.abspath(__file__))
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "1", "-m", "boslam_torch", "solve", path, "--pose-range", "--linear-solver",
             "schur_cg", "--iters", "5", "--cg-tol", "1e-7"],
            cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True,
            timeout=300)
    if out.returncode != 0 or "1 rank(s), nccl" not in out.stderr:
        raise AssertionError(f"torchrun solve --pose-range: exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    rows = [ln.split() for ln in out.stdout.splitlines() if ln[:4].strip().isdigit()]
    chi2 = [float(r[1]) for r in rows]
    if not (len(chi2) == 5 and np.isfinite(chi2).all() and chi2[-1] < chi2[0]):
        raise AssertionError(f"torchrun solve --pose-range: {out.stdout!r}")
    print(f"torchrun solve --pose-range ({time.perf_counter() - t0:.1f} s wall): "
          + json.dumps(dict(chi2=chi2, ranks=1, backend="nccl")))
    return chol_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import boslam_torch  # noqa: F401  (sets full-f32 matmul precision)
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.metrics import ate_metrics, match_gt_poses
    from boslam_torch.ops import _build
    from boslam_torch.ops import cholesky as chol
    from boslam_torch.ops import gn_step as gs
    from boslam_torch.ops import schur_solve as ss
    from boslam_torch.ops import windowed_gather as wg
    from boslam_torch.solver import schur
    from boslam_torch.solver.gauss_newton import gauge_mask
    from boslam_torch.solver.normal_eq import assemble_dense, edge_terms
    from boslam_torch.solver.optimizer import solve
    from boslam_torch.synth import generate_sequence

    # single-observation landmarks of the large graphs are logged one by one
    logging.getLogger("boslam_torch.init").setLevel(logging.ERROR)

    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, "
          + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items()))
    for name, info in built.items():
        func = "?"
        for line in info["ptxas"].splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif "registers" in line:
                print(f"ptxas {name} {func}: {line.split(':', 1)[-1].strip()}")
            elif "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"):
                print(f"ptxas {name} {func}: {line.strip()}")

    # ---- each kernel against its plain version and an f64 solve ----
    rng = np.random.default_rng(0)
    # every size a path gives the Cholesky: 1024 (gn-schur, gn-fused at
    # 301/141), 1280 (gn-dense), 1536 (the whole step's cap), 1664
    # (MAX_VMEM_DIM); and 2048 past it
    for n in (1024, 1280, 1536, 1664, 2048):
        H = torch.from_numpy(_spd(n, rng)).cuda()
        b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        check_cholesky(torch, chol, H, b, "random cond 1e4")
    check_cholesky_not_spd(torch, chol, 1280, rng)
    for Np, Ml in ((1024, 384), (1280, 512)):
        check_schur(torch, ss, _random_schur_inputs(torch, Np, Ml, rng), 0.0, "random cond 1e4")
    # the gather's launches per call, on a small banded grid (the count does
    # not depend on the shape)
    idx_g = np.clip(np.arange(4096)[:, None] + rng.integers(-8, 9, (4096, 7)), 0, 4095)
    plan_g = wg.plan_windows(idx_g.astype(np.int32), np.ones(idx_g.shape, bool), 4096, device=DEV)
    vals_g = torch.from_numpy(rng.standard_normal((4096, 3)).astype(np.float32)).to(DEV)
    idx_g = torch.from_numpy(idx_g.astype(np.int32)).to(DEV)
    gather_per_call = launches_per_call(lambda: wg.windowed_take(vals_g, idx_g, plan_g))
    print(f"windowed_take kernel launches per call: {gather_per_call}")

    ig, gt = generate_sequence(301, 141, seed=SEED)
    g, meta = build_graph(ig, init="triangulate")
    g_cpu, _ = build_graph(ig, init="triangulate", device="cpu")
    print(f"graph: seed {SEED}, {g.n_poses} poses, {g.n_landmarks} landmarks, "
          f"{g.n_bearing} bearing + {g.n_odometry} odometry edges, N = {g.state_dim}")

    # the systems of the graph's first iteration, at the main path's shapes
    cfg_d = SolverConfig(linear_solver="dense", iters=ITERS)
    H, bvec, _ = assemble_dense(g, cfg_d)
    N = g.state_dim
    H = H + cfg_d.damping * torch.eye(N, device=H.device)
    mask = gauge_mask(N, g.n_poses, g.fixed_pose_ix, H.dtype)
    Hm = mask[:, None] * H * mask[None, :] + torch.diag(1.0 - mask)
    Np_d = chol.pad_dim(N)
    Hp = torch.eye(Np_d, device=H.device)
    Hp[:N, :N] = Hm
    bp_d = torch.zeros(Np_d, device=H.device)
    bp_d[:N] = -mask * bvec
    chol_main = check_cholesky(torch, chol, Hp.contiguous(), bp_d, "graph dense system")
    chol_main["launches_per_call"] = launches_per_call(
        lambda: chol.cholesky_solve_padded(Hp.contiguous(), bp_d))
    print(f"cholesky kernel launches per solve: {chol_main['launches_per_call']} "
          f"(n = {Np_d}, tile {chol.TILE})")
    if not 1 <= chol_main["launches_per_call"] <= 3:
        raise AssertionError(f"cholesky: {chol_main['launches_per_call']} launches per solve")
    cfg_s = SolverConfig(linear_solver="schur", fused_step="off", iters=ITERS)
    pmask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    inputs = schur.fused_schur_inputs(g, cfg_s, cfg_s.damping, edge_terms(g, cfg_s), pmask)
    band_main = _band_route(_graph_band(g), "graph 301/141")
    schur_main = check_schur(torch, ss, inputs, 0.0, "graph reduced system", band_main, g)
    cfg_f = SolverConfig(linear_solver="schur", iters=ITERS)  # fused_step="auto"
    g_step = g_cpu.to("cuda")
    gn_main = check_gn_step(torch, gs, g_step, cfg_f, "graph 301/141")
    if gn_main["band_tiles"] != band_main:
        raise AssertionError(f"graph 301/141: the whole step's band {gn_main['band_tiles']}")
    # the kernel's other robust branches; at a threshold of 1e-3 bearing and
    # odometry edges both clamp, so both weights and the odometry b-side are live
    for name, kw in (("none", dict(robust="none")),
                     ("huber", dict(robust="huber", kernel_threshold=1e-3)),
                     ("textbook threshold", dict(reference_kernel_quirk=False,
                                                 kernel_threshold=1e-3))):
        r = check_gn_step(torch, gs, g_step, cfg_f.replace(**kw), f"graph 301/141 robust {name}")
        if "kernel_threshold" in kw and min(r["clamped"]) == 0:
            raise AssertionError(f"gn_step robust {name}: clamped {r['clamped']}, want both > 0")
    ig_cap, _ = generate_sequence(512, 300, seed=SEED)
    g_cap = build_graph(ig_cap, init="triangulate", device="cpu")[0].to("cuda")
    if not gs.fused_gn_fits(g_cap.n_poses, g_cap.n_landmarks, g_cap.n_bearing, g_cap.n_odometry):
        raise AssertionError("the (512, 300) graph is outside fused_gn_fits")
    r = check_gn_step(torch, gs, g_cap, cfg_f, f"graph {g_cap.n_poses}/{g_cap.n_landmarks} at the cap")
    if r["route"] != "dense":
        raise AssertionError(f"the cap graph takes the {r['route']} route (band {r['band_of_s']})")
    del g_cap

    counters = {"cholesky": chol.cholesky_solve_padded, "schur": ss.fused_schur_solve_blocks,
                "gn_step": gs.fused_gn_step, "windowed_take": wg.windowed_take}

    # ---- gn-schur: GN under the exact Schur solve, the whole-step kernel off ----
    g_cpu_s, st_cpu = solve(g_cpu, cfg_s)
    st_cpu = _stats(st_cpu)
    g2, st, counts, secs = _run_path(torch, solve, g, cfg_s, counters)
    schur_launches = counts["schur"]
    if schur_launches != ITERS or counts["schur_band"] != ITERS:
        raise AssertionError(f"GN-schur: Schur kernel launched {counts}, not {ITERS} on the band route")
    if not st["spd_ok"].all():
        raise AssertionError("GN-schur: a step was not SPD")
    c, c_cpu = st["chi2_robust"], st_cpu["chi2_robust"]
    rel = abs(c[-1] - c_cpu[-1]) / c_cpu[-1]
    if not (np.isfinite(c).all() and c[-1] < c[0] and rel < 1e-4):
        raise AssertionError(f"GN-schur: chi2 {c[0]} -> {c[-1]}, CPU {c_cpu[-1]} (rel {rel:.2e})")
    _, _, _, secs_warm = _run_path(torch, solve, g, cfg_s, counters)
    ate = ate_metrics(g2.poses.cpu().numpy(), match_gt_poses(meta, gt))
    print("gn-schur: " + json.dumps(dict(
        launches=counts, route="band", band_tiles=band_main, chi2_first=float(c[0]),
        chi2_final=float(c[-1]), chi2_final_cpu=float(c_cpu[-1]), rel_vs_cpu=float(rel),
        ate_rmse_aligned=ate["ate_rmse_aligned"], ms_per_iter_first_run=secs / ITERS * 1e3,
        ms_per_iter=secs_warm / ITERS * 1e3)))

    # ---- the dense path: GN under the Cholesky kernel ----
    g_cpu_d, st_cpu_d = solve(g_cpu, cfg_d)
    st_cpu_d = _stats(st_cpu_d)
    _, st_d, counts_d, secs_d = _run_path(torch, solve, g, cfg_d, counters)
    chol_launches = counts_d["cholesky"]
    if chol_launches != ITERS:
        raise AssertionError(f"GN-dense: Cholesky kernel launched {chol_launches} times, not {ITERS}")
    cd, cd_cpu = st_d["chi2_robust"], st_cpu_d["chi2_robust"]
    rel_d = abs(cd[-1] - cd_cpu[-1]) / cd_cpu[-1]
    if not (st_d["spd_ok"].all() and cd[-1] < cd[0] and rel_d < 1e-4):
        raise AssertionError(f"GN-dense: chi2 {cd[0]} -> {cd[-1]}, CPU {cd_cpu[-1]} (rel {rel_d:.2e})")
    print("gn-dense: " + json.dumps(dict(
        launches=counts_d, chi2_final=float(cd[-1]), chi2_final_cpu=float(cd_cpu[-1]),
        rel_vs_cpu=float(rel_d), ms_per_iter_first_run=secs_d / ITERS * 1e3)))
    t0 = time.perf_counter()
    step_dense_launches = run_gn_step_dense_phase(torch, g, counters, st_d, st_cpu_d)
    print(f"phase gn-step-dense: {time.perf_counter() - t0:.1f} s wall")

    # ---- LM under the Schur solve ----
    cfg_lm = cfg_s.replace(optimizer="lm")
    _, st_l, counts_l, secs_l = _run_path(torch, solve, g, cfg_lm, counters)
    cl = st_l["chi2_robust"]
    if counts_l["schur"] != ITERS or counts_l["schur_band"] != ITERS or not np.isfinite(cl).all():
        raise AssertionError(f"LM-schur: launches {counts_l}, chi2 {cl}")
    print("lm-schur: " + json.dumps(dict(
        launches=counts_l, route="band", band_tiles=band_main, chi2_first=float(cl[0]),
        chi2_last=float(cl[-1]),
        accepted=int(st_l["accepted"].sum()), ms_per_iter_first_run=secs_l / ITERS * 1e3)))

    other = run_autodiff_backend_phase(torch, solve, g, counters, {"gn-schur": c, "gn-dense": cd})

    # ---- the main path: GN, exact Schur, fused_step="auto" -> the whole-step kernel ----
    fused_launches = run_fused(torch, solve, g, g_cpu, cfg_f, counters, float(c[-1]), meta, gt,
                               "gn-fused")
    ig_lc, gt_lc = generate_sequence(301, 141, seed=CLOSURE_SEED, loop_closures=4)
    g_lc, meta_lc = build_graph(ig_lc, init="triangulate")
    g_lc_cpu, _ = build_graph(ig_lc, init="triangulate", device="cpu")
    print(f"graph: seed {CLOSURE_SEED}, 4 loop closures, {g_lc.n_poses} poses, "
          f"{g_lc.n_landmarks} landmarks, {g_lc.n_bearing} bearing + {g_lc.n_odometry} odometry edges")
    _, st_lc, _, _ = _run_path(torch, solve, g_lc, cfg_s, counters)
    run_fused(torch, solve, g_lc, g_lc_cpu, cfg_f, counters, float(st_lc["chi2_robust"][-1]),
              meta_lc, gt_lc, "gn-fused 4 loop closures")
    ig_st, _ = generate_sequence(301, 141, seed=STALL_SEED, loop_closures=4)
    g_st, _ = build_graph(ig_st, init="triangulate")
    g_st_cpu, _ = build_graph(ig_st, init="triangulate", device="cpu")
    run_stall(torch, solve, g_st, g_st_cpu, cfg_f, counters,
              f"gn-fused 4 loop closures seed {STALL_SEED}")

    for label, cfg in (("gn-schur", cfg_s), ("gn-dense", cfg_d), ("gn-fused", cfg_f)):
        print(f"profile {label}: " + json.dumps(profile_path(solve, g, cfg)))

    win_row, win_launches = run_scale_phases(torch, wg, counters, solve, generate_sequence,
                                             build_graph, SolverConfig)
    run_survey_phase(torch, counters, build_graph, generate_sequence, SolverConfig)
    run_native_phase(generate_sequence)
    t0 = time.perf_counter()
    run_resume_phase(torch, solve, g, cfg_f, counters, meta)
    print(f"phase resume: {time.perf_counter() - t0:.1f} s wall")
    run_bench_phase(torch, generate_sequence, float(c[-1]))
    from boslam_torch.bench import final_chi2

    chi2_schur_cpu = final_chi2(g_cpu_s, cfg_s)  # on the CPU "auto" takes this same path
    run_measurement_phase(
        torch, counters, g, g_cpu,
        {"dense": final_chi2(g_cpu_d, cfg_d), "schur": chi2_schur_cpu,
         "schur_fused": chi2_schur_cpu},
        {"cholesky_solve_padded": chol_main["bound_ms"],
         "fused_schur_solve_blocks": schur_main["bound_ms"],
         "fused_gn_step": gn_main["bound_ms"], "windowed_take": win_row["bound_ms"]})
    run_trace_split_phase(torch, g_cpu)
    t0 = time.perf_counter()
    st_cpu_l = _stats(solve(g_cpu, cfg_lm)[1])
    sharded_chol = run_multi_device_phase(
        torch, counters, g, g_cpu,
        {"gn-dense": (st_d, st_cpu_d, cfg_d), "gn-schur": (st, st_cpu, cfg_s),
         "lm-schur": (st_l, st_cpu_l, cfg_lm)},
        generate_sequence, build_graph, SolverConfig)
    print(f"phase multi-device: {time.perf_counter() - t0:.1f} s wall")

    kernels = [
        dict(name="cholesky_solve_padded", route="cuda",
             source="boslam_torch/ops/csrc/cholesky.cu",
             replaces="boslam/ops/pallas_cholesky.py:167", launches=chol_launches,
             max_abs_err=chol_main["max_abs_err"], ms=chol_main["ms"],
             plain_ms=chol_main["plain_ms"], bound_ms=chol_main["bound_ms"],
             bound_by=chol_main["bound_by"], library_ms=chol_main["library_ms"],
             launches_per_call=chol_main["launches_per_call"], shape=chol_main["shape"],
             path="gn-dense",
             launches_other_paths={"gn_step_dense": step_dense_launches,
                                   **{k: v["cholesky"] for k, v in other.items() if v["cholesky"]},
                                   **sharded_chol}),
        dict(name="fused_schur_solve_blocks", route="cuda",
             source="boslam_torch/ops/csrc/schur_solve.cu",
             replaces="boslam/ops/pallas_schur.py:133", launches=schur_launches,
             max_abs_err=schur_main["max_abs_err"], ms=schur_main["ms"],
             plain_ms=schur_main["plain_ms"], bound_ms=schur_main["bound_ms"],
             bound_by=schur_main["bound_by"], library_ms=None,
             launches_per_call=schur_main["launches_per_call"], shape=schur_main["shape"],
             solve_route=schur_main["route"], band_tiles=schur_main["band_tiles"],
             dense_route_ms=schur_main["dense_route_ms"], path="gn-schur",
             launches_other_paths={k: v["schur"] for k, v in other.items() if v["schur"]}),
        dict(name="fused_gn_step", route="cuda", source="boslam_torch/ops/csrc/gn_step.cu",
             replaces="boslam/ops/pallas_gn_step.py:792", launches=fused_launches,
             max_abs_err=gn_main["max_abs_err"], ms=gn_main["ms"], plain_ms=gn_main["plain_ms"],
             bound_ms=gn_main["bound_ms"], bound_by=gn_main["bound_by"], library_ms=None,
             launches_per_call=gn_main["launches_per_call"], shape=gn_main["shape"],
             solve_route=gn_main["route"], band_tiles=gn_main["band_tiles"],
             dense_route_ms=gn_main["dense_route_ms"], path="gn-fused"),
        dict(name="windowed_take", route="cuda", source="boslam_torch/ops/csrc/windowed_gather.cu",
             replaces="boslam/ops/windowed_gather.py:157", launches=win_launches,
             max_abs_err=win_row["max_abs_err"], ms=win_row["ms"], plain_ms=win_row["plain_ms"],
             bound_ms=win_row["bound_ms"], bound_by=win_row["bound_by"],
             library_ms=win_row["library_ms"], launches_per_call=gather_per_call,
             shape=win_row["shape"],
             path="packed-windowed 10k + 100k, btridiag, two_level, block-Jacobi, bband and "
                  "bf16 coupling (landmark grid of the 100k corridor)"),
    ]
    if not all(k["launches"] > 0 and k["launches_per_call"] > 0 for k in kernels):
        raise AssertionError(f"a kernel was not launched: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
