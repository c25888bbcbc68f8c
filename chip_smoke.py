#!/usr/bin/env python3
"""Smoke run of the PyTorch port (boslam_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout
(boslam_torch/ops/csrc, into build/boslam_torch_kernels/), holds each
kernel against its plain PyTorch version and an f64 solve on the card,
times them, then drives the port's paths at the reference dataset's size:
GN under the exact Schur solve for 50 iterations (the main path), GN under
the dense solve for 50 iterations, and LM under the Schur solve for 10.
Each path is checked against the port's own CPU run of the same graph.

Prints the card, the build, one line per check, then a JSON line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}.  Any failed
phase raises and the script exits non-zero; it also exits non-zero, before
printing any result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H100_F32_FLOPS = 67e12  # f32 on the CUDA cores, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
SEED = 3  # generate_sequence(301, 141, seed=3): 301 poses, 141 landmarks, N = 1185
ITERS = 50


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps=20, warmup=3) -> float:
    """Mean time of ``fn`` on the card by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(fmas: float, nbytes: float) -> tuple[float, str]:
    """Least time for ``fmas`` f32 FMAs (2 flops each) and ``nbytes`` moved."""
    t_ops = 2.0 * fmas / H100_F32_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    ms = _cuda_ms(torch, lambda: chol.cholesky_solve_padded(H, b))
    plain_ms = _cuda_ms(torch, lambda: chol.cholesky_solve_padded_plain(H, b), reps=5)
    lib_ms = _cuda_ms(torch, lambda: torch.cholesky_solve(b[:, None], torch.linalg.cholesky(H)))
    # factorization n^3/6 FMAs, two triangular solves n^2/2 each
    bound, by = _bound_ms(n**3 / 6 + n * n, 4 * (n * n + 2 * n))
    r = dict(shape=[n], max_abs_err=(x_k - x_p).abs().max().item(), err_vs_f64=err_k,
             plain_err_vs_f64=err_p, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
             library_ms=lib_ms)
    print(f"cholesky {label} n={n}: " + json.dumps(r))
    return r


def _schur_f64(torch, Hpp, U, Hb, bp, bl, m, lam):
    Hpp, U, Hb, bp, bl, m = (t.double() for t in (Hpp, U, Hb, bp, bl, m))
    HllD = torch.block_diag(*Hb)
    W = U @ HllD
    eye = torch.eye(Hpp.shape[0], dtype=torch.float64, device=Hpp.device)
    S = (Hpp - W @ U.T + lam * eye) * (m[:, None] * m[None, :]) + eye * (1.0 - m)
    x = torch.linalg.solve(S, m * (W @ bl - bp))
    return x, HllD @ (-bl - U.T @ x)


def check_schur(torch, ss, inputs, lam, label):
    Np, Ml = inputs[1].shape
    x_k, dl_k = ss.fused_schur_solve_blocks(*inputs, lam)
    x_p, dl_p = ss.fused_schur_solve_blocks_plain(*inputs, lam)
    torch.cuda.synchronize()
    x64, dl64 = _schur_f64(torch, *inputs, float(lam))
    if not (torch.isfinite(x_k).all() and torch.isfinite(dl_k).all()):
        raise AssertionError(f"schur {label}: non-finite kernel result")
    if not bool((x_k[inputs[5] == 0] == 0).all()):
        raise AssertionError(f"schur {label}: masked rows are not exactly 0")
    dense = list(inputs)
    dense[2] = torch.block_diag(*inputs[2])
    x_d, dl_d = ss.fused_schur_solve_padded(*dense, lam)
    if not (torch.equal(x_d, x_k) and torch.equal(dl_d, dl_k)):
        raise AssertionError(f"schur {label}: the dense-HllD signature gives another result")
    err_k = max((x_k.double() - x64).abs().max().item(), (dl_k.double() - dl64).abs().max().item())
    err_p = max((x_p.double() - x64).abs().max().item(), (dl_p.double() - dl64).abs().max().item())
    _check_error(f"schur {label}", err_k, err_p)
    ms = _cuda_ms(torch, lambda: ss.fused_schur_solve_blocks(*inputs, lam))
    plain_ms = _cuda_ms(torch, lambda: ss.fused_schur_solve_blocks_plain(*inputs, lam), reps=5)
    # the Cholesky share of the work, by the library, as a yardstick only
    S = torch.eye(Np, device=inputs[0].device) * 4.0
    chol_lib_ms = _cuda_ms(torch, lambda: torch.cholesky_solve(inputs[3][:, None], torch.linalg.cholesky(S)))
    # W, the lower triangle of W U^T, rhs, the factorization (Np^3/6), the
    # two triangular solves (Np^2/2 each), U^T x and the 2x2 block apply
    fmas = 2 * Np * Ml + Np * (Np + 1) / 2 * Ml + Np * Ml + Np**3 / 6 + Np * Np + Np * Ml + 2 * Ml
    # inputs Hpp, U, Hb [Ml/2,2,2], bp, bl, mask, lam; outputs x, dl
    nbytes = 4 * (Np * Np + Np * Ml + 2 * Ml + 3 * Np + 2 * Ml + 1 + Np + Ml)
    bound, by = _bound_ms(fmas, nbytes)
    err = max((x_k - x_p).abs().max().item(), (dl_k - dl_p).abs().max().item())
    r = dict(shape=[Np, Ml], max_abs_err=err, err_vs_f64=err_k, plain_err_vs_f64=err_p, ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
             cholesky_only_library_ms=chol_lib_ms)
    print(f"schur {label} Np={Np} Ml={Ml}: " + json.dumps(r))
    return r


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g2, st = solve(g, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return g2, _stats(st), {k: fn.launches for k, fn in counters.items()}, seconds


def profile_path(torch, solve, g, cfg, iters=5, top=8):
    """Device time by kernel over ``iters`` warm iterations of one path, and
    the device's busy share of the window (one stream, so kernels do not
    overlap and their sum is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cfg.replace(iters=iters)
    solve(g, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(g, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_kernels += 1
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        iters=iters, wall_ms_per_iter=wall_us / iters / 1e3,
        device_busy_ms_per_iter=busy_us / iters / 1e3, device_busy_share=busy_us / wall_us,
        device_ops_per_iter=n_kernels / iters,
        top=[[name[:60], round(us / iters / 1e3, 4)] for name, us in ranked],
    )


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
    from boslam_torch.ops import schur_solve as ss
    from boslam_torch.solver import schur
    from boslam_torch.solver.gauss_newton import gauge_mask
    from boslam_torch.solver.normal_eq import assemble_dense, edge_terms
    from boslam_torch.solver.optimizer import solve
    from boslam_torch.synth import generate_sequence

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
    for n in (1024, 1280, 1664, 2048):
        H = torch.from_numpy(_spd(n, rng)).cuda()
        b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        check_cholesky(torch, chol, H, b, "random cond 1e4")
    for Np, Ml in ((1024, 384), (1280, 512)):
        check_schur(torch, ss, _random_schur_inputs(torch, Np, Ml, rng), 0.0, "random cond 1e4")

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
    cfg_s = SolverConfig(linear_solver="schur", fused_step="off", iters=ITERS)
    pmask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    inputs = schur.fused_schur_inputs(g, cfg_s, cfg_s.damping, edge_terms(g, cfg_s), pmask)
    schur_main = check_schur(torch, ss, inputs, 0.0, "graph reduced system")

    counters = {"cholesky": chol.cholesky_solve_padded, "schur": ss.fused_schur_solve_blocks}

    # ---- the main path: GN under the exact Schur solve ----
    st_cpu = _stats(solve(g_cpu, cfg_s)[1])
    g2, st, counts, secs = _run_path(torch, solve, g, cfg_s, counters)
    schur_launches = counts["schur"]
    if schur_launches != ITERS:
        raise AssertionError(f"GN-schur: Schur kernel launched {schur_launches} times, not {ITERS}")
    if not st["spd_ok"].all():
        raise AssertionError("GN-schur: a step was not SPD")
    c, c_cpu = st["chi2_robust"], st_cpu["chi2_robust"]
    rel = abs(c[-1] - c_cpu[-1]) / c_cpu[-1]
    if not (np.isfinite(c).all() and c[-1] < c[0] and rel < 1e-4):
        raise AssertionError(f"GN-schur: chi2 {c[0]} -> {c[-1]}, CPU {c_cpu[-1]} (rel {rel:.2e})")
    _, _, _, secs_warm = _run_path(torch, solve, g, cfg_s, counters)
    ate = ate_metrics(g2.poses.cpu().numpy(), match_gt_poses(meta, gt))
    print("gn-schur: " + json.dumps(dict(
        launches=counts, chi2_first=float(c[0]), chi2_final=float(c[-1]),
        chi2_final_cpu=float(c_cpu[-1]), rel_vs_cpu=float(rel),
        ate_rmse_aligned=ate["ate_rmse_aligned"], ms_per_iter_first_run=secs / ITERS * 1e3,
        ms_per_iter=secs_warm / ITERS * 1e3)))

    # ---- the dense path: GN under the Cholesky kernel ----
    st_cpu_d = _stats(solve(g_cpu, cfg_d)[1])
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

    # ---- LM under the Schur solve ----
    cfg_lm = cfg_s.replace(optimizer="lm", iters=10)
    _, st_l, counts_l, secs_l = _run_path(torch, solve, g, cfg_lm, counters)
    cl = st_l["chi2_robust"]
    if counts_l["schur"] != 10 or not np.isfinite(cl).all():
        raise AssertionError(f"LM-schur: launches {counts_l}, chi2 {cl}")
    print("lm-schur: " + json.dumps(dict(
        launches=counts_l, chi2_first=float(cl[0]), chi2_last=float(cl[-1]),
        accepted=int(st_l["accepted"].sum()), ms_per_iter_first_run=secs_l / 10 * 1e3)))

    for label, cfg in (("gn-schur", cfg_s), ("gn-dense", cfg_d)):
        print(f"profile {label}: " + json.dumps(profile_path(torch, solve, g, cfg)))

    kernels = [
        dict(name="cholesky_solve_padded", route="cuda",
             source="boslam_torch/ops/csrc/cholesky.cu",
             replaces="boslam/ops/pallas_cholesky.py:167", launches=chol_launches,
             max_abs_err=chol_main["max_abs_err"], ms=chol_main["ms"],
             plain_ms=chol_main["plain_ms"], bound_ms=chol_main["bound_ms"],
             bound_by=chol_main["bound_by"], library_ms=chol_main["library_ms"],
             shape=chol_main["shape"], path="gn-dense"),
        dict(name="fused_schur_solve_blocks", route="cuda",
             source="boslam_torch/ops/csrc/schur_solve.cu",
             replaces="boslam/ops/pallas_schur.py:133", launches=schur_launches,
             max_abs_err=schur_main["max_abs_err"], ms=schur_main["ms"],
             plain_ms=schur_main["plain_ms"], bound_ms=schur_main["bound_ms"],
             bound_by=schur_main["bound_by"], library_ms=None,
             shape=schur_main["shape"], path="gn-schur"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
