"""The CUDA kernels against their plain PyTorch versions, on the card, and
the packed-windowed path on the card against its CPU run.

The whole-step kernel is held as chip_smoke.py holds it: pre-step chi2 at
rtol 1e-5 and clamp counts exact against the plain version, and the state
no further from the f64 step than twice the farthest of the plain version
and the unfused Schur step, each on the card and on the CPU.  The distance
between two f32 steps is no measure: at the ~1e7 condition of these
systems each lands 5e-4 to 5e-3 from the f64 step in its own direction,
and on the card the plain and unfused steps sum with atomics
(``index_add_``), so theirs changes from run to run.

These tests need a CUDA device and nvcc; elsewhere they skip.  The test
package's conftest.py imports JAX, which the card's machine need not have,
so run them there without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import boslam_torch  # noqa: F401  (full-f32 matmul precision)

    return torch.device("cuda")


def _spd(n, rng, cond=1e4):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((Q * np.geomspace(1.0, cond, n)) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("n", [128, 384, 1024, 1280, 1536, 1664])
def test_cholesky_kernel_matches_plain(cuda, n):
    """Kernel error against f64 within 10x the plain version's + 1e-4
    (test_pallas_cholesky.py:91's bound)."""
    from boslam_torch.ops import cholesky as chol

    rng = np.random.default_rng(n)
    H = torch.from_numpy(_spd(n, rng)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    before = chol.cholesky_solve_padded.launches
    x_k = chol.cholesky_solve_padded(H, b)
    assert chol.cholesky_solve_padded.launches == before + 1
    x_p = chol.cholesky_solve_padded_plain(H, b)
    x64 = torch.linalg.solve(H.double(), b.double())
    err_k = (x_k.double() - x64).abs().max().item()
    err_p = (x_p.double() - x64).abs().max().item()
    assert err_k <= 10 * err_p + 1e-4, (err_k, err_p)


def test_cholesky_kernel_not_spd_gives_nan(cuda):
    from boslam_torch.ops import cholesky as chol

    H = torch.eye(256, device=cuda)
    H[100, 100] = -1.0
    x = chol.cholesky_solve_padded(H, torch.ones(256, device=cuda))
    assert torch.isnan(x).any()


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_cholesky_kernel_not_spd_in_any_tile(cuda, where):
    """A negative pivot in the first, a middle or the last tile of a
    1024 system gives a non-finite x."""
    from boslam_torch.ops import cholesky as chol

    n = 1024
    H = torch.from_numpy(_spd(n, np.random.default_rng(7))).to(cuda)
    p = {"first": 5, "middle": n // 2 + 17, "last": n - 1}[where]
    H[p, p] = -1.0
    b = torch.ones(n, device=cuda)
    assert not torch.isfinite(chol.cholesky_solve_padded(H, b)).all()


@pytest.mark.parametrize("n", [1024, 1536])
def test_cholesky_kernel_repeats_bitwise(cuda, n):
    """No atomics in any sum: two solves give the same bits."""
    from boslam_torch.ops import cholesky as chol

    rng = np.random.default_rng(n + 1)
    H = torch.from_numpy(_spd(n, rng)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    assert torch.equal(chol.cholesky_solve_padded(H, b), chol.cholesky_solve_padded(H, b))


def test_schur_kernel_matches_plain(cuda):
    from boslam_torch.ops import schur_solve as ss

    rng = np.random.default_rng(1)
    Np, Ml = 384, 256
    U = (0.1 * rng.standard_normal((Np, Ml))).astype(np.float32)
    blocks = np.stack([_spd(2, rng, cond=3.0) for _ in range(Ml // 2)])
    HllD = np.zeros((Ml, Ml), np.float32)
    for l in range(Ml // 2):
        HllD[2 * l:2 * l + 2, 2 * l:2 * l + 2] = blocks[l]
    Hpp = (_spd(Np, rng, cond=1e3) + U @ HllD @ U.T).astype(np.float32)
    bp, bl = rng.standard_normal(Np).astype(np.float32), rng.standard_normal(Ml).astype(np.float32)
    m = np.ones(Np, np.float32)
    m[3:6] = 0.0
    m[-20:] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in (Hpp, U, blocks, bp, bl, m)]
    before = ss.fused_schur_solve_blocks.launches
    x_k, dl_k = ss.fused_schur_solve_blocks(*args, 0.25)
    assert ss.fused_schur_solve_blocks.launches == before + 1
    x_p, dl_p = ss.fused_schur_solve_blocks_plain(*args, 0.25)
    torch.testing.assert_close(x_k, x_p, rtol=2e-3, atol=2e-5)
    torch.testing.assert_close(dl_k, dl_p, rtol=2e-3, atol=2e-5)
    assert bool((x_k[args[5] == 0] == 0).all())
    # the dense-HllD signature reads the same blocks, through the same kernel
    dense = list(args)
    dense[2] = torch.from_numpy(HllD).to(cuda)
    x_d, dl_d = ss.fused_schur_solve_padded(*dense, 0.25)
    assert torch.equal(x_d, x_k) and torch.equal(dl_d, dl_k)


def _schur_digest(ss, device) -> str:
    """sha256 of the bits of fused_schur_solve_blocks on fixed inputs at the
    gn-schur shapes (Np 1024, Ml 384) and at the whole step's cap (1536,
    1024), both within one digest."""
    import hashlib

    h = hashlib.sha256()
    rng = np.random.default_rng(1234)
    for Np, Ml in ((1024, 384), (1536, 1024)):
        U = (0.1 * rng.standard_normal((Np, Ml))).astype(np.float32)
        blocks = np.stack([_spd(2, rng, cond=3.0) for _ in range(Ml // 2)])
        Hpp = _spd(Np, rng, cond=1e3)
        for l in range(Ml // 2):
            Ul = U[:, 2 * l:2 * l + 2]
            Hpp += Ul @ blocks[l] @ Ul.T
        bp = rng.standard_normal(Np).astype(np.float32)
        bl = rng.standard_normal(Ml).astype(np.float32)
        m = np.ones(Np, np.float32)
        m[:3] = 0.0
        args = [torch.from_numpy(a).to(device) for a in (Hpp.astype(np.float32), U, blocks, bp, bl, m)]
        x, dl = ss.fused_schur_solve_blocks(*args, 0.01)
        torch.cuda.synchronize()
        h.update(x.cpu().numpy().tobytes())
        h.update(dl.cpu().numpy().tobytes())
    return h.hexdigest()


def test_schur_solve_bits_unchanged(cuda):
    """Two runs give the same bits: no sum of the Schur solve or its
    factorization depends on scheduling."""
    from boslam_torch.ops import schur_solve as ss

    assert _schur_digest(ss, cuda) == _schur_digest(ss, cuda)


def _graph(n_poses, n_landmarks, device, loop_closures=0):
    """Built on the CPU and moved to ``device``: every test starts from the
    CPU's bits (a build on the card gives the same graph, its landmarks
    within one f32 ulp: test_build_graph_on_the_card_matches_the_cpu)."""
    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(n_poses, n_landmarks, seed=3, loop_closures=loop_closures)
    return build_graph(ig, init="triangulate", device="cpu")[0].to(device)


def _dist(a, b):
    return (a.double().cpu() - b.double().cpu()).abs().max().item()


def _check_kernel_vs_plain(g, **cfg_kw):
    import dataclasses

    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import gn_step as gs
    from boslam_torch.solver.optimizer import gn_step

    cfg = SolverConfig(linear_solver="schur", **cfg_kw)
    before = gs.fused_gn_step.launches
    g_k, s_k = gn_step(g, cfg)
    assert gs.fused_gn_step.launches == before + 1
    prep = gs.prep_static(g)
    p_p, l_p, row = gs.fused_gn_step_plain(prep, g.poses, g.landmarks, cfg)
    g_u, _ = gn_step(g, cfg.replace(fused_step="off"))
    assert gs.fused_gn_step.launches == before + 1
    for i, k in enumerate(("chi2_bearing", "chi2_odometry", "chi2_robust")):
        torch.testing.assert_close(s_k[k], row[i], rtol=1e-5, atol=1e-6)
    assert s_k["n_bearing_clamped"].item() == int(row[3].item())
    assert s_k["n_odometry_clamped"].item() == int(row[4].item())
    assert bool(s_k["spd_ok"])
    gc = g.to("cpu")
    g64 = dataclasses.replace(gc, **{f.name: getattr(gc, f.name).double()
                                     for f in dataclasses.fields(gc)
                                     if getattr(gc, f.name).is_floating_point()})
    x64, _ = gn_step(g64, cfg.replace(linear_solver="dense", fused_step="off"))

    def e64(P, L):
        return max(_dist(P, x64.poses), _dist(L, x64.landmarks))

    p_c, l_c, _ = gs.fused_gn_step_plain(gs.prep_static(gc), gc.poses, gc.landmarks, cfg)
    g_uc, _ = gn_step(gc, cfg.replace(fused_step="off"))
    err = e64(g_k.poses, g_k.landmarks)
    others = [e64(p_p, l_p), e64(g_u.poses, g_u.landmarks), e64(p_c, l_c), e64(g_uc.poses, g_uc.landmarks)]
    assert err <= 2.0 * max(others), (err, others)
    fix = int(g.fixed_pose_ix)
    assert torch.equal(g_k.poses[fix], g.poses[fix])
    return s_k


@pytest.mark.parametrize("n_poses, n_landmarks, loop_closures", [(60, 30, 0), (301, 141, 0),
                                                                 (120, 50, 3)])
def test_gn_step_kernel_matches_plain(cuda, n_poses, n_landmarks, loop_closures):
    _check_kernel_vs_plain(_graph(n_poses, n_landmarks, cuda, loop_closures))


@pytest.mark.parametrize("kw", [
    dict(robust="none"),
    dict(robust="huber", kernel_threshold=1e-3),
    dict(reference_kernel_quirk=False, kernel_threshold=1e-3),
], ids=["none", "huber", "textbook-threshold"])
def test_gn_step_kernel_robust_variants(cuda, kw):
    """The kernel's other robust branches.  At a threshold of 1e-3 bearing
    and odometry edges both clamp, so both weights and the odometry b-side
    (J^T Omega w_b e) are live."""
    s_k = _check_kernel_vs_plain(_graph(301, 141, cuda), **kw)
    if "kernel_threshold" in kw:
        assert s_k["n_bearing_clamped"].item() > 0 and s_k["n_odometry_clamped"].item() > 0


def _with_shared_owners(g):
    """Ten bearing edges repeated on their (pose, landmark) pairs, an
    odometry edge 6 -> 5 beside the chain's 5 -> 6, and one from pose 7 to
    itself: runs of more than one edge for every owner the kernel sums by."""
    import dataclasses

    dev = g.device
    dx, dy, dth = g.o_meas[5]
    c, s = torch.cos(dth), torch.sin(dth)
    back = torch.stack([-c * dx - s * dy, s * dx - c * dy, -dth])  # the inverse motion
    o_meas = torch.stack([back, torch.tensor([0.1, 0.0, 0.05], device=dev)])
    return dataclasses.replace(
        g, b_pose=torch.cat([g.b_pose, g.b_pose[:10]]), b_lm=torch.cat([g.b_lm, g.b_lm[:10]]),
        b_meas=torch.cat([g.b_meas, g.b_meas[:10] + 0.01]),
        b_omega=torch.cat([g.b_omega, g.b_omega[:10]]),
        o_src=torch.cat([g.o_src, torch.tensor([6, 7], device=dev)]),
        o_dst=torch.cat([g.o_dst, torch.tensor([5, 7], device=dev)]),
        o_meas=torch.cat([g.o_meas, o_meas]), o_omega=torch.cat([g.o_omega, g.o_omega[:2]]))


def test_gn_step_kernel_shared_owners(cuda):
    _check_kernel_vs_plain(_with_shared_owners(_graph(120, 50, cuda, loop_closures=3)))


def test_gn_solve_counts_and_repeats_bitwise(cuda):
    """One launch per GN step; two solves give the same bits; the unfused
    wrappers stay idle."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import gn_step as gs
    from boslam_torch.ops import schur_solve as ss
    from boslam_torch.solver.optimizer import solve

    g = _graph(301, 141, cuda)
    cfg = SolverConfig(linear_solver="schur", iters=5)
    before, before_schur = gs.fused_gn_step.launches, ss.fused_schur_solve_blocks.launches
    g1, s1 = solve(g, cfg)
    assert gs.fused_gn_step.launches == before + 5
    g2, s2 = solve(g, cfg)
    assert gs.fused_gn_step.launches == before + 10
    assert ss.fused_schur_solve_blocks.launches == before_schur
    assert torch.equal(g1.poses, g2.poses) and torch.equal(g1.landmarks, g2.landmarks)
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    assert bool(s1["spd_ok"].all()) and s1["chi2_robust"][-1] < s1["chi2_robust"][0]


def test_gn_step_zero_damping_finite(cuda):
    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import gn_step as gs

    g = _graph(60, 30, cuda)
    g1, st = gs.fused_gn_step(g, SolverConfig(linear_solver="schur", damping=0.0))
    assert torch.isfinite(g1.poses).all() and torch.isfinite(g1.landmarks).all()
    assert bool(st["spd_ok"])


def _banded(rng, R, K, M, band):
    centers = np.linspace(0, M - 1, R)
    return (centers[:, None] + rng.integers(-band, band + 1, (R, K))).clip(0, M - 1).astype(np.int32)


@pytest.mark.parametrize("case", ["ragged", "tile_rows_128", "window_past_values", "poisoned"])
@pytest.mark.parametrize("C", [2, 3, 4])
def test_windowed_take_kernel_matches_plain(cuda, case, C):
    """The kernel equals its plain version to the bit: a ragged last tile,
    128-row tiles, a window wider than the values, poisoned and -1 slots."""
    from boslam_torch.ops import windowed_gather as wg

    rng = np.random.default_rng(C)
    R, K, M, tile_rows = {"ragged": (1000, 7, 3000, 256), "tile_rows_128": (3000, 6, 15000, 128),
                          "window_past_values": (301, 5, 90, 256),
                          "poisoned": (1000, 24, 3000, 256)}[case]
    idx = _banded(rng, R, K, M, band=10 if case != "tile_rows_128" else 100)
    plan = wg.plan_windows(idx, np.ones((R, K), bool), M, tile_rows=tile_rows, device=cuda)
    assert plan is not None and plan.tile_rows == tile_rows and R % tile_rows
    if case == "window_past_values":
        assert plan.window > M
    if case == "poisoned":
        idx[3, 1] = int(plan.starts[0]) + plan.window + 7
        idx[5, 2] = -1
    values = torch.from_numpy(rng.standard_normal((M, C)).astype(np.float32)).to(cuda)
    idx_t = torch.from_numpy(idx).to(cuda)
    before = wg.windowed_take.launches
    out = wg.windowed_take(values, idx_t, plan)
    assert wg.windowed_take.launches == before + 1
    ref = wg.windowed_take_plain(values, idx_t, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    if case == "poisoned":
        assert bool((out[3, 1] == 0).all()) and bool((out[5, 2] == 0).all())
    else:
        assert torch.equal(out, values[idx_t])


@pytest.mark.parametrize("C", [2, 3, 4])
def test_windowed_take_kernel_large_grid(cuda, C):
    """10^5 rows of 7 slots, 256-row tiles and a ragged last tile: equal to
    its plain version and to values[idx], to the bit."""
    from boslam_torch.ops import windowed_gather as wg

    rng = np.random.default_rng(10 + C)
    R, K, M = 100_000, 7, 40_000
    idx = _banded(rng, R, K, M, band=30)
    plan = wg.plan_windows(idx, np.ones((R, K), bool), M, device=cuda)
    assert plan is not None and R % plan.tile_rows
    values = torch.from_numpy(rng.standard_normal((M, C)).astype(np.float32)).to(cuda)
    idx_t = torch.from_numpy(idx).to(cuda)
    out = wg.windowed_take(values, idx_t, plan)
    assert torch.equal(out, wg.windowed_take_plain(values, idx_t, plan))
    assert torch.equal(out, values[idx_t])


@pytest.mark.parametrize("optimizer, extra", [
    ("gn", {}), ("lm", {}), ("gn", {"preconditioner": "bband"}),
    ("gn", {"coupling_dtype": "bfloat16"}),
])
def test_packed_windowed_step_matches_cpu(cuda, optimizer, extra):
    """Two packed-windowed iterations on a corridor graph, on the card and on
    the CPU: chi2 at iteration 0 within rtol 1e-5, the next within 2e-3;
    the kernel launched 5 + 2 k times per GN iteration with k matvecs
    (LM: one more; bband: one more, its assembly's take of Hll^-1), also
    under the bband preconditioner and with bf16 coupling blocks, all
    under sync-debug "error" (no host wait but the CG polls)."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.ops import windowed_gather as wg
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(600, 240, seed=3, turn_every=10**9)
    g_cpu = build_graph(ig, init="triangulate", device="cpu")[0]
    cfg = SolverConfig(linear_solver="schur_cg", gather="windowed", optimizer=optimizer, iters=2,
                       **extra)
    g = g_cpu.to(cuda)
    before = wg.windowed_take.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, st = solve_packed(g, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    per = 5 + (optimizer == "lm") + (cfg.preconditioner == "bband")
    assert wg.windowed_take.launches - before == sum(per + 2 * int(m) for m in st["cg_matvecs"])
    _, st_cpu = solve_packed(g_cpu, cfg)
    c, c_cpu = st["chi2_robust"].cpu().numpy(), st_cpu["chi2_robust"].numpy()
    np.testing.assert_allclose(c[0], c_cpu[0], rtol=1e-5)
    np.testing.assert_allclose(c, c_cpu, rtol=2e-3)


def _graph_seed(n_poses, n_landmarks, seed, loop_closures, device):
    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(n_poses, n_landmarks, seed=seed, loop_closures=loop_closures)
    return build_graph(ig, init="triangulate", device="cpu")[0].to(device)


@pytest.mark.parametrize("seed, loop_closures, band", [(3, 0, 3), (16, 4, 4)],
                         ids=["chain", "closures"])
def test_gn_step_band_route_matches_dense_route_bitwise(cuda, seed, loop_closures, band):
    """The whole step at 301/141 on the band route and on the dense route:
    the same new state and stats row, to the bit, over three steps."""
    import dataclasses

    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import gn_step as gs

    g = _graph_seed(301, 141, seed, loop_closures, cuda)
    cfg = SolverConfig(linear_solver="schur")
    prep = gs.prep_static(g, gs.tile_band(g))
    assert prep.band_tiles == band
    states = []
    for p in (prep, dataclasses.replace(prep, band_tiles=None)):
        poses, lms = g.poses.clone(), g.landmarks.clone()
        kern = gs.GNStepKernel(p, poses, lms, cfg)
        rows = torch.zeros((3, gs.STATS_WIDTH), device=cuda)
        before = gs.fused_gn_step.band_launches
        for i in range(3):
            kern.step(rows[i])
        assert gs.fused_gn_step.band_launches - before == (3 if p.band_tiles is not None else 0)
        states.append((poses, lms, rows))
    (p1, l1, r1), (p2, l2, r2) = states
    assert bool(r1[:, 6].all()) and torch.isfinite(p1).all()
    assert torch.equal(p1, p2) and torch.equal(l1, l2) and torch.equal(r1, r2)


def test_schur_band_route_matches_dense_route_bitwise(cuda):
    """The Schur kernel on the graph's reduced system: the band route (and
    every wider band that fits) gives the dense route's bits."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import cholesky as chol
    from boslam_torch.ops import schur_solve as ss
    from boslam_torch.solver import schur
    from boslam_torch.solver.normal_eq import edge_terms

    g = _graph_seed(301, 141, 3, 0, cuda)
    cfg = SolverConfig(linear_solver="schur", fused_step="off")
    band = schur.kernel_band(g, cfg)
    assert band == 3
    pmask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    inputs = schur.fused_schur_inputs(g, cfg, cfg.damping, edge_terms(g, cfg), pmask)
    before = ss.fused_schur_solve_blocks.band_launches
    x_d, dl_d = ss.fused_schur_solve_blocks(*inputs, 0.0)
    assert ss.fused_schur_solve_blocks.band_launches == before
    assert torch.isfinite(x_d).all()
    widest = max(bt for bt in range(8) if chol.band_fits(bt, inputs[0].shape[0]))
    for bt in range(band, widest + 1):
        x_b, dl_b = ss.fused_schur_solve_blocks(*inputs, 0.0, bt)
        assert torch.equal(x_b, x_d) and torch.equal(dl_b, dl_d), bt
    assert ss.fused_schur_solve_blocks.band_launches == before + widest + 1 - band


def test_band_route_repeats_bitwise(cuda):
    """A race probe for the band kernel, for a machine where
    compute-sanitizer cannot attach: the Schur solve at every band that
    fits, and the whole step at the closure graph's band, each 200 times
    from the same inputs with other work on the card in between, give one
    set of bits."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import cholesky as chol
    from boslam_torch.ops import gn_step as gs
    from boslam_torch.ops import schur_solve as ss
    from boslam_torch.solver import schur
    from boslam_torch.solver.normal_eq import edge_terms

    g = _graph_seed(301, 141, 3, 0, cuda)
    cfg = SolverConfig(linear_solver="schur", fused_step="off")
    pmask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    inputs = schur.fused_schur_inputs(g, cfg, cfg.damping, edge_terms(g, cfg), pmask)
    noise = torch.randn(4096, 4096, device=cuda)
    for bt in range(3, 8):
        if not chol.band_fits(bt, inputs[0].shape[0]):
            break
        x0, dl0 = ss.fused_schur_solve_blocks(*inputs, 0.0, bt)
        for i in range(200):
            if i % 50 == 0:
                noise = noise @ noise.T * 1e-4  # other work on the card between launches
            x, dl = ss.fused_schur_solve_blocks(*inputs, 0.0, bt)
            assert torch.equal(x, x0) and torch.equal(dl, dl0), (bt, i)
    g = _graph_seed(301, 141, 16, 4, cuda)
    cfg = SolverConfig(linear_solver="schur")
    prep = gs.prep_static(g, gs.tile_band(g))
    assert prep.band_tiles == 4
    rows = []
    for i in range(200):
        poses, lms = g.poses.clone(), g.landmarks.clone()
        row = torch.zeros(gs.STATS_WIDTH, device=cuda)
        gs.GNStepKernel(prep, poses, lms, cfg).step(row)
        rows.append((poses, lms, row))
    for poses, lms, row in rows[1:]:
        assert torch.equal(poses, rows[0][0]) and torch.equal(lms, rows[0][1])
        assert torch.equal(row, rows[0][2])


@pytest.mark.parametrize("n_poses, n_landmarks, seed, loop_closures, band", [
    (301, 141, 3, 0, 3), (301, 141, 16, 4, 4), (301, 141, 0, 4, 4), (512, 300, 3, 0, None)])
def test_route_of_each_graph(cuda, n_poses, n_landmarks, seed, loop_closures, band):
    """The route a graph on the card takes: the band route at 301/141, the
    dense route at the 512-pose cap (its band, 42 tiles, does not fit)."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import gn_step as gs
    from boslam_torch.solver import schur

    g = _graph_seed(n_poses, n_landmarks, seed, loop_closures, cuda)
    assert gs.tile_band(g) == band
    # the unfused path's Schur kernel: the same band (the cap graph is
    # outside its size gate, so no route at all)
    assert schur.kernel_band(g, SolverConfig(linear_solver="schur")) == band


def test_band_route_past_its_shared_memory_raises(cuda):
    """A band whose window does not fit one block's shared memory is refused
    at launch and raises; nothing runs on the dense route instead."""
    from boslam_torch.ops import cholesky as chol
    from boslam_torch.ops import schur_solve as ss

    rng = np.random.default_rng(4)
    Np, Ml = 1024, 128
    past = min(bt for bt in range(8) if not chol.band_fits(bt, Np))
    assert past >= 5 and chol.band_fits(past - 1, Np)
    U = np.zeros((Np, Ml), np.float32)
    blocks = np.stack([np.eye(2, dtype=np.float32)] * (Ml // 2))
    args = [torch.from_numpy(a).to(cuda) for a in (
        _spd(Np, rng, cond=10.0), U, blocks, rng.standard_normal(Np).astype(np.float32),
        np.zeros(Ml, np.float32), np.ones(Np, np.float32))]
    with pytest.raises(RuntimeError, match="fused_schur_solve_blocks"):
        ss.fused_schur_solve_blocks(*args, 0.0, past)
    torch.cuda.synchronize()


def test_autodiff_jacobians_on_the_card(cuda):
    """The autodiff Jacobians (vmap + jacfwd) on a CUDA graph, under
    sync-debug "error": within 1e-5 of the analytic ones (normwise)."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver.normal_eq import edge_terms

    g = _graph_seed(301, 141, 3, 4, cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t_ad = edge_terms(g, SolverConfig(use_autodiff_jacobians=True))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t = edge_terms(g, SolverConfig())
    for name in ("bjp", "bjl", "ojs", "ojd"):
        a, b = getattr(t_ad, name), getattr(t, name)
        assert a.dtype == torch.float32 and a.is_cuda
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-5, name


def test_multi_device_layouts_at_world_size_1(cuda):
    """The three layouts on a one-rank NCCL group: the sharded dense solve
    launches the Cholesky kernel once per iteration (the Schur and
    whole-step kernels never) and ends on the single-device run's chi2
    (rel 1e-4); pose-range and sharded packed start from the packed
    run's chi2 (rel 1e-5)."""
    import torch.distributed as dist

    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.ops import cholesky as chol, gn_step as gs, schur_solve as ss
    from boslam_torch.parallel.mesh import make_mesh
    from boslam_torch.parallel.pose_range import pose_range_solve
    from boslam_torch.parallel.sharded import sharded_solve
    from boslam_torch.parallel.sharded_packed import sharded_packed_solve
    from boslam_torch.solver.optimizer import solve, solve_packed
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(301, 141, seed=3)
    g, _ = build_graph(ig, init="triangulate")
    mesh = make_mesh("cuda")
    try:
        assert (mesh.backend, mesh.size) == ("nccl", 1)
        cfg = SolverConfig(linear_solver="dense", iters=20)
        counts = [chol.cholesky_solve_padded.launches, ss.fused_schur_solve_blocks.launches,
                  gs.fused_gn_step.launches]
        _, st = sharded_solve(g, cfg, mesh)
        assert [chol.cholesky_solve_padded.launches - counts[0],
                ss.fused_schur_solve_blocks.launches - counts[1],
                gs.fused_gn_step.launches - counts[2]] == [20, 0, 0]
        c, c1 = st["chi2_robust"].cpu().numpy(), solve(g, cfg)[1]["chi2_robust"].cpu().numpy()
        assert abs(c[-1] - c1[-1]) / c1[-1] < 1e-4, (c[-1], c1[-1])
        pcfg = SolverConfig(linear_solver="schur_cg", iters=2, cg_tol=1e-7, lm_split=0,
                            preconditioner="block_jacobi")
        ref = solve_packed(g, pcfg)[1]["chi2_robust"].cpu().numpy()
        for fn in (pose_range_solve, sharded_packed_solve):
            c = fn(g, pcfg, mesh)[1]["chi2_robust"].cpu().numpy()
            assert np.isfinite(c).all() and abs(c[0] - ref[0]) / ref[0] < 1e-5, (fn, c, ref)
        assert mesh.bytes["all_gather"] > 0 and mesh.bytes["psum"] > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("path, per_step", [("dense", 1), ("schur", 8)])
def test_trace_counts_port_kernel_launches(cuda, path, per_step):
    """``tools/port_trace_validate.py``'s chain on the card: the trace counts
    the Cholesky kernel once per step (dense) and the whole step's eight
    launches per step on the band route (schur), and busy <= span <= wall."""
    import importlib.util
    import os

    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence
    from boslam_torch.utils.roofline import chip_spec

    tool = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "port_trace_validate.py")
    spec = importlib.util.spec_from_file_location("port_trace_validate", tool)
    tv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tv)
    ig, _ = generate_sequence(301, 141, seed=3)
    g = build_graph(ig, init="triangulate", device="cpu")[0].to(cuda)
    rec = tv.trace_path(path, g, 5, chip_spec())
    tr = rec["trace"]
    assert tr["port_kernel_launches"] == per_step * 5
    assert rec["kernel_work"]["launches"] == per_step * 5
    assert rec["route"] == ("band" if path == "schur" else "kernel")
    # the span is on the device's clock, the wall on the host's (chip_smoke.CLOCK_RTOL)
    assert 0 < tr["device_time_ms"] <= tr["device_span_ms"] <= tr["profiled_wall_ms"] * 1.001


def test_gn_step_dense_on_the_card(cuda):
    """``gn_step_dense`` on a CUDA graph launches the Cholesky kernel once per
    step.  Its state is held to the f64 step as test_cholesky_kernel_matches_plain
    holds the solve: error within 10x the plain version's (the step on the
    CPU under "pallas") + 1e-4."""
    import dataclasses

    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import cholesky as chol
    from boslam_torch.solver.gauss_newton import gn_step_dense

    g = _graph(301, 141, cuda)
    cfg = SolverConfig(linear_solver="dense")
    before = chol.cholesky_solve_padded.launches
    g1, st = gn_step_dense(g, cfg)
    g2, _ = gn_step_dense(g1, cfg)
    assert chol.cholesky_solve_padded.launches == before + 2
    assert bool(st["spd_ok"]) and set(st) >= {"chi2_robust", "spd_ok", "delta_norm"}
    assert not {"accepted", "damping"} & set(st)
    gc = g.to("cpu")
    g_p, _ = gn_step_dense(gc, cfg.replace(cholesky_backend="pallas"))
    g64 = dataclasses.replace(gc, **{f.name: getattr(gc, f.name).double()
                                     for f in dataclasses.fields(gc)
                                     if getattr(gc, f.name).is_floating_point()})
    x64, _ = gn_step_dense(g64, cfg.replace(cholesky_backend="xla"))
    err_k = max(_dist(g1.poses, x64.poses), _dist(g1.landmarks, x64.landmarks))
    err_p = max(_dist(g_p.poses, x64.poses), _dist(g_p.landmarks, x64.landmarks))
    assert err_k <= 10 * err_p + 1e-4, (err_k, err_p)


def test_cholesky_rule_on_the_card(cuda):
    """No cfg takes torch.linalg on the card too, as the JAX package's no-cfg
    rule takes XLA's; "auto" takes the kernel for a CUDA tensor that fits."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import cholesky as chol
    from boslam_torch.solver import gauss_newton as GN

    H = torch.eye(1280, device=cuda)
    assert not GN._use_cholesky_kernel(H, None)
    assert GN._use_cholesky_kernel(H, SolverConfig(cholesky_backend="auto"))
    before = chol.cholesky_solve_padded.launches
    mask = torch.ones(1280, device=cuda)
    delta, ok = GN.solve_gauge_fixed(H, torch.ones(1280, device=cuda), mask)
    assert chol.cholesky_solve_padded.launches == before and bool(ok)
    torch.testing.assert_close(delta, -torch.ones(1280, device=cuda))


def _past_one_ulp(a, b):
    """Coordinates of f32 ``a`` more than one f32 ulp from ``b`` (on the CPU)."""
    a, b = a.cpu(), b.cpu()
    inf = torch.tensor(float("inf"))
    return int(((a < torch.nextafter(b, -inf)) | (a > torch.nextafter(b, inf))).sum())


def _survey_graph():
    """chip_smoke.SURVEY's graph, built on the CPU: a 10k-pose walk with 100
    loop closures, and its pose-graph init (2 landmark rounds)."""
    import logging

    from boslam_torch.graph.build import build_graph
    from boslam_torch.init.pose_graph import pgo_initialize
    from boslam_torch.synth import generate_sequence

    logging.getLogger("boslam_torch.init").setLevel(logging.ERROR)
    ig, _ = generate_sequence(10000, 3900, seed=3, loop_closures=100)
    g, _ = build_graph(ig, init="triangulate", device="cpu")
    return ig, g, pgo_initialize(g, landmark_rounds=2)


def test_triangulation_on_the_card_matches_the_cpu(cuda):
    """The f64 triangulation on the card against the CPU's, on the survey
    graph at its built poses and at its pose-graph init's: within one f32
    ulp per coordinate, three runs on the card."""
    from boslam_torch.init.triangulation import triangulate_landmarks

    _, g, gp = _survey_graph()
    for poses in (g.poses, gp.poses):
        args = (poses, g.b_pose, g.b_lm, g.b_meas)
        want = triangulate_landmarks(*args, n_landmarks=g.n_landmarks)
        for _ in range(3):
            got = triangulate_landmarks(*(t.to(cuda) for t in args), n_landmarks=g.n_landmarks)
            assert got.dtype == torch.float32 and _past_one_ulp(got, want) == 0


@pytest.mark.parametrize("size", ["301-141", "survey"])
def test_build_graph_on_the_card_matches_the_cpu(cuda, size):
    """``build_graph(init="triangulate")`` on the card: every field the CPU
    build's, the landmarks within one f32 ulp."""
    import dataclasses

    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence

    if size == "survey":
        ig, _, _ = _survey_graph()
    else:
        ig, _ = generate_sequence(301, 141, seed=3)
    g, _ = build_graph(ig, init="triangulate")
    g_cpu, _ = build_graph(ig, init="triangulate", device="cpu")
    assert g.device.type == "cuda"
    for f in dataclasses.fields(g):
        if f.name != "landmarks":
            assert torch.equal(getattr(g, f.name).cpu(), getattr(g_cpu, f.name)), f.name
    assert _past_one_ulp(g.landmarks, g_cpu.landmarks) == 0


def test_profiled_session_counts_only_its_own_launches(cuda):
    """A profiler session right after several unprofiled runs of the whole
    step (left in flight): the trace counts the profiled call's 8 launches
    per step and no more, busy <= span, and the span fits the call's window
    on the profiler's timeline (chip_smoke.CLOCK_RTOL)."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver.optimizer import gn_step
    from boslam_torch.solver.schur import kernel_band
    from boslam_torch.utils import profiling

    g = _graph(301, 141, cuda)
    cfg = SolverConfig(linear_solver="schur")
    band = kernel_band(g, cfg)

    def chain(n):
        h = g
        for _ in range(n):
            h, _ = gn_step(h, cfg, band)
        return h

    for _ in range(4):
        chain(5)  # no wait for the card
    tr = profiling.device_time_by_kernel(lambda: chain(5), cuda)
    assert profiling.port_launches(tr)[0] == 8 * 5
    assert tr.timeline["own"] is not None and tr.n_ops > 8 * 5
    assert 0 < tr.busy_ms <= tr.span_ms <= tr.window_ms * (1 + 1e-3)


def test_spans_on_the_card(cuda):
    """The program's spans on the card: a bare profiler session around a
    packed solve holds no ``boslam_torch::`` event on either side and
    ``device_time_by_kernel`` counts the device operations of a bare one; its
    ``by_span`` puts every operation and idle gap down to a span, the idle
    time summed by span equal to the window's within 1%."""
    from torch.profiler import ProfilerActivity, profile

    from boslam_torch.config import SolverConfig
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.utils import profiling, spans

    g = _graph(2000, 800, cuda)
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=3,
                       cg_iters=40)

    def run():
        out, _ = solve_packed(g, cfg)
        return out.poses.cpu()

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    assert not [e.name for e in prof.events() if e.name.startswith(spans.ANNOTATION)]
    # the same call profiled bare through the same reader: as many operations
    events, _ = profiling._profile_once(run, cuda)
    assert not [e.name for e in events if e.name.startswith(spans.ANNOTATION)
                and e.name != profiling.WINDOW]
    ops, window = profiling._device_ops(events, True)
    split = profiling._launched_by_call(ops, events, window, True)
    tr = profiling.device_time_by_kernel(run, cuda)
    assert split is not None and sum(split[1]) == tr.n_ops
    assert sum(n for _, n, _ in tr.by_span.values()) == tr.n_ops
    assert "unmatched" not in tr.by_span and tr.by_span["solve_packed/step/pcg"][1] > 0
    idle = sum(i for _, _, i in tr.by_span.values()) * 1e3
    assert idle == pytest.approx(tr.window_ms - tr.busy_ms, rel=1e-2)


def _pcg_calls(monkeypatch, g, cfg, poll_every=None):
    """The arguments of every ``pcg`` call of one packed solve of ``g``,
    the solve run with the loop eager."""
    from boslam_torch.solver import schur, schur_packed
    from boslam_torch.solver.optimizer import solve_packed

    calls = []

    def spy(*a, **kw):
        if poll_every is not None:
            kw["poll_every"] = poll_every
        calls.append((a, kw))
        return schur.pcg(*a, **kw, _eager=True)

    with monkeypatch.context() as m:
        m.setattr(schur_packed, "pcg", spy)
        solve_packed(g, cfg)
    return calls


@pytest.mark.parametrize("poll_every", [1, 4, 7])
@pytest.mark.parametrize("precond, loop_closures", [
    ("block_jacobi", 0), ("btridiag", 0), ("two_level", 0), ("bband", 0),
    pytest.param("block_jacobi", 1116, id="block_jacobi-loops")])
def test_captured_pcg_matches_eager_bitwise(cuda, monkeypatch, precond, loop_closures,
                                            poll_every):
    """``pcg`` with its blocks replayed as a CUDA graph against the same
    call with every body launched from the host, on a walk whose body sums
    nothing with atomics (no loop closure, landmark rows not split; or,
    under block-Jacobi, M3500's density of loop closures, which the fused
    body sums per pose in a fixed order): the same bits of x, n_iters,
    rel_res2 and breakdown, the same host counts, and every body after the
    first replayed, through a cap of 30 that is no multiple of the poll
    interval."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver import schur

    g = _graph(2000, 800, cuda, loop_closures)
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner=precond, lm_split=0, iters=2,
                       cg_iters=30, cg_tol=1e-12)
    calls = _pcg_calls(monkeypatch, g, cfg, poll_every)
    assert len(calls) == 2
    for a, kw in calls:
        eager = schur.pcg(*a, **kw, _eager=True)
        graphed = schur.pcg(*a, **kw)
        for u, v in zip(eager[:4], graphed[:4]):
            assert torch.equal(u, v)
        ie, ig = dict(eager[4]), dict(graphed[4])
        assert torch.equal(ie.pop("events"), ig.pop("events"))
        assert ie["matvecs"] > 1 and ie["captures"] == ie["graph_bodies"] == 0
        assert ig == {**ie, "graph_bodies": ie["matvecs"] - 1, "captures": 1}


@pytest.mark.parametrize("below", [1, 0])
def test_a_short_cg_cap_stays_eager(cuda, monkeypatch, below):
    """A cap below ``CG_GRAPH_MIN_ITERS`` launches every body from the
    host, where a capture would cost more than its replays save; at the
    least cap every body but the first is replayed."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver import schur

    g = _graph(2000, 800, cuda)
    cap = schur.CG_GRAPH_MIN_ITERS - below
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=1,
                       cg_iters=cap, cg_tol=1e-12)
    (a, kw), = _pcg_calls(monkeypatch, g, cfg)
    info = schur.pcg(*a, **kw)[4]
    assert info["matvecs"] == cap
    assert (info["captures"], info["graph_bodies"]) == ((0, 0) if below else (1, cap - 1))


def test_captured_pcg_within_the_eager_spread(cuda, monkeypatch):
    """On the benchmark's kind of walk (split landmark rows, so the matvec
    sums with ``index_add_``'s atomics): the captured loop's iterate lies
    from an eager run's no further than twice the farthest of three more
    eager runs from it, with the same iteration count and breakdown."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver import schur

    g = _graph(2000, 800, cuda)
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=2,
                       cg_iters=100)
    for a, kw in _pcg_calls(monkeypatch, g, cfg):
        eager = [schur.pcg(*a, **kw, _eager=True) for _ in range(4)]
        graphed = [schur.pcg(*a, **kw) for _ in range(3)]
        x0 = eager[0][0]
        spread = max((e[0] - x0).abs().max().item() for e in eager[1:])
        far = max((c[0] - x0).abs().max().item() for c in graphed)
        assert far <= 2 * spread, (far, spread)
        for out in eager[1:] + graphed:
            assert torch.equal(out[1], eager[0][1]) and torch.equal(out[3], eager[0][3])
        assert all(c[4]["graph_bodies"] > 0 for c in graphed)


def test_captured_pcg_counts_the_windowed_launches(cuda, monkeypatch):
    """Under ``gather="windowed"`` a replayed body adds to every kernel's
    launch counter what an eager body adds: the captured and the eager
    solve count the same launches of every kernel, ``windowed_take``'s
    5 + 2 k per outer, and every body but each outer's first is replayed."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.ops import counters
    from boslam_torch.ops import windowed_gather as wg
    from boslam_torch.solver import schur, schur_packed
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.synth import generate_sequence
    from boslam_torch.utils import spans

    ig, _ = generate_sequence(600, 240, seed=3, turn_every=10**9)
    g = build_graph(ig, init="triangulate", device="cpu")[0].to(cuda)
    cfg = SolverConfig(linear_solver="schur_cg", gather="windowed", iters=2, cg_iters=30,
                       cg_tol=1e-12)
    counted, takes = [], []
    for eager in (True, False):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(schur_packed, "pcg",
                          lambda *a, **kw: schur.pcg(*a, **kw, _eager=True))
            before, take = counters.read(), wg.windowed_take.launches
            _, st = solve_packed(g, cfg)
            counted.append([a - b for a, b in zip(counters.read(), before)])
            takes.append(wg.windowed_take.launches - take)
        assert takes[-1] == sum(5 + 2 * int(k) for k in st["cg_matvecs"])
    rec = [r for r in spans.records() if r.name == "solve_packed"][-1]
    assert rec.counters["cg.graph_bodies"] == int(st["cg_matvecs"].sum()) - cfg.iters
    assert counted[0] == counted[1] and takes[0] == takes[1] > 0


def _corridor_10k(device, seed=0):
    """The benchmark's 10k corridor (``benchmark/configs/corridor_10k.json``,
    generator seed 0 the first of its pool), built on the card."""
    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(10000, 4000, seed=seed, turn_every=10**9)
    return build_graph(ig, init="triangulate", device=device)[0]


# the corridor cell's solver: GN 5, block-Jacobi PCG capped at 100, windowed
CORRIDOR_CELL = dict(linear_solver="schur_cg", preconditioner="block_jacobi", gather="windowed",
                     iters=5, cg_iters=100, cg_tol=1e-5)
# windowed against take on the card: chi2 at iteration 0 within 1e-5 (one
# state, two orders of a sum), the later ones within 2e-3, the bound of the
# packed trace chain on two orderings of truncated f32 CG (the take path's
# diag(S) and its landmark-keyed sums run in another order)
WINDOWED_VS_TAKE = (1e-5, 2e-3)


def _corridor_solves(monkeypatch, g, cfg):
    """(eager, captured) packed solves of ``g``: (final graph, stats, the
    solve_packed root's counters, every kernel counter's difference)."""
    from boslam_torch.ops import counters
    from boslam_torch.solver import schur, schur_packed
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.utils import spans

    out = []
    for eager in (True, False):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(schur_packed, "pcg",
                          lambda *a, **kw: schur.pcg(*a, **kw, _eager=True))
            before = counters.read()
            final, st = solve_packed(g, cfg)
            torch.cuda.synchronize()
            counted = [a - b for a, b in zip(counters.read(), before)]
        rec = [r for r in spans.records() if r.name == "solve_packed"][-1]
        out.append((final, st, rec.counters, counted))
    return out


def test_captured_windowed_pcg_matches_eager_bitwise(cuda, monkeypatch):
    """On the benchmark's 10k corridor with every gather windowed (no split
    landmark row and an odometry chain, so the body sums nothing with
    atomics): each ``pcg`` call replayed from its graph gives the eager
    loop's bits, and so does the whole solve: chi2 trace, CG iterations and
    final state, with every body after each outer's first replayed."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver import schur

    g = _corridor_10k(cuda)
    cfg = SolverConfig(**CORRIDOR_CELL)
    calls = _pcg_calls(monkeypatch, g, cfg)
    assert len(calls) == cfg.iters
    for a, kw in calls:
        eager = schur.pcg(*a, **kw, _eager=True)
        graphed = schur.pcg(*a, **kw)
        for u, v in zip(eager[:4], graphed[:4]):
            assert torch.equal(u, v)
        ie, ig = dict(eager[4]), dict(graphed[4])
        assert torch.equal(ie.pop("events"), ig.pop("events"))
        assert ig == {**ie, "graph_bodies": ie["matvecs"] - 1, "captures": 1}
    (fe, se, _, _), (fg, sg, counted, _) = _corridor_solves(monkeypatch, g, cfg)
    for k in ("chi2_robust", "cg_iters", "cg_matvecs"):
        assert torch.equal(se[k], sg[k]), k
    assert torch.equal(fe.poses, fg.poses) and torch.equal(fe.landmarks, fg.landmarks)
    assert counted["cg.graph_bodies"] == int(sg["cg_matvecs"].sum()) - cfg.iters


def test_replayed_corridor_solve_counts_the_gathers_routes(cuda, monkeypatch):
    """A replay charges the gathers' route counters what the captured body
    counted, the capture nothing: after a captured solve of the 10k corridor
    "gather.windowed" and "gather.plain" equal the eager solve's, every
    gather is windowed, 5 + 2 k per outer (k matvecs); the 5 outside the CG
    loop are each one launch of ``windowed_take``, and the 2 of each body
    are read by the fused body, one ``pcg_body`` launch a body."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import counters, pcg_body as pb
    from boslam_torch.ops import windowed_gather as wg

    g = _corridor_10k(cuda)
    cfg = SolverConfig(**CORRIDOR_CELL)
    runs = _corridor_solves(monkeypatch, g, cfg)
    launches = counters._COUNTERS.index((wg.windowed_take, "launches"))
    fused = counters._COUNTERS.index((pb.pcg_body, "launches"))
    for _, st, rec, counted in runs:
        bodies = int(st["cg_matvecs"].sum())
        assert rec["gather.windowed"] == 5 * cfg.iters + 2 * bodies
        assert counted[launches] == 5 * cfg.iters and counted[fused] == bodies
        assert rec["gather.plain"] == 0 and rec["cg.fused_bodies"] == rec["cg.bodies"] == bodies
    (_, _, eager, counted_e), (_, _, graphed, counted_g) = runs
    routes = ("gather.windowed", "gather.plain", "cg.bodies", "cg.fused_bodies")
    assert {k: eager[k] for k in routes} == {k: graphed[k] for k in routes}
    assert counted_e == counted_g and graphed["cg.graph_bodies"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_windowed_corridor_solve_against_take_on_the_card(cuda, seed):
    """The 10k corridor solved with windowed gathers against plain ones on
    the card, both captured: the chi2 trace within ``WINDOWED_VS_TAKE``."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver.optimizer import solve_packed

    g = _corridor_10k(cuda, seed)
    cfg = SolverConfig(**CORRIDOR_CELL)
    c_w = solve_packed(g, cfg)[1]["chi2_robust"].cpu().numpy()
    c_t = solve_packed(g, cfg.replace(gather="take"))[1]["chi2_robust"].cpu().numpy()
    rel = np.abs(c_w.astype(np.float64) - c_t) / c_t
    first, later = WINDOWED_VS_TAKE
    assert rel[0] <= first and (rel[1:] <= later).all(), rel.tolist()


def test_captured_pcg_gives_its_memory_back(cuda, monkeypatch):
    """Twenty captured ``pcg`` calls after a first: the allocated memory
    returns to its level before them, and the reserved memory does not
    grow (every capture draws on one pool)."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver import schur

    g = _graph(2000, 800, cuda)
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=1,
                       cg_iters=40)
    (a, kw), = _pcg_calls(monkeypatch, g, cfg)
    schur.pcg(*a, **kw)
    torch.cuda.synchronize()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    for _ in range(20):
        out = schur.pcg(*a, **kw)
        assert out[4]["captures"] == 1
        del out
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == allocated
    assert torch.cuda.memory_reserved() == reserved


def test_profiler_sees_the_replayed_bodies(cuda, monkeypatch):
    """A profiler session over a captured packed solve records the
    replayed bodies' kernels: every kernel of the eager solve as many
    times, and beyond them only a few operations at each capture (the
    state's copy into its fixed buffers), also under the span
    "solve_packed/step/pcg"."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.solver import schur, schur_packed
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.utils import profiling

    g = _graph(2000, 800, cuda)
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=2,
                       cg_iters=40)

    def run():
        out, _ = solve_packed(g, cfg)
        return out.poses.cpu()

    run()
    captured = profiling.device_time_by_kernel(run, cuda)
    with monkeypatch.context() as m:
        m.setattr(schur_packed, "pcg", lambda *a, **kw: schur.pcg(*a, **kw, _eager=True))
        run()
        eager = profiling.device_time_by_kernel(run, cuda)
    n_of = lambda tr, k: tr.kernels.get(k, (0, 0))[1]  # noqa: E731
    lost = {k: n - n_of(captured, k) for k, (_, n) in eager.kernels.items()
            if n_of(captured, k) < n}
    extra = {k: n - n_of(eager, k) for k, (_, n) in captured.kernels.items()
             if n > n_of(eager, k)}
    assert not lost, lost
    budget = 2 * len(schur.CGState._fields) * cfg.iters
    assert captured.n_ops - eager.n_ops == sum(extra.values()) <= budget, extra
    pcg_ops = [tr.by_span["solve_packed/step/pcg"][1] for tr in (captured, eager)]
    assert 0 <= pcg_ops[0] - pcg_ops[1] <= budget


# ---- the fused block-Jacobi CG body (ops/pcg_body.py) ----

def _pcg_body_probe():
    """``tools/port_pcg_body_probe.py`` as a module (its helpers build the
    benchmark's packed systems and compare one body)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "port_pcg_body_probe.py")
    spec = importlib.util.spec_from_file_location("port_pcg_body_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_PACKED_10K = {}


def _packed_10k(kind):
    """The first GN outer's packed system of the benchmark's 10k walk (split
    landmark rows, plain gathers), corridor (both grids windowed) or
    loop-closing walk (the walk with 5,583 loop closures), block-Jacobi:
    (blocks, pk, mask, precond, rhs, graph), built once per run."""
    if kind not in _PACKED_10K:
        _PACKED_10K[kind] = _pcg_body_probe().packed_system(kind, 10000, 0, "cuda")
    return _PACKED_10K[kind]


# ``pcg`` to the cap (100, cg_tol 1e-5), the fused body captured against
# its own body eager on the 10k graphs: the iterate's gap over its largest
# entry, and the ratio of the relative residuals (PERF.md section 6)
PCG_CAP_X = 0.05
PCG_CAP_RES = 0.1


@pytest.mark.parametrize("kind", ["walk", "corridor", "loops"])
def test_fused_body_one_body_on_the_card(cuda, kind):
    """The kernel's body from the start state and from a mid-loop state
    with a fixed pose mid-chain, both against the twin in float64 within
    the probe's bounds (``one_body_misses``: the bulk of A p, x, r, z, p and
    x_best as near as the f32 twin's, the scalars within 1e-3), the counts
    equal; a frozen state kept to the bit; two replays of one captured body
    bit-equal."""
    probe = _pcg_body_probe()
    blocks, pk, mask, precond, rhs, g = _packed_10k(kind)
    assert (pk.l_virt is not None) == (kind != "corridor")
    assert (pk.p_plan is not None and pk.l_plan is not None) == (kind == "corridor")
    assert (pk.loops is not None) == (kind == "loops")
    bound = probe.bind(blocks, pk, mask, precond, rhs)
    mid = torch.ones_like(mask)
    mid[g.n_poses // 2] = 0.0
    bound_m = probe.bind(blocks, pk, mid, precond, rhs * mid)
    system_m, twin_m = bound_m[:2]
    from boslam_torch.ops.pcg_body import pcg_body
    from boslam_torch.solver.schur import CGState

    s = probe.start_state(precond, rhs * mid)
    for _ in range(10):
        s = twin_m(s)
    for label, b, st, m in (("start", bound, probe.start_state(precond, rhs), mask),
                            ("mid_chain", bound_m, s, mid)):
        rec = probe.one_body(b, st, blocks, pk, m)
        assert rec["same_counts"] and not probe.one_body_misses(rec), (label, rec)
    frozen = s._replace(active=torch.zeros_like(s.active))
    for out in (None, CGState(*(t.clone() for t in frozen))):
        for a, b in zip(pcg_body(system_m, frozen, out), frozen):
            assert torch.equal(a, b)
    state = CGState(*(t.clone() for t in s))
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        pcg_body(system_m, state, state)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    outs = []
    for _ in range(2):
        for t, t0 in zip(state, s):
            t.copy_(t0)
        graph.replay()
        outs.append([t.clone() for t in state])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert not torch.equal(outs[0][0], s.x)


@pytest.mark.parametrize("kind", ["walk", "corridor", "loops"])
def test_fused_pcg_to_the_cap_on_the_card(cuda, kind):
    """``pcg`` with the fused body, captured, against ``pcg`` with its own
    body, eager, to the cap of the benchmark's cells: the same iteration
    count and breakdown, the residual within ``PCG_CAP_RES`` and the
    iterate within ``PCG_CAP_X``; every body fused, all but the first
    replayed."""
    from boslam_torch.solver import schur
    from boslam_torch.solver import schur_packed as sp

    blocks, pk, mask, precond, rhs, _ = _packed_10k(kind)
    mv = lambda x: sp.packed_s_matvec(blocks, pk, x, mask)  # noqa: E731
    want = schur.pcg(mv, rhs, precond, 100, 1e-5, _eager=True)
    got = schur.pcg(mv, rhs, precond, 100, 1e-5,
                    make_body=functools.partial(sp.fused_cg_body, blocks, pk, mask, precond))
    x_gap = _pcg_body_probe().gap(got[0], want[0])
    res = float(got[2]) / float(want[2])
    assert int(got[1]) == int(want[1]) and bool(got[3]) == bool(want[3])
    assert x_gap <= PCG_CAP_X and abs(res - 1) <= PCG_CAP_RES, (x_gap, res)
    info = got[4]
    assert info["fused_bodies"] == info["matvecs"] == info["graph_bodies"] + 1
    assert want[4]["fused_bodies"] == 0


@pytest.mark.parametrize("variant", ["indefinite", "curvature"])
def test_fused_body_restarts_on_the_card(cuda, variant):
    """The restart paths on the corridor's system: an indefinite apply
    (a third of the block-Jacobi blocks negated) and a curvature breakdown
    (the pose blocks shifted down, S indefinite): the fused loop breaks down
    as the loop with its own body does, the same events and iterations,
    and returns its best iterate within ``PCG_CAP_X``."""
    from boslam_torch.solver import schur
    from boslam_torch.solver import schur_packed as sp

    blocks, pk, mask, precond, rhs, _ = _packed_10k("corridor")
    if variant == "indefinite":
        precond = precond.clone()
        precond[: precond.shape[0] // 3] *= -1.0
    else:
        shift = blocks.Hpp_diag.diagonal(dim1=1, dim2=2).median()
        blocks = blocks._replace(
            Hpp_diag=blocks.Hpp_diag - shift * torch.eye(3, device=rhs.device))
    mv = lambda x: sp.packed_s_matvec(blocks, pk, x, mask)  # noqa: E731
    want = schur.pcg(mv, rhs, precond, 25, 1e-12, restarts=3, _eager=True)
    got = schur.pcg(mv, rhs, precond, 25, 1e-12, restarts=3,
                    make_body=functools.partial(sp.fused_cg_body, blocks, pk, mask, precond))
    assert bool(want[3]) and int(want[4]["events"]) > 0
    assert int(got[4]["events"]) == int(want[4]["events"])
    assert int(got[1]) == int(want[1]) and bool(got[3])
    x_gap = _pcg_body_probe().gap(got[0], want[0])
    assert x_gap <= PCG_CAP_X, x_gap


def test_fused_body_refuses_a_plan_it_cannot_read(cuda):
    """A plan whose row tiles are not whole blocks of the kernel's rows, or
    whose window it cannot stage, fails loudly at the launch (the kernel's
    own check): the solver does not fall back to another body."""
    import dataclasses as dc

    from boslam_torch.ops import pcg_body as pb
    from boslam_torch.solver import schur
    from boslam_torch.solver import schur_packed as sp

    blocks, pk, mask, precond, rhs, _ = _packed_10k("corridor")
    plan = pk.l_plan
    rows = pk.l_pose.shape[0]
    odd = dc.replace(plan, tile_rows=48, starts=torch.zeros(-(-rows // 48), dtype=torch.int32,
                                                            device=rhs.device))
    for bad in (odd, dc.replace(plan, window=2048)):
        pk_bad = dc.replace(pk, l_plan=bad)
        mv = lambda x: sp.packed_s_matvec(blocks, pk_bad, x, mask)  # noqa: E731
        make = functools.partial(sp.fused_cg_body, blocks, pk_bad, mask, precond)
        before = pb.pcg_body.launches
        with pytest.raises(RuntimeError, match="pcg_body"):
            schur.pcg(mv, rhs, precond, 10, 1e-5, make_body=make)
        assert pb.pcg_body.launches == before


def test_fused_body_counts_on_the_card(cuda, monkeypatch):
    """On the 10k walk (plain gathers) a captured solve counts what an eager
    one does: one ``pcg_body`` launch a body, the gathers' route counters
    4 + 2 k plain per outer, "cg.fused_bodies" equal to "cg.bodies", and no
    ``windowed_take``."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.ops import counters, pcg_body as pb
    from boslam_torch.ops import windowed_gather as wg
    from boslam_torch.solver import schur, schur_packed
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.synth import generate_sequence
    from boslam_torch.utils import spans

    ig, _ = generate_sequence(10000, 4000, seed=0)
    g = build_graph(ig, init="triangulate", device=cuda)[0]
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=2,
                       cg_iters=40, cg_tol=1e-5)
    seen = []
    for eager in (True, False):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(schur_packed, "pcg", lambda *a, **kw: schur.pcg(*a, **kw, _eager=True))
            before = counters.read()
            _, st = solve_packed(g, cfg)
            torch.cuda.synchronize()
            counted = dict(zip(counters._COUNTERS, (a - b for a, b in zip(counters.read(),
                                                                         before))))
        rec = [r for r in spans.records() if r.name == "solve_packed"][-1].counters
        bodies = int(st["cg_matvecs"].sum())
        assert counted[(pb.pcg_body, "launches")] == bodies == rec["cg.fused_bodies"]
        assert rec["cg.bodies"] == bodies and counted[(wg.windowed_take, "launches")] == 0
        assert rec["cg.loop_fused_bodies"] == 0
        assert rec["gather.plain"] == 4 * cfg.iters + 2 * bodies and rec["gather.windowed"] == 0
        seen.append((counted, {k: rec[k] for k in ("gather.plain", "cg.bodies",
                                                   "cg.fused_bodies")}))
    assert seen[0] == seen[1]


def test_no_fused_body_off_its_systems(cuda):
    """CUDA solves outside the fused body's systems launch no ``pcg_body``
    and count no fused body: btridiag, bf16 coupling blocks, row chunks,
    loop closures under btridiag, and a one-rank mesh (the sharded packed
    layout)."""
    import torch.distributed as dist

    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import pcg_body as pb
    from boslam_torch.parallel.mesh import make_mesh
    from boslam_torch.parallel.sharded_packed import sharded_packed_solve
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.utils import spans

    g = _graph(2000, 800, cuda)
    bj = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=2,
                      cg_iters=20)
    before = pb.pcg_body.launches
    solve_packed(g, bj)
    assert pb.pcg_body.launches > before  # the rule's system takes it
    runs = [(g, bj.replace(preconditioner="btridiag")),
            (g, bj.replace(coupling_dtype="bfloat16")),
            (g, bj.replace(matvec_row_chunk=256)),
            (_graph(2000, 800, cuda, loop_closures=8), bj.replace(preconditioner="btridiag"))]
    for graph, cfg in runs:
        before = pb.pcg_body.launches
        solve_packed(graph, cfg)
        rec = [r for r in spans.records() if r.name == "solve_packed"][-1].counters
        assert pb.pcg_body.launches == before and rec["cg.fused_bodies"] == 0, cfg
        assert rec["cg.loop_fused_bodies"] == 0, cfg
    mesh = make_mesh("cuda")
    try:
        before = pb.pcg_body.launches
        sharded_packed_solve(g, bj, mesh)
        assert pb.pcg_body.launches == before
    finally:
        dist.destroy_process_group()


def test_fused_body_repeats_bitwise_on_loop_closures(cuda):
    """On the 10k loop-closing walk the kernel sums each pose's loop
    closures in a fixed order with no atomics: 200 bodies from one state,
    each into new tensors, give one set of bits, one ``pcg_body`` launch
    a body."""
    from boslam_torch.ops import pcg_body as pb

    probe = _pcg_body_probe()
    blocks, pk, mask, precond, rhs, _ = _packed_10k("loops")
    system, twin = probe.bind(blocks, pk, mask, precond, rhs)[:2]
    s = probe.start_state(precond, rhs)
    for _ in range(10):
        s = twin(s)
    assert system.loops is not None
    before = pb.pcg_body.launches
    first = pb.pcg_body(system, s)
    for _ in range(199):
        again = pb.pcg_body(system, s)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert pb.pcg_body.launches - before == 200
    assert not torch.equal(first[0], s.x)


def test_fused_body_counts_loop_closures_on_the_card(cuda, monkeypatch):
    """A packed block-Jacobi solve of a walk with M3500's density of loop
    closures runs every body fused with loop rows: eager and captured, one
    ``pcg_body`` launch a body, the root's "cg.bodies", "cg.fused_bodies"
    and "cg.loop_fused_bodies" equal, and every fused body bound to the
    packing's loop rows; the same solve of the chain walk fuses every body
    with no loop rows ("cg.loop_fused_bodies" 0)."""
    from boslam_torch.config import SolverConfig
    from boslam_torch.ops import counters, pcg_body as pb
    from boslam_torch.solver import schur, schur_packed
    from boslam_torch.solver.optimizer import solve_packed
    from boslam_torch.utils import spans

    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi", iters=2,
                       cg_iters=40, cg_tol=1e-5)
    names = ("cg.bodies", "cg.fused_bodies", "cg.loop_fused_bodies")
    fused = schur_packed.fused_cg_body
    for loops in (1116, 0):
        g = _graph(2000, 800, cuda, loop_closures=loops)
        seen = []
        for eager in (True, False):
            bound = []

            def spy(blocks, pk, *a, **kw):
                bound.append(pk.loops is not None)
                return fused(blocks, pk, *a, **kw)

            with monkeypatch.context() as m:
                m.setattr(schur_packed, "fused_cg_body", spy)
                if eager:
                    m.setattr(schur_packed, "pcg",
                              lambda *a, **kw: schur.pcg(*a, **kw, _eager=True))
                before = counters.read()
                _, st = solve_packed(g, cfg)
                torch.cuda.synchronize()
                counted = dict(zip(counters._COUNTERS, (a - b for a, b in zip(counters.read(),
                                                                             before))))
            rec = [r for r in spans.records() if r.name == "solve_packed"][-1].counters
            bodies = int(st["cg_matvecs"].sum())
            assert counted[(pb.pcg_body, "launches")] == bodies
            assert tuple(rec[k] for k in names) == (bodies, bodies, bodies if loops else 0)
            assert bound == [bool(loops)] * cfg.iters
            seen.append((counted, tuple(rec[k] for k in names)))
        assert seen[0] == seen[1]
