"""The CG pieces against the JAX package on the CPU: the block-tridiagonal
chain preconditioner, the 3x3 closed forms, ``pcg`` on fixed systems, and
the flat ``schur_cg`` path (matvec, diagonal, whole solves); the port
alone: the fused CG body's plain twin and rule, and the one helper that builds
every path's preconditioner.

Tolerances: the closed forms and btridiag at rtol 1e-5 against JAX (both
f32, the same expression order); btridiag against f64 at the JAX bound
(test_btridiag.py:53); pcg's iterate at rtol 1e-4 with the same iteration
count; whole flat solves as the packed ones (tests/test_torch_packed.py).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.solver import btridiag as bt_jax
from boslam.solver import optimizer as opt_jax
from boslam.solver import schur as schur_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.build import build_graph
from boslam_torch.graph.data import FactorGraph
from boslam_torch.solver import btridiag as bt
from boslam_torch.solver import optimizer as opt
from boslam_torch.solver import schur


# two intra-op threads a test: the suite's workers share the cores
@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_spd_chain(n, rng):
    upper = rng.standard_normal((n - 1, 3, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3, 3)).astype(np.float32)
    diag = (np.einsum("nij,nkj->nik", d, d) + 8.0 * np.eye(3)).astype(np.float32)
    return diag, upper


def _close(a, b, rtol=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("fn", ["_chol3x3", "_inv_lower3x3", "_specnorm3x3", "_inv3x3"])
def test_closed_forms_match_jax(fn):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((200, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    if fn == "_inv_lower3x3":
        A = np.tril(A)
    port = getattr(schur if fn == "_inv3x3" else bt, fn)
    ref = getattr(schur_jax if fn == "_inv3x3" else bt_jax, fn)
    _close(port(torch.from_numpy(A)).numpy(), ref(jnp.asarray(A)))


@pytest.mark.parametrize("n", [1, 2, 5, 17, 100, 257])
@pytest.mark.parametrize("clamp_band", [None, 0.4999])
def test_btridiag_matches_jax(n, clamp_band):
    """Factor and solve a random SPD chain in both packages (prescaled, with
    and without the band clamp)."""
    rng = np.random.default_rng(n)
    diag, upper = _random_spd_chain(n, rng)
    rhs = rng.standard_normal((n, 3)).astype(np.float32)
    x = bt.btridiag_solve(bt.btridiag_factor(torch.from_numpy(diag), torch.from_numpy(upper),
                                             clamp_band=clamp_band), torch.from_numpy(rhs))
    x_j = bt_jax.btridiag_solve(bt_jax.btridiag_factor(jnp.asarray(diag), jnp.asarray(upper),
                                                       clamp_band=clamp_band), jnp.asarray(rhs))
    _close(x.numpy(), x_j)
    if clamp_band is None:
        T = bt.btridiag_dense(torch.from_numpy(diag), torch.from_numpy(upper)).double().numpy()
        np.testing.assert_allclose(T, np.asarray(bt_jax.btridiag_dense(jnp.asarray(diag),
                                                                       jnp.asarray(upper))))
        want = np.linalg.solve(T, rhs.reshape(-1).astype(np.float64)).reshape(n, 3)
        np.testing.assert_allclose(x.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_btridiag_f32_slam_like_conditioning():
    """f32 with SLAM-like block scales (odometry omega ~5000, damping 0.01),
    against f64 at test_btridiag.py:53's bound, unscaled and prescaled."""
    n = 257
    rng = np.random.default_rng(0)
    upper = rng.standard_normal((n - 1, 3, 3)).astype(np.float32)
    upper = upper * np.asarray([500.0, 500.0, 5000.0], np.float32)[None, :, None]
    diag = np.einsum("nij,nkj->nik", upper, upper) + np.einsum("nji,njk->nik", upper, upper)
    diag = (np.concatenate([diag, diag[-1:]]) / 100.0 + 1e4 * np.eye(3)).astype(np.float32)
    rhs = rng.standard_normal((n, 3)).astype(np.float32)
    T = bt.btridiag_dense(torch.from_numpy(diag), torch.from_numpy(upper)).double().numpy()
    x_ref = np.linalg.solve(T, rhs.astype(np.float64).reshape(-1)).reshape(n, 3)
    for prescale in (False, True):
        f = bt.btridiag_factor(torch.from_numpy(diag), torch.from_numpy(upper), prescale=prescale)
        x = bt.btridiag_solve(f, torch.from_numpy(rhs)).double().numpy()
        resid = np.linalg.norm(T @ x.reshape(-1) - rhs.reshape(-1))
        assert resid / np.linalg.norm(rhs) < 1e-4
        np.testing.assert_allclose(x, x_ref, rtol=2e-3, atol=2e-3)


def test_btridiag_clamped_pd_with_indefinite_diag():
    """The 0.4999 clamp keeps the apply finite and positive with indefinite
    diagonal blocks (test_btridiag.py:145), as in the JAX package."""
    N = 4096
    d = np.tile(np.diag([500.0, 500.0, 5000.0]).astype(np.float32), (N, 1, 1))
    u = -0.499 * d[:-1]
    for i in (17, 1000, 3000):
        d[i] = np.diag([-0.23, 0.01, 0.01]).astype(np.float32)
    r = np.random.default_rng(1).standard_normal((N, 3)).astype(np.float32)
    z = bt.btridiag_solve(bt.btridiag_factor(torch.from_numpy(d), torch.from_numpy(u),
                                             clamp_band=0.4999), torch.from_numpy(r)).numpy()
    z_j = bt_jax.btridiag_solve(bt_jax.btridiag_factor(jnp.asarray(d), jnp.asarray(u),
                                                       clamp_band=0.4999), jnp.asarray(r))
    assert np.isfinite(z).all() and float((r * z).sum()) > 0
    _close(z, z_j)


def _spd_system(n, rng, cond=1e3):
    Q, _ = np.linalg.qr(rng.standard_normal((3 * n, 3 * n)))
    A = ((Q * np.geomspace(1.0, cond, 3 * n)) @ Q.T).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("poll_every", [1, 4, 7])
@pytest.mark.parametrize("warm", [False, True])
def test_pcg_matches_jax(poll_every, warm):
    """Block-Jacobi PCG on a fixed SPD system: the same iteration count, the
    iterate at rtol 1e-4, no breakdown; at most poll_every - 1 frozen bodies
    past the JAX loop's count.  Condition 30, so that each iteration cuts
    the residual well past f32 rounding and the stopping test falls on the
    same iteration in both (at 1e3 it stops at 154 in one, 155 in the
    other)."""
    rng = np.random.default_rng(7)
    n = 40
    A, b = _spd_system(n, rng, cond=30.0)
    blocks = np.stack([np.linalg.inv(A[3 * i:3 * i + 3, 3 * i:3 * i + 3]) for i in range(n)])
    x0 = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)) if warm else None
    (x, k, rel, brk, info), (xj, kj, relj, brkj) = _run_pcg_poll(A, b, blocks, x0, poll_every)
    assert int(k) == int(kj) and 0 < int(k) < 200
    assert bool(brk) == bool(brkj) is False
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4 * np.abs(xj).max())
    assert float(rel) <= 1e-10
    ran = info["matvecs"] - (1 if warm else 0)
    assert int(k) <= ran <= int(k) + poll_every - 1
    assert info["polls"] == -(-ran // poll_every) + (ran % poll_every == 0)


def _run_pcg_poll(A, b, blocks, x0, poll_every):
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    out = schur.pcg(lambda x: (At @ x.reshape(-1)).reshape(-1, 3), torch.from_numpy(b),
                    torch.from_numpy(blocks.astype(np.float32)), 200, 1e-5, x0=x0, restarts=8,
                    poll_every=poll_every)
    out_j = schur_jax.pcg(lambda x: (Aj @ x.reshape(-1)).reshape(-1, 3), jnp.asarray(b),
                          jnp.asarray(blocks.astype(np.float32)), 200, 1e-5,
                          x0=None if x0 is None else jnp.asarray(x0.numpy()), restarts=8)
    return out, out_j


@pytest.mark.parametrize("restarts", [0, 2, 8])
def test_pcg_restarts_with_indefinite_preconditioner(restarts):
    """An indefinite block preconditioner (a negated block) makes r^T z <= 0:
    the same breakdown flag, count and best-residual iterate as JAX."""
    rng = np.random.default_rng(3)
    n = 30
    A, b = _spd_system(n, rng, cond=1e2)
    blocks = np.stack([np.linalg.inv(A[3 * i:3 * i + 3, 3 * i:3 * i + 3]) for i in range(n)])
    blocks[: n // 2] *= -1.0
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    x, k, rel, brk, _ = schur.pcg(lambda v: (At @ v.reshape(-1)).reshape(-1, 3),
                                  torch.from_numpy(b), torch.from_numpy(blocks.astype(np.float32)),
                                  60, 1e-6, restarts=restarts)
    xj, kj, relj, brkj = schur_jax.pcg(lambda v: (Aj @ v.reshape(-1)).reshape(-1, 3),
                                       jnp.asarray(b), jnp.asarray(blocks.astype(np.float32)),
                                       60, 1e-6, restarts=restarts)
    assert bool(brk) and bool(brkj)
    assert int(k) == int(kj)
    np.testing.assert_allclose(float(rel), float(relj), rtol=1e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4 * np.abs(xj).max())



def _pcg_loop_before_the_factored_body(matvec, rhs, precond, max_iters, tol, x0=None,
                                       restarts=0, poll_every=schur.CG_POLL_EVERY):
    """``schur.pcg`` as it was before its body became one function: the
    loop written out, as the oracle of the factored body's bits."""
    apply_m = precond if callable(precond) else (
        lambda r: torch.einsum("pij,pj->pi", precond, r))
    dot = lambda u, v: torch.sum(u * v)  # noqa: E731
    tiny = torch.finfo(rhs.dtype).tiny
    tol2 = tol * tol
    matvecs = polls = 0
    if x0 is None:
        x0 = torch.zeros_like(rhs)
        r0 = rhs
    else:
        r0 = rhs - matvec(x0)
        matvecs += 1
    z0 = apply_m(r0)
    rz0 = dot(r0, z0)
    b2 = torch.clamp(dot(rhs, rhs), min=tiny)
    rr0 = dot(r0, r0)
    first_bad = (rz0 <= 0) & (rr0 / b2 > tol2)
    d0 = torch.where(first_bad, r0, z0)
    x, r, z, p = x0, r0, d0, d0
    rz = torch.where(first_bad, rr0, rz0)
    nbrk = first_bad.to(torch.int32)
    k = torch.zeros((), dtype=torch.int32)
    x_best, rr_best, rr = x0, rr0, rr0

    def cond(k, nbrk, rr):
        return (nbrk <= restarts) & (k < max_iters) & (rr / b2 > tol2)

    active = cond(k, nbrk, rr)
    for it in range(max_iters):
        if it % poll_every == 0:
            polls += 1
            if not bool(active):
                break
        Ap = matvec(p)
        matvecs += 1
        pAp = dot(p, Ap)
        curv_ok = pAp > 0
        alpha = torch.where(curv_ok, rz, 0.0) / torch.where(curv_ok, pAp, 1.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        rr_n = dot(r_n, r_n)
        better = rr_n < rr_best
        x_best_n = torch.where(better, x_n, x_best)
        rr_best_n = torch.where(better, rr_n, rr_best)
        z_n = apply_m(r_n)
        rz_new = dot(r_n, z_n)
        rz_ok = rz_new > 0
        healthy = curv_ok & rz_ok
        beta = torch.where(healthy, rz_new, 0.0) / torch.clamp(rz, min=tiny)
        z_eff = torch.where(rz_ok, z_n, r_n)
        rz_eff = torch.where(rz_ok, rz_new, rr_n)
        p_n = z_eff + beta * p
        nbrk_n = nbrk + (~healthy).to(torch.int32)
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        z = torch.where(active, z_eff, z)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_eff, rz)
        rr = torch.where(active, rr_n, rr)
        nbrk = torch.where(active, nbrk_n, nbrk)
        k = torch.where(active, k + 1, k)
        x_best = torch.where(active, x_best_n, x_best)
        rr_best = torch.where(active, rr_best_n, rr_best)
        active = active & cond(k, nbrk, rr)
    breakdown = nbrk > 0
    x_out = torch.where(breakdown, x_best, x)
    rr_out = torch.where(breakdown, rr_best, rr)
    return x_out, k, rr_out / b2, breakdown, {"matvecs": matvecs, "polls": polls, "events": nbrk}


@pytest.mark.parametrize("poll_every", [1, 4, 7])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("precond", ["blocks", "callable", "indefinite"])
def test_pcg_body_matches_the_loop_before_it(poll_every, warm, precond):
    """The factored CG body, run eagerly (the CPU never captures), gives the
    bits of the loop it replaced: iterate, count, residual, breakdown and
    every host count, through convergence, a cap that is no multiple of
    the poll interval (50) and the restarts of an indefinite
    preconditioner; nothing is replayed."""
    rng = np.random.default_rng(11)
    n = 30
    A, b = _spd_system(n, rng, cond=1e3)
    blocks = np.stack([np.linalg.inv(A[3 * i:3 * i + 3, 3 * i:3 * i + 3]) for i in range(n)])
    if precond == "indefinite":
        blocks[: n // 3] *= -1.0
    M = torch.from_numpy(blocks.astype(np.float32))
    if precond == "callable":
        M = (lambda B: lambda r: torch.einsum("pij,pj->pi", B, r))(M)
    At = torch.from_numpy(A)
    mv = lambda v: (At @ v.reshape(-1)).reshape(-1, 3)  # noqa: E731
    x0 = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)) if warm else None
    kw = dict(x0=x0, restarts=2, poll_every=poll_every)
    for max_iters, tol in ((50, 1e-9), (200, 1e-5)):
        got = schur.pcg(mv, torch.from_numpy(b), M, max_iters, tol, **kw)
        want = _pcg_loop_before_the_factored_body(mv, torch.from_numpy(b), M, max_iters, tol,
                                                  **kw)
        for g_, w_ in zip(got[:4], want[:4]):
            assert torch.equal(g_, w_)
        info, info_w = got[4], want[4]
        assert torch.equal(info.pop("events"), info_w.pop("events"))
        assert info == {**info_w, "graph_bodies": 0, "captures": 0, "fused_bodies": 0}


def test_every_kernel_counter_is_registered():
    """``ops.counters`` reads and charges every kernel wrapper's launch
    counters, the band route's too, the fused CG body's, and the packed
    gathers' route counters, in the order they were registered."""
    from boslam_torch.ops import cholesky, counters, gn_step, pcg_body, schur_solve
    from boslam_torch.ops import windowed_gather
    from boslam_torch.solver import schur_packed

    assert set(counters._COUNTERS) == {
        (windowed_gather.windowed_take, "launches"), (cholesky.cholesky_solve_padded, "launches"),
        (schur_solve.fused_schur_solve_blocks, "launches"),
        (schur_solve.fused_schur_solve_blocks, "band_launches"),
        (gn_step.fused_gn_step, "launches"), (gn_step.fused_gn_step, "band_launches"),
        (pcg_body.pcg_body, "launches"),
        (schur_packed._take, "windowed"), (schur_packed._take, "plain")}
    before = counters.read()
    i = counters._COUNTERS.index((windowed_gather.windowed_take, "launches"))
    step = [k + 1 for k in range(len(before))]
    counters.add(step)
    assert windowed_gather.windowed_take.launches == before[i] + i + 1
    counters.add([-k for k in step])
    assert counters.read() == before


def _graphs(loop_closures=0):
    ig, _ = generate_sequence(300, 120, seed=11, loop_closures=loop_closures)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


@pytest.mark.parametrize("loop_closures", [0, 8])
def test_flat_matvec_diag_band_match_jax(loop_closures):
    g, gj = _graphs(loop_closures)
    cfg, cfg_j = SolverConfig(), SolverConfigJax()
    b, _ = schur.build_blocks(g, cfg, cfg.damping)
    b_j, _ = schur_jax.build_blocks(gj, cfg_j, cfg_j.damping)
    mask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    mask_j = schur_jax._pose_mask(gj.n_poses, gj.fixed_pose_ix, jnp.float32)
    x = np.random.default_rng(0).standard_normal((g.n_poses, 3)).astype(np.float32)
    _close(schur.s_matvec(b, g, torch.from_numpy(x), mask).numpy(),
           schur_jax.s_matvec(b_j, gj, jnp.asarray(x), mask_j))
    _close(schur.s_diag_blocks(b, g).numpy(), schur_jax.s_diag_blocks(b_j, gj))
    _close(schur.flat_chain_band(b.Ho_sd, g.o_src, g.o_dst, g.n_poses).numpy(),
           schur_jax.flat_chain_band(b_j, gj))
    # diag(S) agrees to 1e-7 of its largest entry; its 3x3 blocks cancel
    # (condition up to ~1e4), so the inverses and the chain solve agree to
    # 2.7e-4 and 8.8e-4 of their largest entry (measured): held at 2e-3
    for which in ("block_jacobi", "btridiag"):
        M = schur._flat_preconditioner(b, g, cfg.replace(preconditioner=which), mask)
        M_j = schur_jax._flat_preconditioner(b_j, gj, cfg_j.replace(preconditioner=which), mask_j)
        if callable(M):
            _close(M(torch.from_numpy(x)).numpy(), M_j(jnp.asarray(x)), rtol=2e-3)
        else:
            _close(M.numpy(), M_j, rtol=2e-3)


@pytest.mark.parametrize("optimizer, precond", [("gn", "auto"), ("gn", "block_jacobi"),
                                                ("gn", "bband"), ("lm", "auto")])
def test_flat_schur_cg_matches_jax(optimizer, precond):
    """Five flat schur_cg iterations on a loop-closure walk; LM held for two
    trials (see tests/test_torch_packed.py)."""
    g, gj = _graphs(8)
    kw = dict(linear_solver="schur_cg", optimizer=optimizer, preconditioner=precond, iters=5)
    _, st = opt.solve(g, SolverConfig(**kw))
    _, st_j = opt_jax.solve(gj, SolverConfigJax(fused_step="off", **kw))
    c, c_j = st["chi2_robust"].numpy(), np.asarray(st_j["chi2_robust"])
    np.testing.assert_allclose(c[0], c_j[0], rtol=1e-5)
    held = 5 if optimizer == "gn" else 2
    np.testing.assert_allclose(c[:held], c_j[:held], rtol=2e-3)
    for k in ("cg_iters", "cg_rel_res2", "cg_breakdown", "cg_matvecs", "cg_polls"):
        assert st[k].shape == (5,), k
    assert (st["cg_iters"].numpy() > 0).all() and st["spd_ok"].all()


@pytest.mark.parametrize("loop_closures, cycle", [(0, "additive"), (8, "additive"),
                                                   (8, "vcycle")])
def test_flat_schur_cg_two_level_matches_jax(loop_closures, cycle):
    """Flat schur_cg GN under the two-level preconditioner, with and without
    loop closures, both cycles: chi2 at iteration 0 at rtol 1e-5, then five
    iterations at the packed paths' 2e-3 (tests/test_torch_packed.py)."""
    g, gj = _graphs(loop_closures)
    kw = dict(linear_solver="schur_cg", preconditioner="two_level", two_level_cycle=cycle,
              iters=5)
    _, st = opt.solve(g, SolverConfig(**kw))
    _, st_j = opt_jax.solve(gj, SolverConfigJax(fused_step="off", **kw))
    c, c_j = st["chi2_robust"].numpy(), np.asarray(st_j["chi2_robust"])
    np.testing.assert_allclose(c[0], c_j[0], rtol=1e-5)
    np.testing.assert_allclose(c, c_j, rtol=2e-3)
    assert (st["cg_iters"].numpy() > 0).all() and st["spd_ok"].all()


@pytest.mark.parametrize("coarse_q", [0, 7])
def test_flat_two_level_preconditioner_matches_jax(coarse_q):
    import jax

    """The flat two-level apply on a graph's reduced system, against the JAX
    package's, at the 2e-3 of the other chain preconditioners above (diag(S)
    cancels in f32); ``coarse_q`` 7 does not divide the 300 poses."""
    g, gj = _graphs(8)
    cfg = SolverConfig(preconditioner="two_level", coarse_q=coarse_q)
    cfg_j = SolverConfigJax(preconditioner="two_level", coarse_q=coarse_q)
    b, _ = schur.build_blocks(g, cfg, cfg.damping)
    b_j, _ = schur_jax.build_blocks(gj, cfg_j, cfg_j.damping)
    mask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    mask_j = schur_jax._pose_mask(gj.n_poses, gj.fixed_pose_ix, jnp.float32)
    x = np.random.default_rng(1).standard_normal((g.n_poses, 3)).astype(np.float32)
    M = schur._flat_preconditioner(b, g, cfg, mask)
    z = M(torch.from_numpy(x) * mask).numpy()
    z_j = jax.jit(lambda b_j, gj, x: schur_jax._flat_preconditioner(b_j, gj, cfg_j, mask_j)(x))(
        b_j, gj, jnp.asarray(x) * mask_j)
    _close(z, z_j, rtol=2e-3)
    np.testing.assert_array_equal(z[int(g.fixed_pose_ix)], 0.0)


def test_two_level_cuts_cg_iterations():
    """On a 2000-pose walk at a fixed tolerance the two-level preconditioner
    needs fewer CG iterations than block-Jacobi (tests/test_two_level.py:163-180),
    on the packed and on the flat path; the port alone."""
    from boslam_torch.synth import generate_sequence as generate_sequence_torch

    g = build_graph(generate_sequence_torch(2000, 800, seed=0)[0], init="triangulate",
                    device="cpu")[0]
    base = SolverConfig(iters=5, linear_solver="schur_cg", cg_iters=200, cg_tol=1e-4)
    for fn in (opt.solve_packed, opt.solve):
        tl_iters = int(fn(g, base.replace(preconditioner="two_level"))[1]["cg_iters"].sum())
        bj_iters = int(fn(g, base.replace(preconditioner="block_jacobi"))[1]["cg_iters"].sum())
        assert tl_iters < bj_iters, (fn.__name__, tl_iters, bj_iters)


# ---- the fused block-Jacobi body (ops/pcg_body.py) on the packed system ----

@functools.lru_cache(maxsize=None)
def _packed_graph(corridor: bool):
    """A 1200-pose packed graph on the CPU: a walk, whose landmark rows are
    split and whose grids gather plainly, or a corridor, relabeled so that
    the planner accepts both grids' windows."""
    from boslam_torch.graph.packed import pack_edges
    from boslam_torch.graph.reorder import reorder_landmarks_by_pose
    from boslam_torch.synth import generate_sequence as generate_sequence_torch

    ig, _ = generate_sequence_torch(1200, 480, seed=3,
                                    **({"turn_every": 10**9} if corridor else {}))
    g = build_graph(ig, init="triangulate", device="cpu")[0]
    if corridor:
        g = reorder_landmarks_by_pose(g)[0]
    pk, _ = pack_edges(g, windows=corridor)
    assert (pk.l_virt is None) == corridor
    assert (pk.p_plan is not None and pk.l_plan is not None) == corridor
    return g, pk


def _packed_system(corridor: bool, variant: str = "plain"):
    """(blocks, pk, mask, precond, rhs) of the packed system at the graph's
    state under block-Jacobi.  ``variant``: "fixed_mid" pins a pose in the
    middle of the chain (the gauge mask's 0 there), "indefinite" negates a
    third of the preconditioner's blocks (r^T z <= 0: restarts from r),
    "curvature" shifts the pose blocks down so that S is indefinite
    (p^T A p <= 0: restarts from z)."""
    from boslam_torch.solver import schur_packed as sp

    g, pk = _packed_graph(corridor)
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi")
    blocks, _ = sp.build_packed_blocks(g, pk, cfg, cfg.damping)
    mask = sp._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    if variant == "fixed_mid":
        mask = torch.ones_like(mask)
        mask[g.n_poses // 2] = 0.0
    if variant == "curvature":
        shift = blocks.Hpp_diag.diagonal(dim1=1, dim2=2).median()
        blocks = blocks._replace(Hpp_diag=blocks.Hpp_diag - shift * torch.eye(3))
    precond = sp._packed_preconditioner(blocks, pk, cfg, mask)
    if variant == "indefinite":
        precond = precond.clone()
        precond[: g.n_poses // 3] *= -1.0
    rhs = torch.from_numpy(np.random.default_rng(5).standard_normal((g.n_poses, 3))
                           .astype(np.float32)) * mask
    return blocks, pk, mask, precond, rhs


@pytest.mark.parametrize("variant", ["plain", "fixed_mid", "indefinite", "curvature"])
@pytest.mark.parametrize("corridor", [False, True], ids=["walk", "corridor"])
def test_fused_twin_matches_the_body(corridor, variant):
    """``pcg`` handed the fused body's plain twin (``make_body``) against
    ``pcg`` with its own body over ``packed_s_matvec``, on a walk (split
    landmark rows, plain gathers) and a corridor (both grids through their
    windows): one body and a short loop give the same bits of x, n_iters,
    rel_res2, breakdown and events, the same host counts, every body
    fused, and the gathers charged two per body by route; the restart
    variants do restart."""
    from boslam_torch.solver import schur_packed as sp

    blocks, pk, mask, precond, rhs = _packed_system(corridor, variant)
    mv = lambda x: sp.packed_s_matvec(blocks, pk, x, mask)  # noqa: E731
    twin = functools.partial(sp.plain_cg_body, blocks, pk, mask, precond)
    for cap in (1, 25):
        want = schur.pcg(mv, rhs, precond, cap, 1e-12, restarts=3)
        before = sp.gather_counts()
        got = schur.pcg(mv, rhs, precond, cap, 1e-12, restarts=3, make_body=twin)
        counted = [a - b for a, b in zip(sp.gather_counts(), before)]
        for g_, w_ in zip(got[:4], want[:4]):
            assert torch.equal(g_, w_)
        info, info_w = dict(got[4]), dict(want[4])
        assert torch.equal(info.pop("events"), info_w.pop("events"))
        assert info == {**info_w, "fused_bodies": info_w["matvecs"]} and info_w["fused_bodies"] == 0
        bodies = info["matvecs"]
        assert counted == ([2 * bodies, 0] if corridor else [0, 2 * bodies])
    if variant in ("indefinite", "curvature"):
        assert int(got[4]["events"]) > 0


@pytest.mark.parametrize("corridor", [False, True], ids=["walk", "corridor"])
def test_fused_twin_frozen_state(corridor):
    """A body of the twin whose state is no longer active changes none of
    the eleven tensors, into new tensors or in place; an active one is
    ``pcg``'s own step over ``packed_s_matvec`` to the bit; the kernel's
    body and system refuse CPU tensors."""
    from boslam_torch.ops import pcg_body as pb
    from boslam_torch.solver import schur_packed as sp

    blocks, pk, mask, precond, rhs = _packed_system(corridor)
    b2 = torch.sum(rhs * rhs)
    body = functools.partial(sp.plain_cg_body, blocks, pk, mask, precond)(b2, 1e-10, 3, 50)
    z = torch.einsum("pij,pj->pi", precond, rhs)
    s = schur.CGState(torch.zeros_like(rhs), rhs, z, z, torch.sum(rhs * z), b2,
                      torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32),
                      torch.zeros_like(rhs), b2, torch.ones((), dtype=torch.bool))
    for _ in range(3):
        s = body(s)
    assert torch.equal(s.k, torch.tensor(3, dtype=torch.int32)) and bool(s.active)
    frozen = s._replace(active=torch.zeros((), dtype=torch.bool))
    for out in (None, schur.CGState(*(t.clone() for t in frozen))):
        new = body(frozen, out=out)
        for a, b in zip(new, frozen):
            assert torch.equal(a, b)
        if out is not None:
            assert all(a is b for a, b in zip(new, out))
    # the twin is pcg's own body over the packed system
    own = schur.cg_step(s, sp.packed_s_matvec(blocks, pk, s.p, mask),
                        lambda r: torch.einsum("pij,pj->pi", precond, r),
                        lambda u, v: torch.sum(u * v), schur.cg_cond(b2, 1e-10, 3, 50))
    for a, b in zip(own, body(s)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA device"):
        sp.fused_cg_body(blocks, pk, mask, precond, b2, 1e-10, 3, 50)
    with pytest.raises(ValueError, match="CUDA device"):
        pb.PCGSystem(blocks.Hpp_diag, precond, blocks.Ho_sd, mask, blocks.Hll_inv, blocks.Bp,
                     pk.p_lm, blocks.Bl, pk.l_pose, pk.l_virt, pk.p_plan, pk.l_plan, b2,
                     1e-10, 3, 50)


def test_fused_body_rule():
    """The fused body is chosen from what the solver sees: on a chain
    odometry with f32 blocks, no mesh, no row chunks and block-Jacobi as the
    resolved preconditioner, and nowhere else (btridiag, two_level, bband,
    bf16 blocks, a mesh, row chunks, edges past the chain prefix that the
    packing did not list per pose: tests/test_torch_loop_closures.py holds
    the listed ones); the
    packed path resolves "auto" on these chains to btridiag, so it does not
    fuse; ``pcg`` runs a handed body in every body and its own otherwise;
    the solver hands one on the card alone, so the CPU keeps the body of
    ``pcg``."""
    import dataclasses as dc

    from boslam_torch.solver import schur_packed as sp
    from boslam_torch.solver.optimizer import solve_packed

    for corridor in (False, True):
        blocks, pk, mask, precond, rhs = _packed_system(corridor)
        rule = sp.fused_body_rule
        assert rule(blocks, pk, "block_jacobi", 0, None)
        for which in ("btridiag", "two_level", "bband"):
            assert not rule(blocks, pk, which, 0, None), which
        auto = sp._packed_which(pk, SolverConfig(preconditioner="auto"), blocks.Bp.shape[0])
        assert auto == "btridiag" and not rule(blocks, pk, auto, 0, None)
        bf16 = blocks._replace(Bp=blocks.Bp.to(torch.bfloat16), Bl=blocks.Bl.to(torch.bfloat16))
        assert not rule(bf16, pk, "block_jacobi", 0, None)
        assert not rule(blocks, pk, "block_jacobi", 0, object())
        assert not rule(blocks, pk, "block_jacobi", 64, None)
        assert not rule(blocks, dc.replace(pk, chain_len=pk.chain_len - 1), "block_jacobi", 0,
                        None)
        mv = lambda x: sp.packed_s_matvec(blocks, pk, x, mask)  # noqa: E731
        twin = functools.partial(sp.plain_cg_body, blocks, pk, mask, precond)
        for make in (twin, None):
            info = schur.pcg(mv, rhs, precond, 10, 1e-10, make_body=make)[4]
            assert info["fused_bodies"] == (info["matvecs"] if make else 0) and info["matvecs"]
    g, _ = _packed_graph(False)
    from boslam_torch.utils import spans

    solve_packed(g, SolverConfig(linear_solver="schur_cg", preconditioner="block_jacobi",
                                 iters=1, cg_iters=5))
    rec = [r for r in spans.records() if r.name == "solve_packed"][-1]
    assert rec.counters["cg.fused_bodies"] == 0 < rec.counters["cg.bodies"]


# ---- one helper builds every PCG preconditioner (schur.preconditioner_apply) ----

_RESOLVED = {  # cfg.preconditioner -> (with a chain, without one), flat path's rule
    "auto": ("btridiag", "block_jacobi"), "block_jacobi": ("block_jacobi", "block_jacobi"),
    "btridiag": ("btridiag", "block_jacobi"), "two_level": ("two_level", "block_jacobi"),
    "bband": ("block_jacobi", "block_jacobi")}


@pytest.mark.parametrize("has_chain", [True, False], ids=["chain", "no_chain"])
@pytest.mark.parametrize("path", ["flat", "packed"])
@pytest.mark.parametrize("which", [*_RESOLVED, "jacobi"])
def test_preconditioner_resolution(which, path, has_chain):
    """The resolution table of both paths: "auto" is btridiag on a chain up
    to 32768 poses and block-Jacobi past them or without a chain, a chain
    preconditioner without a chain is block-Jacobi, "bband" is itself on
    the packed path (on any graph) and block-Jacobi on the flat one, and
    an unknown name is refused."""
    bband = path == "packed"
    if which not in _RESOLVED:
        with pytest.raises(ValueError, match="unknown preconditioner"):
            schur.resolve_preconditioner(which, 1200, has_chain, bband)
        return
    want = "bband" if bband and which == "bband" else _RESOLVED[which][not has_chain]
    assert schur.resolve_preconditioner(which, 1200, has_chain, bband) == want
    if which == "auto":
        assert schur.resolve_preconditioner(which, 40000, has_chain, bband) == "block_jacobi"


@pytest.mark.parametrize("which", ["block_jacobi", "btridiag", "two_level"])
@pytest.mark.parametrize("path", ["flat", "packed"])
def test_preconditioner_apply_is_the_direct_factor(path, which):
    """Each path's preconditioner, built through the one helper, is to the
    bit the direct inverse, ``btridiag_factor`` (clamped at 0.4999) or
    ``two_level_factor`` solve on the same masked diag(S) and chain band,
    with a pose fixed mid-chain."""
    from boslam_torch.solver import schur_packed as sp
    from boslam_torch.solver import two_level as tl

    g, pk = _packed_graph(False)
    cfg = SolverConfig(linear_solver="schur_cg", preconditioner=which)
    mask = torch.ones((g.n_poses, 1))
    mask[g.n_poses // 2] = 0.0
    if path == "flat":
        b, _ = schur.build_blocks(g, cfg, cfg.damping)
        M = schur._flat_preconditioner(b, g, cfg, mask)
        s_diag = schur.s_diag_blocks(b, g)
        band = schur.flat_chain_band(b.Ho_sd, g.o_src, g.o_dst, g.n_poses)
    else:
        b, _ = sp.build_packed_blocks(g, pk, cfg, cfg.damping)
        M = sp._packed_preconditioner(b, pk, cfg, mask)
        s_diag = sp.packed_s_diag(b, pk)
        band = sp._chain_band(b, pk, g.n_poses)
    d = mask[..., None] * s_diag + (1.0 - mask[..., None]) * torch.eye(3)
    band = band * (mask[:-1, :, None] * mask[1:, :, None])
    if which == "block_jacobi":
        assert torch.equal(M, schur._inv3x3(d))
        return
    r = torch.from_numpy(np.random.default_rng(2).standard_normal((g.n_poses, 3))
                         .astype(np.float32)) * mask
    if which == "btridiag":
        want = bt.btridiag_solve(bt.btridiag_factor(d, band, clamp_band=0.4999), r)
    else:
        want = tl.two_level_solve(tl.two_level_factor(d, band, tl.aggregate_size(0, g.n_poses),
                                                      mask, cycle=cfg.two_level_cycle), r)
    assert torch.equal(M(r), want)
