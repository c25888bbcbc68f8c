"""The CG pieces against the JAX package on the CPU: the block-tridiagonal
chain preconditioner, the 3x3 closed forms, ``pcg`` on fixed systems, and
the flat ``schur_cg`` path (matvec, diagonal, whole solves).

Tolerances: the closed forms and btridiag at rtol 1e-5 against JAX (both
f32, the same expression order); btridiag against f64 at the JAX bound
(test_btridiag.py:53); pcg's iterate at rtol 1e-4 with the same iteration
count; whole flat solves as the packed ones (tests/test_torch_packed.py).
"""

import dataclasses

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
    _close(schur.flat_chain_band(b, g).numpy(), schur_jax.flat_chain_band(b_j, gj))
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
