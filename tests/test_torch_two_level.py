"""The two-level chain preconditioner (``solver/two_level.py``) against the
JAX package on the CPU, on random SPD block-tridiagonal chains.

Tolerances: the Galerkin projection, the cut band, the transfers and the
chain matvec at rtol 1e-5 (tests/test_two_level.py:31-79), with an atol of
1e-5 of the largest magnitude for entries that cancel; the whole apply,
both cycles, at 1e-5 of its largest magnitude (both packages run the same
f32 expressions, bar the dense coarse Cholesky's LAPACK blocking).  The
apply's properties (symmetry, positivity, the gauge invariant, finiteness
with indefinite blocks) at the JAX suite's own bounds.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from boslam.solver import two_level as tl_jax
from boslam.solver.btridiag import btridiag_dense as btridiag_dense_jax
from boslam_torch.solver import two_level as tl
from boslam_torch.solver.btridiag import btridiag_dense


def _chain(n, seed=0, coupling=0.3):
    """SPD (diagonally dominant) chain, numpy f32 [n,3,3] and [n-1,3,3]."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    diag = np.einsum("nij,nkj->nik", A, A) + 3.0 * np.eye(3, dtype=np.float32)
    band = (coupling * rng.normal(size=(n - 1, 3, 3))).astype(np.float32)
    return diag, band


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-30))


def _mask(n, fixed):
    m = np.ones((n, 1), np.float32)
    if fixed is not None:
        m[fixed] = 0.0
    return m


def _masked_chain(diag, band, mask):
    """The gauge-masked chain, as the preconditioners build it."""
    dm = mask[..., None] * diag + (1 - mask[..., None]) * np.eye(3, dtype=np.float32)
    bm = band * (mask[:-1, :, None] * mask[1:, :, None])
    return dm.astype(np.float32), bm.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@partial(jax.jit, static_argnames=("q", "cycle"))
def _jax_apply(diag, band, mask, r, q, cycle="additive"):
    """The JAX package's factor and apply, compiled once per shape."""
    return tl_jax.two_level_solve(tl_jax.two_level_factor(diag, band, q, mask, cycle=cycle), r)


def _jax_coarse_dense(n, q, cycle="additive"):
    """The JAX package's dense-or-cyclic rule (shape only)."""
    return cycle == "additive" and 3 * -(-n // q) <= tl_jax._COARSE_DENSE_MAX


@pytest.mark.parametrize("n, q", [(13, 4), (16, 4), (40, 8), (9, 1)])
def test_coarse_galerkin_matches_jax_and_dense(n, q):
    """T_c = P^T T P, chain lengths that q divides and does not."""
    diag, band = _chain(n, seed=n)
    Dc, Bc = tl._coarse_galerkin(_t(diag), _t(band), q)
    Dc_j, Bc_j = tl_jax._coarse_galerkin(jnp.asarray(diag), jnp.asarray(band), q)
    _close(Dc.numpy(), Dc_j)
    _close(Bc.numpy(), Bc_j)
    nc = -(-n // q)
    Tp = np.eye(3 * nc * q, dtype=np.float64)
    Tp[: 3 * n, : 3 * n] = btridiag_dense(_t(diag), _t(band)).double().numpy()
    P = np.kron(np.repeat(np.eye(nc), q, axis=0), np.eye(3))
    _close(btridiag_dense(Dc, Bc).double().numpy(), P.T @ Tp @ P)


@pytest.mark.parametrize("n, q", [(17, 4), (16, 4), (33, 8)])
def test_cut_band_and_grouping_match_jax(n, q):
    diag, band = _chain(n, seed=2)
    np.testing.assert_array_equal(tl._cut_band(_t(band), q).numpy(),
                                  np.asarray(tl_jax._cut_band(jnp.asarray(band), q)))
    dg, bg = tl._group_aggregates(_t(diag), _t(band), q)
    dg_j, bg_j = tl_jax._group_aggregates(jnp.asarray(diag), jnp.asarray(band), q)
    np.testing.assert_array_equal(dg.numpy(), np.asarray(dg_j))
    np.testing.assert_array_equal(bg.numpy(), np.asarray(bg_j))


@pytest.mark.parametrize("n, q", [(23, 4), (24, 4), (5, 8)])
def test_restrict_prolong_match_jax_and_are_adjoint(n, q):
    rng = np.random.default_rng(3)
    r = rng.normal(size=(n, 3)).astype(np.float32)
    zc = rng.normal(size=(-(-n // q), 3)).astype(np.float32)
    _close(tl._restrict(_t(r), q).numpy(), tl_jax._restrict(jnp.asarray(r), q))
    np.testing.assert_array_equal(tl._prolong(_t(zc), q, n).numpy(),
                                  np.asarray(tl_jax._prolong(jnp.asarray(zc), q, n)))
    lhs = float(torch.sum(tl._restrict(_t(r), q) * _t(zc)))
    rhs = float(torch.sum(_t(r) * tl._prolong(_t(zc), q, n)))
    assert abs(lhs - rhs) < 1e-4 * max(1.0, abs(lhs))


def test_t_matvec_matches_jax_and_dense():
    n = 11
    diag, band = _chain(n, seed=4)
    x = np.random.default_rng(5).normal(size=(n, 3)).astype(np.float32)
    y = tl._t_matvec(_t(diag), _t(band), _t(x)).numpy()
    _close(y, tl_jax._t_matvec(jnp.asarray(diag), jnp.asarray(band), jnp.asarray(x)))
    T = np.asarray(btridiag_dense_jax(jnp.asarray(diag), jnp.asarray(band)), np.float64)
    _close(y.reshape(-1), T @ x.reshape(-1).astype(np.float64))


# (n, q, fixed pose): chain lengths q divides and does not, the gauge pose
# inside an aggregate, at its start and at the chain's end
@pytest.mark.parametrize("n, q, fixed", [(37, 8, 5), (64, 8, 0), (300, 32, 299), (50, 16, None)])
@pytest.mark.parametrize("cycle", ["additive", "vcycle"])
def test_two_level_solve_matches_jax(n, q, fixed, cycle):
    """The whole apply on a gauge-masked chain, dense coarse level (additive)
    or cyclic coarse level (vcycle), against the JAX package."""
    diag, band = _chain(n, seed=n + q, coupling=0.3)
    mask = _mask(n, fixed)
    dm, bm = _masked_chain(diag, band, mask)
    f = tl.two_level_factor(_t(dm), _t(bm), q, _t(mask), cycle=cycle)
    assert f.coarse_dense == _jax_coarse_dense(n, q, cycle) == (cycle == "additive")
    r = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32) * mask
    z = tl.two_level_solve(f, _t(r)).numpy()
    _close(z, _jax_apply(dm, bm, mask, r, q=q, cycle=cycle))
    if fixed is not None:
        np.testing.assert_allclose(z[fixed], 0.0, atol=1e-6)


def test_two_level_cyclic_coarse_matches_jax():
    """A chain long enough (3*NC = 4125 > 4096 at q 8) that both packages
    take the cyclic-reduction coarse level of the additive cycle."""
    n, q = 11000, 8
    diag, band = _chain(n, seed=21, coupling=0.3)
    mask = _mask(n, 7)
    dm, bm = _masked_chain(diag, band, mask)
    f = tl.two_level_factor(_t(dm), _t(bm), q, _t(mask))
    assert not f.coarse_dense and not _jax_coarse_dense(n, q)
    r = np.random.default_rng(22).normal(size=(n, 3)).astype(np.float32) * mask
    _close(tl.two_level_solve(f, _t(r)).numpy(), _jax_apply(dm, bm, mask, r, q=q))


@pytest.mark.parametrize("cycle, dense_max", [("additive", 4096), ("additive", 0),
                                              ("vcycle", 4096)])
def test_apply_symmetric_positive(cycle, dense_max, monkeypatch):
    """M^-1 is symmetric and positive on random vectors (tests/test_two_level.py:84-99);
    ``dense_max`` 0 forces the port's cyclic coarse level on a small chain."""
    monkeypatch.setattr(tl, "_COARSE_DENSE_MAX", dense_max)
    n, q = 37, 8
    diag, band = _chain(n, seed=6, coupling=0.2)
    mask = _mask(n, 5)
    f = tl.two_level_factor(_t(diag), _t(band), q, _t(mask), cycle=cycle)
    assert f.coarse_dense == (cycle == "additive" and dense_max > 0)
    rng = np.random.default_rng(7)
    for _ in range(3):
        r1 = _t(rng.normal(size=(n, 3)).astype(np.float32))
        r2 = _t(rng.normal(size=(n, 3)).astype(np.float32))
        z1, z2 = tl.two_level_solve(f, r1), tl.two_level_solve(f, r2)
        a, b = float(torch.sum(r2 * z1)), float(torch.sum(r1 * z2))
        assert abs(a - b) < 2e-3 * max(abs(a), abs(b), 1.0)
        assert float(torch.sum(r1 * z1)) > 0


@pytest.mark.parametrize("dense_max", [4096, 0])
def test_indefinite_block_stays_finite(dense_max, monkeypatch):
    """Indefinite diagonal blocks (f32 cancellation in diag(S)): the factor
    stays finite and the apply positive (tests/test_two_level.py:103), on
    the dense and on the cyclic coarse level."""
    monkeypatch.setattr(tl, "_COARSE_DENSE_MAX", dense_max)
    n, q = 300, 32
    diag, band = _chain(n, seed=11, coupling=0.4)
    diag[57] = diag[191] = np.diag([1.0, 1.0, -0.3]).astype(np.float32)
    mask = np.ones((n, 1), np.float32)
    f = tl.two_level_factor(_t(diag), _t(band), q, _t(mask))
    assert f.coarse_dense == (dense_max > 0)
    r = _t(np.random.default_rng(12).normal(size=(n, 3)).astype(np.float32))
    z = tl.two_level_solve(f, r)
    assert torch.isfinite(z).all() and float(torch.sum(r * z)) > 0
    if dense_max:
        _close(z.numpy(), _jax_apply(diag, band, mask, r.numpy(), q=q), rtol=1e-4)


@pytest.mark.parametrize("cycle, dense_max", [("additive", 4096), ("additive", 0),
                                              ("vcycle", 4096)])
def test_mask_invariant(cycle, dense_max, monkeypatch):
    """r == 0 at the fixed pose gives z == 0 there (tests/test_two_level.py:126-142)."""
    monkeypatch.setattr(tl, "_COARSE_DENSE_MAX", dense_max)
    n, q, fixed = 29, 4, 12
    diag, band = _chain(n, seed=8)
    mask = _mask(n, fixed)
    dm, bm = _masked_chain(diag, band, mask)
    f = tl.two_level_factor(_t(dm), _t(bm), q, _t(mask), cycle=cycle)
    r = np.random.default_rng(9).normal(size=(n, 3)).astype(np.float32) * mask
    z = tl.two_level_solve(f, _t(r)).numpy()
    np.testing.assert_allclose(z[fixed], 0.0, atol=1e-6)


def test_unknown_cycle_raises():
    diag, band = _chain(8)
    with pytest.raises(ValueError, match="two_level_cycle"):
        tl.two_level_factor(_t(diag), _t(band), 4, _t(_mask(8, 0)), cycle="wcycle")


@pytest.mark.parametrize("cfg_q, n_poses, want", [(0, 300, 16), (0, 10000, 128), (0, 100000, 128),
                                                  (0, 20, 8), (5, 100000, 5)])
def test_aggregate_size_rule(cfg_q, n_poses, want):
    """The JAX package's rule (boslam/solver/schur_packed.py:515)."""
    assert tl.aggregate_size(cfg_q, n_poses) == want
