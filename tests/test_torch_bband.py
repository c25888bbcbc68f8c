"""The block-banded preconditioner (``solver/bband.py``) against the JAX
package on the CPU: the factor and its apply on random banded systems, the
band assembly of S on one shared packing, the fallback of a group whose
Cholesky fails, and packed GN under "bband".

Tolerances.  Factor/solve against the f64 dense solve: rtol 2e-4, atol
2e-5 (test_bband.py:48); against the JAX apply: 1e-5 of the largest
entry (both run the same f32 LAPACK calls in the same order; the largest
gap seen is 7.9e-7).  Assembly: the blocks against JAX's at rtol 1e-5 with
an atol of 1e-5 of the largest magnitude (``_close``), against the dense S
at test_bband.py:64's rtol 2e-4, atol 5e-5.  Whole solves: iteration 0 at
rtol 1e-5, later GN iterations at ``TRACE_RTOL``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boslam.config import SolverConfig as SolverConfigJax
from boslam.solver import bband as bband_jax
from boslam.solver import schur as schur_jax
from boslam.solver import schur_packed as sp_jax
from boslam_torch.config import SolverConfig
from boslam_torch.solver import bband
from boslam_torch.solver import schur
from boslam_torch.solver import schur_packed as sp
from tests.test_torch_packed import TRACE_RTOL, _close, _graphs, _shared_packing, _solve_both


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_banded(N, w, rng, stiff=1.0):
    """Random SPD block-banded (diag [N,3,3], band [w,N,3,3]), numpy f32."""
    diag = (np.einsum("nij,nkj->nik", *(2 * [rng.standard_normal((N, 3, 3))]))
            + 6.0 * (1 + stiff) * np.eye(3)).astype(np.float32)
    band = np.zeros((w, N, 3, 3), np.float32)
    for d in range(1, w + 1):
        band[d - 1, : N - d] = stiff * rng.standard_normal((N - d, 3, 3))
    return diag, band


def _both_applies(diag, band, q, clamp, rhs):
    f = bband.bband_factor(torch.from_numpy(diag), torch.from_numpy(band), q, clamp_band=clamp)
    f_j = bband_jax.bband_factor(jnp.asarray(diag), jnp.asarray(band), q, clamp_band=clamp)
    x = bband.bband_solve(f, torch.from_numpy(rhs)).numpy()
    x_j = np.asarray(bband_jax.bband_solve(f_j, jnp.asarray(rhs)))
    return f, f_j, x, x_j


@pytest.mark.parametrize("N,w,q", [(13, 2, 4), (32, 3, 3), (7, 1, 8), (3, 2, 2)])
def test_factor_solve_exact(N, w, q):
    """Unclamped factor/solve == the dense solve of the same banded matrix,
    and == the JAX apply; bband_dense == the JAX one to the bit."""
    rng = np.random.default_rng(0)
    diag, band = _random_banded(N, w, rng)
    T = bband.bband_dense(torch.from_numpy(diag), torch.from_numpy(band))
    np.testing.assert_array_equal(T.numpy(), np.asarray(bband_jax.bband_dense(
        jnp.asarray(diag), jnp.asarray(band))))
    rhs = rng.standard_normal((N, 3)).astype(np.float32)
    _, _, x, x_j = _both_applies(diag, band, q, None, rhs)
    x_ref = np.linalg.solve(T.double().numpy(), rhs.reshape(-1)).reshape(N, 3)
    np.testing.assert_allclose(x, x_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-5 * np.abs(x_j).max())


@pytest.mark.parametrize("q", [4, 5])
def test_factor_solve_clamped_matches_jax(q):
    """With the PD clamp engaged (stiff couplings): the same apply as the
    JAX package's, symmetric and positive (test_bband.py:53)."""
    rng = np.random.default_rng(1)
    diag, band = _random_banded(40, 2, rng, stiff=20.0)
    rs = [rng.standard_normal((40, 3)).astype(np.float32) for _ in range(2)]
    f, _, x0, x0_j = _both_applies(diag, band, q, 0.4999, rs[0])
    np.testing.assert_allclose(x0, x0_j, rtol=0, atol=1e-5 * np.abs(x0_j).max())
    x1 = bband.bband_solve(f, torch.from_numpy(rs[1])).numpy()
    assert np.isclose(float((rs[1] * x0).sum()), float((rs[0] * x1).sum()), rtol=1e-3)
    assert float((rs[0] * x0).sum()) > 0


def test_indefinite_group_takes_diagonal_fallback():
    """A super-block indefinite beyond the jitter: both packages replace its
    factor by sqrt(diag) (the JAX package keys on the NaN its Cholesky
    gives, the port on cholesky_ex's flag or a NaN) and leave the other
    groups' factors as they were; the apply stays finite and matches."""
    rng = np.random.default_rng(2)
    diag, band = _random_banded(24, 2, rng)
    diag[9] = -10.0 * np.eye(3, dtype=np.float32)  # group 2 of q = 4
    rhs = rng.standard_normal((24, 3)).astype(np.float32)
    f, f_j, x, x_j = _both_applies(diag, band, 4, 0.98, rhs)
    L, L_j = f.L.numpy(), np.asarray(f_j.L)
    D2 = bband.bband_dense(torch.from_numpy(diag), torch.from_numpy(band)).numpy()[24:36, 24:36]
    dmax = np.abs(np.diag(D2)).max()
    want = np.diag(np.sqrt(np.maximum(np.diag(D2), 1e-12 * dmax)))
    np.testing.assert_array_equal(L[2], want)
    np.testing.assert_array_equal(L_j[2], want)
    np.testing.assert_allclose(L, L_j, rtol=0, atol=1e-6 * np.abs(L_j).max())
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-5 * np.abs(x_j).max())


@pytest.mark.parametrize("compensate", [False, True])
@pytest.mark.parametrize("kind, windows, split_lm", [("closures", False, 8),
                                                    ("corridor", True, "auto")])
def test_assemble_sband_matches_jax(kind, windows, split_lm, compensate):
    """diag and band of S on one packing (the windowed take of Hll_inv on
    the corridor), with and without Gershgorin compensation."""
    g, gj, pk, pk_j = _shared_packing(*_graphs(kind), windows, split_lm)
    cfg, cfg_j = SolverConfig(), SolverConfigJax()
    b, _ = sp.build_packed_blocks(g, pk, cfg, cfg.damping)
    b_j, _ = sp_jax.build_packed_blocks(gj, pk_j, cfg_j, cfg_j.damping)
    mask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    mask_j = schur_jax._pose_mask(gj.n_poses, gj.fixed_pose_ix, jnp.float32)
    diag, band = bband.assemble_sband(b, pk, 3, mask, compensate=compensate)
    diag_j, band_j = bband_jax.assemble_sband(b_j, pk_j, 3, mask_j, compensate=compensate)
    _close(diag.numpy(), diag_j, name="diag")
    _close(band.numpy(), band_j, name="band")


def test_assemble_sband_matches_dense_s():
    """Band blocks == the entries of the materialized S (the port's flat
    Schur blocks), on a walk with loop closures (test_bband.py:64's
    rows and bound); compensation only adds to the diagonal."""
    from boslam_torch.graph.packed import pack_edges

    g, _ = _graphs("closures")
    cfg = SolverConfig()
    pk, _ = pack_edges(g, split_lm=0)
    blocks, _ = sp.build_packed_blocks(g, pk, cfg, cfg.damping)
    mask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    w = 3
    diag, band = bband.assemble_sband(blocks, pk, w, mask)
    diag_c, band_c = bband.assemble_sband(blocks, pk, w, mask, compensate=True)
    assert torch.equal(band_c, band)
    gap = (diag_c - diag).numpy()
    assert (gap >= 0).all() and (gap * (1 - np.eye(3)) == 0).all() and gap.max() > 0
    S, _ = schur.dense_reduced_system(schur.build_blocks(g, cfg, cfg.damping)[0], g)
    S = S.numpy()
    NP_, fixed = g.n_poses, int(g.fixed_pose_ix)
    m = np.ones(NP_)
    m[fixed] = 0.0
    for d in range(0, w + 1):
        for i in [0, 1, 5, NP_ - d - 1, fixed - d, fixed]:
            if not 0 <= i < NP_ - d:
                continue
            Sblk = S[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3] * (m[i] * m[i + d])
            if d == 0:
                got = diag[i].numpy()
                if i == fixed:
                    Sblk = np.eye(3)
            else:
                got = band[d - 1, i].numpy()
            np.testing.assert_allclose(got, Sblk, rtol=2e-4, atol=5e-5, err_msg=f"{d} {i}")


@pytest.mark.parametrize("optimizer", ["gn", "lm"])
def test_solve_packed_bband_matches_jax(optimizer):
    """Packed GN (5 iterations) and LM (2 held trials) under "bband" on the
    8-closure walk with a forced landmark split, against the JAX package;
    then test_bband.py:116's property, on the port alone: after 10 GN
    iterations bband's chi2 is within 5% of block-Jacobi's."""
    g, gj = _graphs("closures")
    kw = dict(optimizer=optimizer, preconditioner="bband", band_width=4, lm_split=4,
              cg_iters=40, cg_tol=1e-5, iters=5)
    st, st_j = _solve_both(g, gj, **kw)
    c, c_j = st["chi2_robust"], st_j["chi2_robust"]
    np.testing.assert_allclose(c[0], c_j[0], rtol=1e-5)
    held = 5 if optimizer == "gn" else 2
    np.testing.assert_allclose(c[:held], c_j[:held], rtol=TRACE_RTOL)
    np.testing.assert_array_equal(st["accepted"][:held], st_j["accepted"][:held])
    assert np.isfinite(c).all() and st["spd_ok"].all()
    if optimizer == "gn":
        from boslam_torch.solver.optimizer import solve_packed

        cfg = SolverConfig(linear_solver="schur_cg", **{**kw, "iters": 10})
        chi = solve_packed(g, cfg)[1]["chi2_robust"][-1].item()
        chi_bj = solve_packed(g, cfg.replace(preconditioner="block_jacobi"))[1]["chi2_robust"]
        assert np.isfinite(chi) and chi <= chi_bj[-1].item() * 1.05
