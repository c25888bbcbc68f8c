"""Port parity of the kernel modules' plain versions (boslam_torch.ops)
against the Pallas kernels run in interpret mode, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.ops import pallas_cholesky as pc_jax
from boslam.ops import pallas_schur as ps_jax
from boslam.solver import normal_eq as ne_jax
from boslam.solver import schur as schur_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.ops import cholesky as chol
from boslam_torch.ops import schur_solve as ss
from boslam_torch.solver import normal_eq as ne
from boslam_torch.solver import schur


def _spd(n, rng, cond=1e4):
    A = rng.standard_normal((n, n)).astype(np.float32)
    Q, _ = np.linalg.qr(A)
    eigs = np.geomspace(1.0, cond, n).astype(np.float32)
    return ((Q * eigs) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("n", [128, 256, 384])
def test_cholesky_plain_matches_pallas(n):
    """The plain blocked solve, the Pallas kernel and the f64 solve agree
    at test_pallas_cholesky.py's bound (atol 5e-3 * max|x|, cond 1e4)."""
    rng = np.random.default_rng(n)
    H = _spd(n, rng)
    b = rng.standard_normal(n).astype(np.float32)
    want = np.linalg.solve(H.astype(np.float64), b.astype(np.float64))
    before = chol.cholesky_solve_padded.launches
    got = chol.cholesky_solve_padded(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    assert chol.cholesky_solve_padded.launches == before  # CPU: no kernel launch
    ref = np.asarray(pc_jax.cholesky_solve_padded(jnp.asarray(H), jnp.asarray(b), interpret=True))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-3 * scale)
    np.testing.assert_allclose(got, ref, atol=5e-3 * scale)


def test_cholesky_padded_identity():
    """n = 200 pads to 256 with an identity diagonal and a zero rhs."""
    rng = np.random.default_rng(200)
    H = _spd(200, rng)
    b = rng.standard_normal(200).astype(np.float32)
    want = np.linalg.solve(H.astype(np.float64), b.astype(np.float64))
    got = chol.cholesky_solve(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    ref = np.asarray(pc_jax.cholesky_solve(jnp.asarray(H), jnp.asarray(b), interpret=True))
    assert got.shape == (200,)
    np.testing.assert_allclose(got, want, atol=5e-3 * np.abs(want).max())
    np.testing.assert_allclose(got, ref, atol=5e-3 * np.abs(want).max())


def test_cholesky_not_spd_gives_nan():
    """A non-positive pivot yields NaN, as in the Pallas kernel (no clamping)."""
    rng = np.random.default_rng(5)
    H = _spd(128, rng)
    H[70, 70] = -1.0
    b = np.ones(128, np.float32)
    got = chol.cholesky_solve_padded(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    ref = np.asarray(pc_jax.cholesky_solve_padded(jnp.asarray(H), jnp.asarray(b), interpret=True))
    assert np.isnan(got).any() and np.isnan(ref).any()


def test_cholesky_checks_inputs():
    with pytest.raises(ValueError):
        chol.cholesky_solve_padded(torch.eye(100), torch.zeros(100))
    with pytest.raises(TypeError):
        chol.cholesky_solve_padded(torch.eye(128, dtype=torch.float64), torch.zeros(128))
    assert chol.MAX_VMEM_DIM == pc_jax.MAX_VMEM_DIM and chol.pad_dim(903) == pc_jax.pad_dim(903)


@pytest.fixture(scope="module")
def small_graph():
    ig, _ = generate_sequence(40, 20, seed=11)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


@pytest.mark.parametrize("damping", [1.0, 0.01])
def test_fused_schur_plain_matches_pallas(small_graph, damping):
    """dp/dl of the port's Schur solve against the Pallas Schur kernel in
    interpret mode, with the gauge pose exactly 0.

    At damping 1.0 the bound is test_pallas_schur.py's mini-dataset bound
    (rtol 2e-3, atol 2e-5).  At the default damping 0.01 the reduced
    system of a synthetic graph is so ill-conditioned that the JAX
    package's own fused and unfused paths differ by 2-18x that bound on
    such graphs, so the bound is the JAX suite's reference-scale one
    (test_pallas_schur.py:79, 3e-2 * max|dp|)."""
    g, gj = small_graph
    cfg, cfg_j = SolverConfig(linear_solver="schur"), SolverConfigJax(linear_solver="schur")
    mask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    mask_j = schur_jax._pose_mask(gj.n_poses, gj.fixed_pose_ix, jnp.float32)
    dp, dl = schur.fused_schur_solve(g, cfg, damping, ne.edge_terms(g, cfg), mask)
    dp_j, dl_j = schur_jax.fused_schur_solve(
        gj, cfg_j, damping, ne_jax.edge_terms(gj, cfg_j), mask_j, interpret=True)
    dp_j, dl_j = np.asarray(dp_j), np.asarray(dl_j)
    if damping == 1.0:
        tol = dict(rtol=2e-3, atol=2e-5)
        np.testing.assert_allclose(dp.numpy(), dp_j, **tol)
        np.testing.assert_allclose(dl.numpy(), dl_j, **tol)
    else:
        np.testing.assert_allclose(dp.numpy(), dp_j, atol=3e-2 * np.abs(dp_j).max())
        np.testing.assert_allclose(dl.numpy(), dl_j, atol=3e-2 * np.abs(dl_j).max())
    fixed = int(g.fixed_pose_ix)
    assert np.all(dp.numpy()[fixed] == 0.0)


def test_fused_schur_padded_plain_matches_pallas():
    """The padded public function on random inputs of the kernel's shapes:
    SPD Hpp, block-diagonal SPD HllD, a gauge and padding mask and a
    nonzero damping (which the solver path always passes as 0)."""
    rng = np.random.default_rng(9)
    Np, Ml, n_real = 256, 128, 240
    U = (0.1 * rng.standard_normal((Np, Ml))).astype(np.float32)
    blocks = np.stack([_spd(2, rng, cond=3.0) for _ in range(Ml // 2)])
    HllD = np.zeros((Ml, Ml), np.float32)
    for l in range(Ml // 2):
        HllD[2 * l:2 * l + 2, 2 * l:2 * l + 2] = blocks[l]
    # Hpp - U HllD U^T is then an SPD matrix of condition 1e3
    Hpp = (_spd(Np, rng, cond=1e3) + U @ HllD @ U.T).astype(np.float32)
    bp = rng.standard_normal(Np).astype(np.float32)
    bl = rng.standard_normal(Ml).astype(np.float32)
    mask = np.ones(Np, np.float32)
    mask[6:9] = 0.0
    mask[n_real:] = 0.0
    args = (Hpp, U, HllD, bp, bl, mask)
    x, dl = ss.fused_schur_solve_padded(*(torch.from_numpy(a) for a in args), 0.5)
    x_j, dl_j = ps_jax.fused_schur_solve_padded(*(jnp.asarray(a) for a in args), jnp.float32(0.5),
                                                interpret=True)
    assert np.isfinite(x.numpy()).all() and np.isfinite(dl.numpy()).all()
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_j), rtol=2e-3, atol=2e-5)
    assert np.all(x.numpy()[mask == 0] == 0.0)
    assert ss.fused_fits(903, 278) == ps_jax.fused_fits(903, 278)
    assert ss.fused_fits(1300, 100) == ps_jax.fused_fits(1300, 100)
