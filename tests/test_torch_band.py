"""The band route of the reduced system's factor-solve, on the CPU: the
tile band the port computes from a graph's edges (``gn_step.tile_band``)
against the nonzero pattern of S, the port's and the JAX package's, and
the plain band factor-solve (``cholesky.blocked_factor`` /
``blocked_substitute`` with ``band_tiles``) against the plain dense one.

The CUDA band kernel is held against the dense route on the card, to the
bit, by tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.solver import schur as schur_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.ops import cholesky as chol
from boslam_torch.ops import gn_step as gs
from boslam_torch.solver import schur
from boslam_torch.solver.normal_eq import edge_terms

T = chol.TILE

# (poses, landmarks, seed, loop closures) -> S's tile band: the main path's
# graph, two 4-closure graphs (seed 0 is the one whose f32 system fails at
# an iterate) and the whole step's 512-pose cap
GRAPHS = [((301, 141, 3, 0), 3), ((301, 141, 16, 4), 4), ((301, 141, 0, 4), 4),
          ((512, 300, 3, 0), 42)]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _graphs(n_poses, n_landmarks, seed, loop_closures):
    """The same graph in both packages, built by the JAX package."""
    ig, _ = generate_sequence(n_poses, n_landmarks, seed=seed, loop_closures=loop_closures)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


def _nonzero_band(S: np.ndarray) -> int:
    r, c = np.nonzero(np.tril(S))
    return int((r // T - c // T).max())


@pytest.mark.parametrize("graph, band", GRAPHS, ids=["chain", "closures16", "closures0", "cap"])
def test_tile_band_is_the_band_of_s(graph, band):
    """The structural band equals the largest nonzero tile distance of the
    port's gauge-masked S (from ``fused_schur_inputs``); the route takes it
    where its window fits and the dense route at the cap."""
    g, _ = _graphs(*graph)
    cfg = SolverConfig(linear_solver="schur")
    pmask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    Hpp, U, Hb, bp, bl, m = schur.fused_schur_inputs(g, cfg, cfg.damping, edge_terms(g, cfg), pmask)
    Np, Ml = U.shape
    W = torch.einsum("rlb,lba->rla", U.reshape(Np, Ml // 2, 2), Hb).reshape(Np, Ml)
    S = (Hpp - W @ U.T) * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
    assert gs.structural_band(g) == _nonzero_band(S.numpy()) == band
    want = band if chol.band_fits(band, Np) else None
    assert gs.tile_band(g, Np) == gs.tile_band(g) == want
    assert (want is None) == (graph[0] == 512)


def test_tile_band_matches_jax_reduced_system():
    """The band from the edges against the band of the JAX package's S,
    through its unfused Schur pieces (build_blocks, dense_reduced_system)
    on the CPU, gauge-masked as the kernels mask it."""
    g, gj = _graphs(301, 141, 16, 4)
    cfg = SolverConfigJax(linear_solver="schur")
    blocks, _ = schur_jax.build_blocks(gj, cfg, cfg.damping)
    S, _ = schur_jax.dense_reduced_system(blocks, gj)
    m = np.repeat(np.asarray(schur_jax._pose_mask(gj.n_poses, gj.fixed_pose_ix, jnp.float32))[:, 0],
                  3)
    S = np.asarray(S) * (m[:, None] * m[None, :]) + np.diag(1.0 - m)
    assert _nonzero_band(S) == gs.structural_band(g) == 4


def _band_system(n, bt, rng):
    """A gauge- and pad-masked SPD system whose lower triangle is zero more
    than bt tiles below the diagonal."""
    A = rng.standard_normal((n, n)).astype(np.float32)
    i, j = np.indices((n, n))
    A[np.abs(i // T - j // T) > bt] = 0.0
    A = np.tril(A)
    A = (A + A.T) / 2 + np.float32(n / 4) * np.eye(n, dtype=np.float32)
    m = np.ones(n, np.float32)
    m[3:6] = 0.0
    m[n - 40:] = 0.0
    H = A * m[:, None] * m[None, :] + np.diag(1.0 - m).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) * m
    return torch.from_numpy(H), torch.from_numpy(b), torch.from_numpy(m)


@pytest.mark.parametrize("n", [1024, 1536])
@pytest.mark.parametrize("bt", [1, 3, 4])
def test_band_plain_matches_dense_plain(n, bt):
    """The band factor-solve against the dense one on the same system.

    The factor's tiles inside the band and the tile inverses are bit-equal:
    each is the same per-tile product over the same 32-deep sums, which the
    CPU's GEMM takes in the same order for the shorter panel.  x is held at
    test_torch_ops.py's bound for the plain Cholesky (atol 5e-3 max|x|)
    and in fact lands within ~1e-6 of it: the substitutions' products
    L[i, lo:i] @ y[lo:i] start at another column, and the CPU's GEMV then
    sums the same nonzero terms in another grouping."""
    H, b, m = _band_system(n, bt, np.random.default_rng(n + bt))
    L_d, L_b = H.clone(), H.clone()
    inv_d, inv_b = chol.blocked_factor(L_d), chol.blocked_factor(L_b, bt)
    i, j = np.indices((n, n))
    band = torch.from_numpy((i >= j) & (i // T - j // T <= bt))
    assert torch.equal(L_b[band], L_d[band])
    assert all(torch.equal(p, q) for p, q in zip(inv_b, inv_d))
    x_d = chol.blocked_substitute(L_d, inv_d, b, m)
    x_b = chol.blocked_substitute(L_b, inv_b, b, m, bt)
    scale = x_d.abs().max().item()
    torch.testing.assert_close(x_b, x_d, rtol=0.0, atol=5e-3 * scale)
    assert (x_b - x_d).abs().max().item() <= 1e-6 * scale
    assert bool((x_b[m == 0] == 0).all())
    x64 = torch.linalg.solve(H.double(), b.double())
    assert (x_b.double() - x64).abs().max().item() <= 5e-3 * scale


@pytest.mark.parametrize("where", [40, 500, 1000])
def test_band_pivot_failure_gives_non_finite_x(where):
    """A non-positive pivot inside the band gives a non-finite x on the
    band route, as on the dense route (the whole step's guard reads it)."""
    H, b, m = _band_system(1024, 3, np.random.default_rng(where))
    H[where, where] = -1.0
    for bt in (3, None):
        L = H.clone()
        x = chol.blocked_substitute(L, chol.blocked_factor(L, bt), b, m, bt)
        assert not torch.isfinite(x).all(), bt
