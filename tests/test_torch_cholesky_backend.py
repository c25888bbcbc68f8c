"""The ``cholesky_backend`` switch on the CPU: "xla" solves with
``torch.linalg``, "pallas" with the Cholesky kernel's plain version (the
JAX package takes interpret mode off the TPU), "auto" with torch.linalg
for a CPU tensor; GN-dense and GN-schur under each against the JAX
package's "xla" run at test_torch_solve.py's trace bound, rtol 5e-4."""

import dataclasses

import numpy as np
import pytest
import torch

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.solver import optimizer as opt_jax
from boslam.synth import generate_sequence
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.ops import cholesky as chol
from boslam_torch.solver import gauss_newton as GN
from boslam_torch.solver import optimizer as opt
from boslam_torch.solver import schur

TRACE_RTOL = 5e-4


@pytest.fixture(scope="module")
def graphs():
    ig, _ = generate_sequence(80, 40, seed=3)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the Cholesky kernel's plain-version calls and the torch.linalg
    factorizations of whole systems (the plain version factors its 32 x 32
    tiles with cholesky_ex too; those are not counted)."""
    calls = {"plain": 0, "linalg": 0}
    plain, ex = chol.cholesky_solve_padded_plain, torch.linalg.cholesky_ex

    def counted_plain(H, b):
        calls["plain"] += 1
        return plain(H, b)

    def counted_ex(A, *a, **k):
        calls["linalg"] += A.shape[-1] > chol.TILE
        return ex(A, *a, **k)

    monkeypatch.setattr(chol, "cholesky_solve_padded_plain", counted_plain)
    monkeypatch.setattr(GN.torch.linalg, "cholesky_ex", counted_ex)
    return calls


def test_backend_rule():
    H = torch.eye(300)
    big = torch.eye(chol.MAX_VMEM_DIM + 1)
    assert not GN._use_cholesky_kernel(H, SolverConfig(cholesky_backend="xla"))
    assert GN._use_cholesky_kernel(H, SolverConfig(cholesky_backend="pallas"))
    assert not GN._use_cholesky_kernel(big, SolverConfig(cholesky_backend="pallas"))
    assert not GN._use_cholesky_kernel(H, SolverConfig(cholesky_backend="auto"))
    assert not GN._use_cholesky_kernel(H, None)
    with pytest.raises(ValueError, match="cholesky_backend"):
        SolverConfig(cholesky_backend="lapack").check_ported()


@pytest.mark.parametrize("linear_solver", ["dense", "schur"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "auto"])
def test_backend_dispatch_and_trace(graphs, plain_calls, linear_solver, backend):
    g, gj = graphs
    iters = 3
    cfg = SolverConfig(linear_solver=linear_solver, fused_step="off", iters=iters,
                       cholesky_backend=backend)
    assert not schur._takes_kernel(g, cfg)  # a CPU graph never takes the Schur kernel
    _, st = opt.solve(g, cfg)
    if backend == "pallas":
        assert plain_calls == {"plain": iters, "linalg": 0}
    else:
        assert plain_calls == {"plain": 0, "linalg": iters}
    _, st_j = opt_jax.solve(gj, SolverConfigJax(linear_solver=linear_solver, fused_step="off",
                                                iters=iters, cholesky_backend="xla"))
    np.testing.assert_allclose(st["chi2_robust"].numpy(), np.asarray(st_j["chi2_robust"]),
                               rtol=TRACE_RTOL)
    assert st["spd_ok"].all()
