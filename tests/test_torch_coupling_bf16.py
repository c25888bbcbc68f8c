"""bf16 coupling-block storage on the packed path (``coupling_dtype=
"bfloat16"``) against the JAX package on the CPU.

Tolerances.  The stored blocks: equal to JAX's bf16 blocks but for single
bf16-ulp flips, where the two packages' f32 blocks (which part by f32
rounding, ``test_torch_packed.py``) sit on either side of a bf16 rounding
boundary: at most 1 in 10^3 entries.  Matvec, diag(S) and the reduced rhs
on the same bf16 blocks: ``_close``'s rtol 1e-5 (the bf16 x bf16 products
are exact in f32 in both; only the order of the sums differs).  The step
and the solve: the JAX suite's bf16 bounds (test_schur_packed.py:321-364):
the bf16 step's cosine with the f32 step > 0.95, the 20-iteration chi2
within 2% of f32's, CG iterations at most 1.1x f32's + 5; and the port's
bf16 chi2 against the JAX package's bf16 chi2 within the same 2%.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.solver import optimizer as opt_jax
from boslam.solver import schur as schur_jax
from boslam.solver import schur_packed as sp_jax
from boslam.synth import generate_sequence
from boslam_torch.config import BF16_CG_TOL_FLOOR, SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.graph.packed import pack_edges
from boslam_torch.solver import optimizer as opt
from boslam_torch.solver import schur
from boslam_torch.solver import schur_packed as sp
from tests.test_torch_packed import _close, _graphs, _shared_packing

BF16 = dict(coupling_dtype="bfloat16")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _as_torch(x, dtype=None):
    """A JAX array as a CPU tensor; bf16 goes through f32 (exact)."""
    t = torch.from_numpy(np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype == jnp.bfloat16
                                    else x).copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def test_config_floor_matches_jax():
    from boslam.config import BF16_CG_TOL_FLOOR as floor_jax

    assert BF16_CG_TOL_FLOOR == floor_jax == 4e-3
    with pytest.raises(ValueError, match="coupling_dtype"):
        SolverConfig(coupling_dtype="float16").check_ported()


@pytest.mark.parametrize("kind, windows, split_lm", [("closures", False, 8),
                                                    ("corridor", True, "auto")])
def test_bf16_blocks_match_jax(kind, windows, split_lm):
    """Bp/Bl are stored bf16, everything else stays f32; the stored values
    equal JAX's but for rare single-ulp flips; matvec, diag(S) and the rhs
    correction on JAX's own bf16 blocks match JAX's."""
    g, gj, pk, pk_j = _shared_packing(*_graphs(kind), windows, split_lm)
    cfg, cfg_j = SolverConfig(**BF16), SolverConfigJax(**BF16)
    b, _ = sp.build_packed_blocks(g, pk, cfg, cfg.damping)
    b_j, _ = sp_jax.build_packed_blocks(gj, pk_j, cfg_j, cfg_j.damping)
    assert b.Bp.dtype == b.Bl.dtype == torch.bfloat16
    assert b_j.Bp.dtype == jnp.bfloat16
    for name in ("Hpp_diag", "Hll_inv", "bp", "bl", "Ho_sd"):
        assert getattr(b, name).dtype == torch.float32
    flips = total = 0
    for name in ("Bp", "Bl"):
        got = getattr(b, name).float().numpy()
        want = np.asarray(getattr(b_j, name).astype(jnp.float32))
        diff = got != want
        flips += int(diff.sum())
        total += diff.size
        # a flip is one bf16 ulp: 2^-7 of the larger magnitude's binade
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[diff]), 1e-30))) - 7)
        assert (np.abs(got[diff] - want[diff]) <= ulp * 1.0001).all(), name
    print(f"bf16 flips: {flips} of {total}")
    assert flips <= total // 1000

    bt = sp.PackedBlocks(*[_as_torch(v) for v in b_j])
    assert bt.Bp.dtype == torch.bfloat16
    mask = schur._pose_mask(g.n_poses, g.fixed_pose_ix, torch.float32)
    mask_j = schur_jax._pose_mask(gj.n_poses, gj.fixed_pose_ix, jnp.float32)
    x = np.random.default_rng(0).standard_normal((g.n_poses, 3)).astype(np.float32)
    _close(sp.packed_s_matvec(bt, pk, torch.from_numpy(x), mask).numpy(),
           sp_jax.packed_s_matvec(b_j, pk_j, jnp.asarray(x), mask_j), name="matvec")
    _close(sp.packed_s_diag(bt, pk).numpy(), sp_jax.packed_s_diag(b_j, pk_j), name="diag")
    w = np.random.default_rng(1).standard_normal((g.n_landmarks, 2)).astype(np.float32)
    _close(sp._couple("pkij,pkj->pi", bt.Bp, torch.from_numpy(w)[pk.p_lm.long()]).numpy(),
           sp_jax._couple("pkij,pkj->pi", b_j.Bp, jnp.asarray(w)[pk_j.p_lm]), name="rhs corr")


def test_bf16_step_and_solve_within_jax_bounds():
    """At the reference dataset's size (generate_sequence(301, 141,
    seed=3)): one bf16 step against the f32 step, then 20 packed GN
    iterations each, held to the JAX suite's bf16 bounds; the clamped
    tolerance is reported as 4e-3 by both packages."""
    ig, _ = generate_sequence(301, 141, seed=3)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    pk, _ = pack_edges(g)
    cfg32 = SolverConfig(linear_solver="schur_cg", cg_iters=200, cg_tol=1e-6,
                         preconditioner="block_jacobi")
    cfg16 = cfg32.replace(**BF16)
    dp32, _, st32, ok32 = sp.schur_packed_build_and_solve(g, pk, cfg32, cfg32.damping)
    dp16, _, st16, ok16 = sp.schur_packed_build_and_solve(g, pk, cfg16, cfg16.damping)
    assert bool(ok32) and bool(ok16)
    assert st32["cg_tol_effective"].item() == np.float32(1e-6)
    assert st16["cg_tol_effective"].item() == np.float32(BF16_CG_TOL_FLOOR)
    a, b = dp16.numpy().ravel(), dp32.numpy().ravel()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.95

    run = SolverConfig(linear_solver="schur_cg", iters=20, cg_iters=150)
    _, s32 = opt.solve_packed(g, run)
    _, s16 = opt.solve_packed(g, run.replace(**BF16))
    _, s16_j = opt_jax.solve_packed(gj, SolverConfigJax(linear_solver="schur_cg", iters=20,
                                                        cg_iters=150, **BF16))
    c32, c16 = s32["chi2_robust"][-1].item(), s16["chi2_robust"][-1].item()
    c16_j = float(np.asarray(s16_j["chi2_robust"])[-1])
    assert abs(c16 - c32) / c32 < 0.02, (c16, c32)
    assert abs(c16 - c16_j) / c16_j < 0.02, (c16, c16_j)
    assert s16["cg_iters"].sum().item() <= 1.1 * s32["cg_iters"].sum().item() + 5
    np.testing.assert_allclose(s16["cg_tol_effective"].numpy(), BF16_CG_TOL_FLOOR, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(s16_j["cg_tol_effective"]), BF16_CG_TOL_FLOOR, rtol=1e-7)
    np.testing.assert_allclose(s16["chi2_robust"][0].item(),
                               float(np.asarray(s16_j["chi2_robust"])[0]), rtol=1e-5)


@pytest.mark.parametrize("preconditioner", ["btridiag", "bband", "two_level"])
def test_bf16_other_preconditioners_run(preconditioner):
    """bf16 blocks feed every packed preconditioner through diag(S) (and
    bband's own assembly): a finite, descending 3-iteration solve, with
    row-chunked matvecs on the flat grids."""
    g, _ = _graphs("closures")
    cfg = SolverConfig(linear_solver="schur_cg", iters=3, preconditioner=preconditioner,
                       band_width=3, matvec_row_chunk=64, **BF16)
    _, st = opt.solve_packed(g, cfg)
    c = st["chi2_robust"].numpy()
    assert np.isfinite(c).all() and c[-1] < c[0] and st["spd_ok"].all()
