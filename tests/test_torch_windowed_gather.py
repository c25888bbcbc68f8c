"""The windowed gather and the landmark reorder against the JAX package on
the CPU: the planner gives the same plans (or the same refusal), the plain
version of the kernel gives the bits of JAX ``windowed_take`` in Pallas
interpret mode, and the reorder the same permutation."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boslam.graph.build import build_graph as build_graph_jax
from boslam.graph.reorder import reorder_landmarks_by_pose as reorder_jax
from boslam.ops import windowed_gather as wg_jax
from boslam.synth import generate_sequence
from boslam_torch.graph.data import FactorGraph
from boslam_torch.graph.reorder import reorder_landmarks_by_pose
from boslam_torch.ops import windowed_gather as wg


def _banded_indices(rng, R, K, M, band):
    """Index grid whose row tiles span narrow windows (the post-reorder
    structure of the slot grids), as tests/test_windowed_gather.py makes it."""
    centers = np.linspace(0, M - 1, R)
    idx = (centers[:, None] + rng.integers(-band, band + 1, (R, K))).clip(0, M - 1)
    return idx.astype(np.int32)


def _same_plan(plan, plan_j):
    assert (plan is None) == (plan_j is None)
    if plan is not None:
        np.testing.assert_array_equal(plan.starts.numpy(), np.asarray(plan_j.starts))
        assert (plan.window, plan.tile_rows) == (plan_j.window, plan_j.tile_rows)
        assert plan.starts.dtype == torch.int32


def _plan_cases():
    rng = np.random.default_rng(5)
    banded = [(_banded_indices(rng, R, K, M, band), M, tr)
              for R, K, M, band, tr in ((300, 8, 500, 20, 256), (123, 5, 200, 20, 256),
                                        (2000, 16, 1500, 20, 256), (3000, 6, 15000, 100, 256),
                                        (700, 4, 90, 5, 128))]
    scattered = [(rng.integers(0, 100_000, (512, 8)).astype(np.int32), 100_000, 256)]
    return banded + scattered


@pytest.mark.parametrize("case", range(6))
def test_plan_windows_matches_jax(case):
    """Banded grids (one needing 128-row tiles: 3000 rows over 15000 values
    with +-100 bands, and one with fewer values than a window) and the
    scattered grid the JAX planner refuses (test_windowed_gather.py:54-57)."""
    idx, M, tile_rows = _plan_cases()[case]
    valid = np.random.default_rng(case).random(idx.shape) > 0.3
    plan = wg.plan_windows(idx, valid, M, tile_rows=tile_rows)
    _same_plan(plan, wg_jax.plan_windows(idx, valid, M, tile_rows=tile_rows))
    assert (plan is None) == (case == 5)
    if case == 3:
        assert plan.tile_rows == 128


@pytest.mark.parametrize("R,K,M,C", [(300, 8, 500, 2), (123, 5, 200, 3), (2000, 16, 1500, 4)])
def test_windowed_take_plain_matches_jax(R, K, M, C):
    """The shapes of test_windowed_gather.py:24; bitwise equal to the JAX
    kernel in interpret mode, and to values[idx] on every valid slot."""
    rng = np.random.default_rng(R)
    idx = _banded_indices(rng, R, K, M, band=20)
    valid = rng.random((R, K)) > 0.3
    values = rng.normal(size=(M, C)).astype(np.float32)
    plan = wg.plan_windows(idx, valid, M)
    plan_j = wg_jax.plan_windows(idx, valid, M)
    out = wg.windowed_take(torch.from_numpy(values), torch.from_numpy(idx), plan)
    out_j = np.asarray(wg_jax.windowed_take(jnp.asarray(values), jnp.asarray(idx), plan_j,
                                            interpret=True))
    np.testing.assert_array_equal(out.numpy(), out_j)
    np.testing.assert_array_equal(out.numpy()[valid], values[idx][valid])


def test_windowed_take_out_of_window_is_zero():
    """A poisoned slot (outside its tile's window) and a -1 slot give exact
    zeros, as in the JAX kernel (test_windowed_gather.py:38)."""
    rng = np.random.default_rng(1)
    M, R, K = 3000, 1000, 4
    idx = _banded_indices(rng, R, K, M, band=10)
    valid = np.ones((R, K), bool)
    valid[5, 2] = valid[7, 1] = False
    plan = wg.plan_windows(idx, valid, M)
    plan_j = wg_jax.plan_windows(idx, valid, M)
    idx2 = idx.copy()
    idx2[5, 2] = M - 1
    assert not 0 <= idx2[5, 2] - int(plan.starts[0]) < plan.window
    idx2[7, 1] = -1
    values = rng.normal(size=(M, 2)).astype(np.float32)
    out = wg.windowed_take(torch.from_numpy(values), torch.from_numpy(idx2), plan).numpy()
    out_j = np.asarray(wg_jax.windowed_take(jnp.asarray(values), jnp.asarray(idx2), plan_j,
                                            interpret=True))
    np.testing.assert_array_equal(out, out_j)
    np.testing.assert_array_equal(out[5, 2], np.zeros(2, np.float32))
    np.testing.assert_array_equal(out[7, 1], np.zeros(2, np.float32))


def test_windowed_take_window_past_values():
    """A window wider than the value array (M = 90 < 128): rows past M read
    as zero, the ragged last tile is taken, and the CPU wrapper never
    counts a launch."""
    rng = np.random.default_rng(2)
    M, R, K = 90, 300, 3
    idx = rng.integers(0, M, (R, K)).astype(np.int32)
    plan = wg.plan_windows(idx, np.ones((R, K), bool), M)
    assert plan.window == 128 > M and R % plan.tile_rows
    values = torch.from_numpy(rng.normal(size=(M, 3)).astype(np.float32))
    before = wg.windowed_take.launches
    out = wg.windowed_take(values, torch.from_numpy(idx), plan)
    assert wg.windowed_take.launches == before
    np.testing.assert_array_equal(out.numpy(), values.numpy()[idx])


@pytest.mark.parametrize("bad", ["f64 values", "5 channels", "i64 idx", "short plan"])
def test_windowed_take_refuses_bad_inputs(bad):
    values = torch.zeros((50, 2))
    idx = torch.zeros((40, 3), dtype=torch.int32)
    plan = wg.WindowPlan(torch.zeros(1, dtype=torch.int32), 128, 256)
    if bad == "f64 values":
        values = values.double()
    elif bad == "5 channels":
        values = torch.zeros((50, 5))
    elif bad == "i64 idx":
        idx = idx.long()
    else:
        idx = torch.zeros((300, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        wg.windowed_take(values, idx, plan)


@pytest.mark.parametrize("turn_every", [50, 10**9])
def test_reorder_matches_jax(turn_every):
    """Same perm and inv as the JAX reorder, the landmarks and edges
    relabeled the same way, on the default walk and on a corridor."""
    ig, _ = generate_sequence(600, 240, seed=3, turn_every=turn_every)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    g2, perm, inv = reorder_landmarks_by_pose(g)
    gj2, perm_j, inv_j = reorder_jax(gj)
    np.testing.assert_array_equal(perm, perm_j)
    np.testing.assert_array_equal(inv, inv_j)
    np.testing.assert_array_equal(g2.landmarks.numpy(), np.asarray(gj2.landmarks))
    np.testing.assert_array_equal(g2.b_lm.numpy(), np.asarray(gj2.b_lm))
    np.testing.assert_array_equal(g2.landmarks.numpy()[inv], g.landmarks.numpy())
