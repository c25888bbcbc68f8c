"""The port's slice as a whole: GN and LM over the exact-Schur and dense
solves, on the CPU, against ``boslam.solver.optimizer`` with
``fused_step="off"`` on the same graph.

Tolerances: statistics of one state are compared at rtol 1e-6.  After a
solve, states differ by the f32 forward error of the ~1e7-conditioned
system.  The step-0 state is held to twice that error as the JAX package
itself shows it: the gap between its own dense and Schur solves of the
same step.  chi2 traces use the bound for two f32 summation orders
(test_assembly_modes.py:56, rtol 5e-4), and the converged chi2
test_pallas_gn_step.py:93's rel 1e-5.
"""

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
from boslam_torch.solver import optimizer as opt

TRACE_RTOL = 5e-4


@pytest.fixture(autouse=True)
def _few_threads():
    # six test workers share the cores; an oversubscribed intra-op pool
    # makes the 50-iteration solves an order of magnitude slower
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _graphs(seed, loop_closures=0):
    ig, _ = generate_sequence(301, 141, seed=seed, loop_closures=loop_closures)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


def _solve_both(g, gj, **kw):
    g2, st = opt.solve(g, SolverConfig(fused_step="off", **kw))
    gj2, stj = opt_jax.solve(gj, SolverConfigJax(fused_step="off", **kw))
    return g2, {k: v.numpy() for k, v in st.items()}, gj2, {k: np.asarray(v) for k, v in stj.items()}


@pytest.mark.parametrize("loop_closures", [0, 4])
def test_schur_step0(loop_closures):
    """One GN-schur step at reference size (seed 0).  The statistics of the
    shared initial state hold at rtol 1e-6.  The updated poses, landmarks
    and delta_norm hold within 2x the gap between the JAX package's own
    dense and Schur steps from that state (the gap is 1.4e-3 to 1.8e-3 in
    the state on these graphs, max|step| ~6.3; the port's distance from
    the JAX Schur step is 0.4x to 1.3x the gap)."""
    g, gj = _graphs(0, loop_closures)
    g1, s1 = opt.gn_step(g, SolverConfig(linear_solver="schur", fused_step="off"))
    gj1, sj1 = opt_jax.gn_step(gj, SolverConfigJax(linear_solver="schur", fused_step="off"))
    gjd, sjd = opt_jax.gn_step(gj, SolverConfigJax(linear_solver="dense", fused_step="off"))
    for k in ("chi2_bearing", "chi2_odometry", "chi2_robust"):
        np.testing.assert_allclose(s1[k].numpy(), np.asarray(sj1[k]), rtol=1e-6, err_msg=k)
    for k in ("n_bearing_clamped", "n_odometry_clamped", "spd_ok", "accepted"):
        assert s1[k].item() == np.asarray(sj1[k]).item(), k
    for k in ("poses", "landmarks", "delta_norm"):
        port = (getattr(g1, k) if k != "delta_norm" else s1[k]).numpy()
        jax_s = np.asarray(getattr(gj1, k) if k != "delta_norm" else sj1[k])
        jax_d = np.asarray(getattr(gjd, k) if k != "delta_norm" else sjd[k])
        gap, err = np.abs(jax_d - jax_s).max(), np.abs(port - jax_s).max()
        print(f"step0 loop_closures={loop_closures} {k}: port-vs-jax {err:.4e}, "
              f"jax dense-vs-schur {gap:.4e}, ratio {err / gap:.3f}")
        assert 0.0 < gap < 1e-2, (k, gap)
        assert err <= 2.0 * gap, (k, err, gap)


def test_schur_converged_50_iterations():
    """50 GN-schur iterations on generate_sequence(301, 141, seed=3), the
    synthetic graph with the reference dataset's exact dimensions (301
    poses, 141 landmarks, N = 1185), which GN drives to a fixed point:
    converged chi2_robust at rel 1e-5, every spd_ok true."""
    g, gj = _graphs(3)
    _, st, _, stj = _solve_both(g, gj, linear_solver="schur", iters=50)
    c, cj = st["chi2_robust"], stj["chi2_robust"]
    np.testing.assert_allclose(c[0], cj[0], rtol=1e-6)
    assert abs(c[-1] - cj[-1]) / cj[-1] < 1e-5
    assert st["spd_ok"].all() and stj["spd_ok"].all()
    assert st["chi2_robust"].shape == (50,)


def test_schur_seed0_limit_cycle():
    """On seed 0 both packages fall, after ~8 iterations, into the same
    two-state cycle: one bearing edge flips in and out of the threshold
    kernel's clamp (chi2_robust ~0.308 or ~1.308), and f32 rounding decides
    the phase, so the value at iteration 50 is not comparable.  The trace
    before the cycle and the floor of the cycle are."""
    g, gj = _graphs(0)
    _, st, _, stj = _solve_both(g, gj, linear_solver="schur", iters=50)
    c, cj = st["chi2_robust"], stj["chi2_robust"]
    np.testing.assert_allclose(c[:6], cj[:6], rtol=TRACE_RTOL)
    clamped = st["n_bearing_clamped"] + st["n_odometry_clamped"]
    clamped_j = stj["n_bearing_clamped"] + stj["n_odometry_clamped"]
    # with one edge clamped the robust cost carries exactly kt = 1 for it
    floor, floor_j = (c - clamped)[-20:].min(), (cj - clamped_j)[-20:].min()
    assert abs(floor - floor_j) / floor_j < 1e-3
    assert clamped[-20:].max() <= 1 and clamped_j[-20:].max() <= 1


def test_dense_path_few_iterations():
    g, gj = _graphs(0)
    g2, st, gj2, stj = _solve_both(g, gj, linear_solver="dense", iters=3)
    np.testing.assert_allclose(st["chi2_robust"], stj["chi2_robust"], rtol=TRACE_RTOL)
    assert st["spd_ok"].all()


@pytest.mark.parametrize("linear_solver", ["schur", "dense"])
def test_lm_few_iterations(linear_solver):
    """Two LM trials.  LM's first damping (1e-3) is ten times below GN's,
    which leaves the system worse conditioned still: from the third trial
    on, the iterates of two f32 solvers drift apart at the 1e-2 level, so
    only the first two trials are held to the trace bound."""
    g, gj = _graphs(0)
    _, st, _, stj = _solve_both(g, gj, linear_solver=linear_solver, optimizer="lm", iters=2)
    np.testing.assert_allclose(st["chi2_robust"], stj["chi2_robust"], rtol=TRACE_RTOL)
    np.testing.assert_array_equal(st["accepted"], stj["accepted"])
    np.testing.assert_allclose(st["damping"], stj["damping"], rtol=1e-6)


def test_unported_options_raise():
    g, _ = _graphs(0)
    with pytest.raises(NotImplementedError):
        opt.solve(g, SolverConfig(linear_solver="schur", fused_step="force", iters=1))
    with pytest.raises(NotImplementedError):
        opt.solve(g, SolverConfig(linear_solver="schur_cg", iters=1))


@pytest.mark.parametrize("field, value", [
    ("dtype", "float64"), ("gnc_kt0", 50.0), ("cholesky_backend", "xla"),
    ("cg_iters", 10), ("gather", "windowed"), ("coupling_dtype", "bfloat16"),
])
@pytest.mark.parametrize("optimizer", ["gn", "lm"])
def test_unported_fields_raise(field, value, optimizer):
    """A field the port keeps only for parity with the JAX config is refused
    at any value but its default, on every step, rather than ignored."""
    from boslam_torch.config import UNPORTED_FIELDS
    from boslam_torch.graph.build import build_graph
    from boslam_torch.synth import generate_sequence as generate_sequence_torch

    assert field in UNPORTED_FIELDS
    g, _ = build_graph(generate_sequence_torch(20, 10, seed=0)[0], device="cpu")
    cfg = SolverConfig(linear_solver="schur", optimizer=optimizer, iters=1, **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        opt.solve(g, cfg)
    with pytest.raises(NotImplementedError, match=field):
        if optimizer == "gn":
            opt.gn_step(g, cfg)
        else:
            opt.lm_step(g, torch.ones(()), cfg)
    opt.solve(g, cfg.replace(**{field: getattr(SolverConfig(), field)}))
