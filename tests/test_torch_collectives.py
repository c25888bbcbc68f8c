"""``boslam_torch/utils/collectives.collective_bytes`` on 2 spawned gloo ranks
against ``boslam/utils/hlo.collective_bytes`` on 2 virtual CPU devices, for
the functions ``tools/mesh_scaling_bench.py`` and the flat layout account:
the edge-sharded flat normal-equation build (H, b and the chi2 stats), the
packed build, and the packed build plus one S matvec.

Bytes are compared per kind, not ``count``: XLA's all-reduce combiner may
merge what the port issues as separate calls.  The two differ in one
place, and the test holds both to the analytic formula there: the chi2
stats' two clamp counts are int64 in the port (``torch.sum`` of a bool)
and int32 in JAX (64-bit types off), so every build's all-reduce carries
2 x 4 more bytes in the port.  The JAX functions depend on every psum'd
result, or XLA would drop the unused psums (the comment at
``tools/mesh_scaling_bench.py:56``).
"""

import dataclasses
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from boslam.config import SolverConfig as SolverConfigJax
from boslam.graph.build import build_graph as build_graph_jax
from boslam.graph.packed import pack_edges as pack_edges_jax
from boslam.parallel.mesh import make_mesh as make_mesh_jax
from boslam.parallel.sharded import _graph_specs, shard_graph
from boslam.parallel.sharded_packed import _packed_specs, shard_packed
from boslam.solver import normal_eq as ne_jax
from boslam.solver import schur_packed as sp_jax
from boslam.solver.schur import _pose_mask as pose_mask_jax
from boslam.synth import generate_sequence
from boslam.utils.hlo import collective_bytes as collective_bytes_jax
from boslam_torch.config import SolverConfig
from boslam_torch.graph.data import FactorGraph
from boslam_torch.parallel.mesh import spawn
from boslam_torch.utils.collectives import COLLECTIVES, collective_bytes

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
import port_mesh_sweep  # noqa: E402  (imports no JAX: the spawned ranks import it)

D = 2
CASES = ("flat_build", "packed_build", "packed_build_plus_matvec")
STATS_F32, STATS_INT = 3, 2  # chi2_bearing, chi2_odometry, chi2_robust; two clamp counts


@pytest.fixture(scope="module")
def graphs():
    ig, _ = generate_sequence(80, 40, seed=3, loop_closures=2)
    gj, _ = build_graph_jax(ig, init="triangulate")
    g = FactorGraph.from_numpy({k: np.asarray(v) for k, v in dataclasses.asdict(gj).items()},
                               device="cpu")
    return g, gj


@pytest.fixture(scope="module")
def port(graphs, tmp_path_factory):
    """{case: [its collective_bytes on each rank]}, one spawn."""
    store = str(tmp_path_factory.mktemp("collectives") / "store")
    cfg = SolverConfig(linear_solver="schur_cg")
    res = spawn([(port_mesh_sweep.collectives_job, (graphs[0], cfg), {})], D, store)
    return {case: [r[0][case] for r in res] for case in CASES}


def _jax_functions(gj):
    """The three functions under shard_map over D virtual devices, and
    their sharded inputs."""
    cfg = SolverConfigJax(linear_solver="schur_cg")
    mesh = make_mesh_jax(D)
    axis = mesh.axis_names[0]
    gspecs = _graph_specs(axis)
    gs = shard_graph(gj, mesh)
    pk, _ = pack_edges_jax(gj)
    gsp, pks = shard_packed(gj, pk, mesh)
    pspecs = _packed_specs(pks, axis)

    @partial(jax.shard_map, mesh=mesh, in_specs=(gspecs,), out_specs=P())
    def flat_build(g):
        H, b, terms = ne_jax.assemble_dense(g, cfg, axis_name=axis)
        st = ne_jax.chi2_stats(terms, cfg, axis)
        return jnp.sum(H) + jnp.sum(b) + sum(jnp.sum(v).astype(H.dtype) for v in st.values())

    def _blocks_sum(blocks, stats):
        return (sum(jnp.sum(v).astype(blocks.Hpp_diag.dtype) for v in stats.values())
                + jnp.sum(blocks.Hpp_diag) + jnp.sum(blocks.Hll_inv) + jnp.sum(blocks.bp)
                + jnp.sum(blocks.bl))

    @partial(jax.shard_map, mesh=mesh, in_specs=(gspecs, pspecs), out_specs=P())
    def packed_build(g, pk):
        return _blocks_sum(*sp_jax.build_packed_blocks(g, pk, cfg, cfg.damping, axis))

    @partial(jax.shard_map, mesh=mesh, in_specs=(gspecs, pspecs), out_specs=P())
    def packed_build_plus_matvec(g, pk):
        blocks, stats = sp_jax.build_packed_blocks(g, pk, cfg, cfg.damping, axis)
        mask = pose_mask_jax(g.n_poses, g.fixed_pose_ix, g.poses.dtype)
        x = jnp.ones((g.n_poses, 3), g.poses.dtype)
        y = sp_jax.packed_s_matvec(blocks, pk, x, mask, axis)
        return _blocks_sum(blocks, stats) + y.sum()

    return {"flat_build": (flat_build, (gs,)), "packed_build": (packed_build, (gsp, pks)),
            "packed_build_plus_matvec": (packed_build_plus_matvec, (gsp, pks))}


@pytest.fixture(scope="module")
def jax_counts(graphs):
    return {case: collective_bytes_jax(fn, *args)
            for case, (fn, args) in _jax_functions(graphs[1]).items()}


def _analytic_all_reduce(case, g, int_bytes):
    """All-reduce bytes of ``case``: the psum'd sums in f32, the stats'
    three f32 sums and two counts of ``int_bytes`` each."""
    NP_, NL, N = g.n_poses, g.n_landmarks, g.state_dim
    stats = 4 * STATS_F32 + int_bytes * STATS_INT
    if case == "flat_build":
        return 4 * (N * N + N) + stats
    build = 4 * (9 * NP_ + 4 * NL + 3 * NP_ + 2 * NL) + stats
    if case == "packed_build":
        return build
    return build + 4 * (2 * NL + 3 * NP_)  # z [NL,2] and the y partials [NP,3]


@pytest.mark.parametrize("case", CASES)
def test_bytes_per_kind_match_the_hlo_count(graphs, port, jax_counts, case):
    g = graphs[0]
    j = jax_counts[case]
    for rank_rec in port[case]:
        assert set(rank_rec) == set(j) == set(COLLECTIVES) | {"count", "total"}
        assert rank_rec == port[case][0]  # every rank counts the same
    p = port[case][0]
    for kind in COLLECTIVES:
        if kind != "all-reduce":
            assert p[kind] == j[kind] == 0, kind
    # the one difference: int64 clamp counts in the port, int32 in JAX
    assert p["all-reduce"] == _analytic_all_reduce(case, g, int_bytes=8)
    assert j["all-reduce"] == _analytic_all_reduce(case, g, int_bytes=4)
    assert p["all-reduce"] - j["all-reduce"] == STATS_INT * (8 - 4)
    assert p["total"] == p["all-reduce"] and j["total"] == j["all-reduce"]


def test_matvec_bytes_by_difference_equal_jax(port, jax_counts):
    """Per-iteration bytes as ``mesh_scaling_bench._hlo_collectives`` reads
    them: build + matvec minus build, equal in the two packages."""
    matvec = {k: v["packed_build_plus_matvec"]["total"] - v["packed_build"]["total"]
              for k, v in (("port", {c: port[c][0] for c in CASES}), ("jax", jax_counts))}
    assert matvec["port"] == matvec["jax"] > 0


def test_counts_reset_per_call(port):
    """``collective_bytes`` resets the mesh's counters: the build alone
    counts the same in both places it is measured, and the port makes one
    call per dtype of a psum (f32 blocks and sums, int64 counts)."""
    for rank_rec in port["packed_build"]:
        assert rank_rec["count"] == 2
    assert port["packed_build_plus_matvec"][0]["count"] == 4  # + z, + y partials
    assert port["flat_build"][0]["count"] == 3  # H and b; the f32 stats; the counts


def test_counters_reset_and_kinds_mapped():
    """In this process, on a stand-in with ``parallel/mesh.Mesh``'s
    counters: counts from before the call are cleared, psum and pmax count
    as all-reduce, all_gather as all-gather, psum_scatter as
    reduce-scatter, and ``fn`` gets the mesh."""
    import torch

    from boslam_torch.parallel.mesh import KINDS

    class Counters:
        def __init__(self):
            self.bytes = dict.fromkeys(KINDS, 1000)  # stale counts
            self.calls = dict.fromkeys(KINDS, 7)

        def reset_counts(self):
            self.bytes, self.calls = dict.fromkeys(KINDS, 0), dict.fromkeys(KINDS, 0)

        def count(self, kind, x):
            self.bytes[kind] += x.numel() * x.element_size()
            self.calls[kind] += 1

    def fn(x, scale, mesh):
        for kind, y in (("psum", x), ("pmax", x.double()), ("all_gather", x[:2]),
                        ("psum_scatter", x[:1])):
            mesh.count(kind, y * scale)

    rec = collective_bytes(fn, torch.ones(5, 3), 2.0, mesh=Counters())
    assert rec == {"all-reduce": 60 + 120, "all-gather": 24, "reduce-scatter": 12,
                   "collective-permute": 0, "count": 4, "total": 60 + 120 + 24 + 12}
