"""``boslam_torch/utils/roofline.py`` against ``boslam/utils/roofline.py``:
the four models and ``roofline_report`` give the JAX module's floats
exactly (plain float arithmetic in the same order), over the reference
size, 10k, 100k, hot-landmark split rows and bf16 coupling blocks;
``chip_spec`` knows the three H100 parts only; and the kernels' work
counts give the bounds of PERF.md's kernel table on the H100 SXM."""

import pytest
import torch

from boslam.utils import roofline as RJ
from boslam_torch.graph.build import build_graph
from boslam_torch.synth import generate_sequence
from boslam_torch.utils import roofline as R

SXM = "NVIDIA H100 80GB HBM3"
# (NP, NL, NB, NO): the reference dataset, 301/141 seed 3, 10k, 100k, a chain of 1
SIZES = [(301, 141, 2432, 300), (301, 141, 2079, 300), (10000, 3900, 69000, 9999),
         (100000, 38563, 655744, 99999), (2, 1, 2, 1)]
# (K, K2, cg_iters, lm_rows, coupling_bytes)
PACKED = [(7, 24, 0, None, 4.0), (7, 24, 150, None, 4.0), (9, 31, 8.0, None, 4.0),
          (9, 31, 37.4, 1.25, 4.0), (7, 24, 64, None, 2.0), (12, 40, 5.6, 1.5, 2.0)]


@pytest.mark.parametrize("dims", SIZES)
def test_step_models_equal_jax(dims):
    assert R.dense_step_model(*dims) == RJ.dense_step_model(*dims)
    assert R.schur_step_model(*dims) == RJ.schur_step_model(*dims)
    for cg in (0, 8, 150, 37.4):
        assert R.useful_step_flops(*dims, cg_iters=cg) == RJ.useful_step_flops(*dims, cg_iters=cg)


@pytest.mark.parametrize("dims", SIZES)
@pytest.mark.parametrize("K, K2, cg, lm_rows, coupling", PACKED)
def test_packed_outer_model_equals_jax(dims, K, K2, cg, lm_rows, coupling):
    NP_, NL, _, NO = dims
    rows = None if lm_rows is None else int(NL * lm_rows) + 1  # > NL: split rows
    kw = dict(lm_rows=rows, coupling_bytes=coupling)
    assert R.packed_outer_model(NP_, NL, K, K2, NO, cg, **kw) == \
        RJ.packed_outer_model(NP_, NL, K, K2, NO, cg, **kw)


@pytest.mark.parametrize("name", [SXM, "NVIDIA H100 PCIe", "NVIDIA H100 NVL"])
@pytest.mark.parametrize("model", ["dense", "schur", "packed"])
def test_roofline_report_equals_jax(name, model):
    """The port's spec on both sides (the JAX function reads the same four
    fields), at times that land in each ``bound`` class."""
    spec = R.chip_spec(name)
    dims = SIZES[1]
    if model == "dense":
        fb = R.dense_step_model(*dims)
    elif model == "schur":
        fb = R.schur_step_model(*dims)
    else:
        fb = R.packed_outer_model(dims[0], dims[1], 7, 24, dims[3], 37.4, lm_rows=160)
    for t in (1e-6, 1e-5, 3e-4, 2.5e-3, 1.0):
        mine = R.roofline_report(*fb, t, spec)
        assert mine == RJ.roofline_report(*fb, t, spec)
        assert mine["chip"] == spec.name


def test_chip_spec_table():
    """The H100 data sheet's dense peaks, by the names torch.cuda.get_device_name gives."""
    assert R.chip_spec(SXM) == R.ChipSpec("NVIDIA H100 SXM", 989.4e12, 67e12, 3.35e12)
    assert R.chip_spec("NVIDIA H100 PCIe") == R.ChipSpec("NVIDIA H100 PCIe", 756e12, 51.2e12,
                                                         2.0e12)
    assert R.chip_spec("NVIDIA H100 NVL") == R.ChipSpec("NVIDIA H100 NVL", 835e12, 60e12, 3.9e12)
    assert R.chip_spec(SXM + "\n") == R.chip_spec(SXM)


@pytest.mark.parametrize("name", ["TPU v5 lite", "NVIDIA A100-SXM4-80GB", "NVIDIA H200", "",
                                  "h100"])
def test_chip_spec_refuses_an_unknown_card(name):
    """No fallback: the JAX function assumes a v5e here; the port raises."""
    with pytest.raises(ValueError, match="no peak figures"):
        R.chip_spec(name)


def test_chip_spec_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        R.chip_spec()
    with pytest.raises(ValueError, match="no CUDA device"):
        R.roofline_report(1.0, 1.0, 1.0)  # the default spec is the card's


def test_bound_ms():
    spec = R.chip_spec(SXM)
    assert R.bound_ms(67e12 / 2 / 1e3, 0.0, spec) == (1.0, "operations")
    assert R.bound_ms(0.0, 3.35e12 / 1e3, spec) == (1.0, "bytes")
    ms, by = R.bound_ms(1.0, 1e9, R.chip_spec("NVIDIA H100 PCIe"))
    assert by == "bytes" and ms == pytest.approx(1e9 / 2.0e12 * 1e3, rel=1e-15)


def _table(x):
    """The kernel table's precision: three significant figures."""
    return float(f"{x:.3g}")


def test_kernel_bounds_match_the_kernel_table():
    """PERF.md section 6's bounds (67 TFLOP/s, 3.35 TB/s): the Cholesky at
    n = 1024-2048, the Schur solve and the whole step on the 301/141
    graph's envelope, the Schur solve counted densely on random systems,
    and the gather on the 100k corridor's landmark grid."""
    spec = R.chip_spec(SXM)
    chol = {n: _table(R.bound_ms(*R.cholesky_work(n), spec)[0]) for n in (1024, 1280, 1536,
                                                                           1664, 2048)}
    assert chol == {1024: 0.00537, 1280: 0.0105, 1536: 0.0181, 1664: 0.023, 2048: 0.0429}
    g, _ = build_graph(generate_sequence(301, 141, seed=3)[0], init="triangulate", device="cpu")
    assert R.bound_ms(*R.gn_step_work(g), spec)[1] == "operations"
    assert _table(R.bound_ms(*R.gn_step_work(g), spec)[0]) == 0.0000497
    assert _table(R.bound_ms(*R.schur_solve_work(g), spec)[0]) == 0.0000423
    assert _table(R.bound_ms(*R.schur_solve_dense_work(1024, 384), spec)[0]) == 0.0114
    assert _table(R.bound_ms(*R.schur_solve_dense_work(1280, 512), spec)[0]) == 0.0231
    ms, by = R.bound_ms(0.0, R.windowed_take_bytes(38563, 24, 100000, 3), spec)
    assert (_table(ms), by) == (0.00478, "bytes")
