"""On the card (``gpu`` marker; each test skips elsewhere, deciding inside
the test): the system comes out as correct at a size a test run holds;
and the repository's cell, at its own size and under its committed
limits, comes out as not correct with each fault of ``harness/faults.py``
planted and with the control, the system with its own lower-precision
path switched on.  (At the small size the card's control stays within
the committed limits; the CPU's does not, ``test_bench_harness.py``.)
Run on the card with

    python -m pytest -m gpu benchmark/tests/test_bench_gpu.py
"""

import logging

import pytest
import torch

from benchmark.harness import runner
from benchmark.harness.faults import FAULTS
from benchmark.tests.conftest import CELL, REPO

logging.getLogger("boslam_torch").setLevel(logging.ERROR)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_the_system_is_correct_at_a_small_size(tiny_root):
    _card()
    root = tiny_root("gn_pcg_jacobi")
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        port = runner.run(root, "tiny.gn_pcg_jacobi", seed, 0.5, False, device="cuda")
        assert port["correct"], port["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS + ("control",))
def test_the_committed_cell_catches_each_fault(fault):
    _card()
    r = runner.run(REPO, CELL, 2**31 + 71, 1.0, False, device="cuda",
                   control=fault == "control", fault=None if fault == "control" else fault)
    assert not r["correct"] and r["failed"] >= 1, r["checks"]
