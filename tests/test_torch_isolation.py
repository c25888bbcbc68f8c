"""The port stands alone: importing it (or chip_smoke.py) pulls in neither
JAX nor any module of the JAX package, nor matplotlib (absent where the
card is; only --render and --interactive import it, when they run), and its
entry points refuse to run on the CPU unless asked to."""

import os
import subprocess
import sys

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import boslam_torch, boslam_torch.cli, boslam_torch.metrics, boslam_torch.synth
import boslam_torch.ops.cholesky, boslam_torch.ops.schur_solve, boslam_torch.solver.optimizer
import boslam_torch.ops.gn_step, boslam_torch.ops.windowed_gather
import boslam_torch.graph.packed, boslam_torch.graph.reorder
import boslam_torch.solver.btridiag, boslam_torch.solver.schur_packed
import boslam_torch.solver.two_level, boslam_torch.solver.coarse
import boslam_torch.init.pose_graph, boslam_torch.io.checkpoint
import boslam_torch.solver.bband, boslam_torch.io.native, boslam_torch.viz.draw
import boslam_torch.utils.profiling
import boslam_torch.parallel, boslam_torch.parallel.mesh, boslam_torch.parallel.sharded
import boslam_torch.parallel.sharded_packed, boslam_torch.parallel.pose_range
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "boslam" or m.startswith("boslam.")
             or m == "matplotlib" or m.startswith("matplotlib."))
print("BAD=" + ",".join(bad))
"""


def test_no_jax_and_no_boslam_imported():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout, out.stdout


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    import dataclasses

    from boslam_torch.graph.build import build_graph
    from boslam_torch.graph.data import FactorGraph
    from boslam_torch.synth import generate_sequence

    ig, _ = generate_sequence(20, 10, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_graph(ig)
    g, _ = build_graph(ig, device="cpu")
    assert g.device.type == "cpu"
    arrays = {k: v.numpy() for k, v in dataclasses.asdict(g).items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        FactorGraph.from_numpy(arrays)
    assert FactorGraph.from_numpy(arrays, device="cpu").device.type == "cpu"


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from boslam_torch.cli import main

    path = str(tmp_path / "s.g2o")
    assert main(["synth", "--poses", "30", "--landmarks", "15", "--out", path]) == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["solve", path, "--iters", "1"])
    assert main(["solve", path, "--iters", "2", "--linear-solver", "schur", "--device", "cpu",
                 "--gt", path.replace(".g2o", "_ground_truth.g2o")]) == 0
