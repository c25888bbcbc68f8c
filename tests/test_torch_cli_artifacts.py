"""The port's CLI artifacts and flags of the single-device remainder, on the
CPU: ``--render`` (both PNGs), ``--print-state`` (the JAX package's line on
the same state), ``--profile`` (a Chrome trace), ``--interactive``
(refused on a headless backend, with the JAX CLI's message), and the
solver flags reaching ``SolverConfig`` as the JAX CLI's do."""

import argparse
import dataclasses
import io
import json
import os

import numpy as np
import pytest

import boslam.cli as cli_jax
from boslam_torch.cli import main

PORT_ONLY = {"--device"}
JAX_ONLY = {"--sharded", "--pose-range", "--platform"}  # multi-device: later; --device here


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    ds = str(tmp_path_factory.mktemp("cli_art") / "s.g2o")
    assert main(["synth", "--poses", "60", "--landmarks", "30", "--seed", "2", "--out", ds]) == 0
    return ds


def _flags(module_main):
    """The option strings of a CLI's ``solve`` and ``bench`` subparsers,
    read from the parser its ``main`` builds."""
    found = {}

    def hook(self, args=None, namespace=None):
        sp = next(a for a in self._actions if isinstance(a, argparse._SubParsersAction))
        for name in ("solve", "bench"):
            found[name] = set(sp.choices[name]._option_string_actions) - {"-h", "--help"}
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", hook)
        with pytest.raises(SystemExit):
            module_main([])
    return found


def test_every_jax_flag_but_multi_device():
    """`solve --help` and `bench --help` list every JAX CLI flag except
    --sharded, --pose-range and --platform (the port's is --device)."""
    port, jax_ = _flags(main), _flags(cli_jax.main)
    for sub in ("solve", "bench"):
        assert port[sub] - PORT_ONLY == jax_[sub] - JAX_ONLY, sub


def test_new_flags_reach_solver_config(dataset, monkeypatch):
    """The flags of this slice give the same SolverConfig fields as the JAX
    CLI's _cfg_from_args on the same command line."""
    argv = ["--packed", "--linear-solver", "schur_cg", "--preconditioner", "bband",
            "--band-width", "5", "--band-group", "6", "--coupling-dtype", "bfloat16",
            "--autodiff-jacobians", "--iters", "2", "--cg-iters", "30"]
    import boslam_torch.solver.optimizer as opt

    seen = {}
    solve_packed = opt.solve_packed

    def recording(g, cfg, **kw):
        seen["cfg"] = cfg
        return solve_packed(g, cfg, **kw)

    monkeypatch.setattr(opt, "solve_packed", recording)
    assert main(["solve", dataset, "--device", "cpu", *argv]) == 0
    jax_args = {}
    monkeypatch.setattr(cli_jax, "cmd_solve", lambda a: jax_args.setdefault("a", a) and 0)
    cli_jax.main(["solve", dataset, *argv])
    cfg, cfg_j = seen["cfg"], cli_jax._cfg_from_args(jax_args["a"])
    for f in dataclasses.fields(cfg_j):
        assert getattr(cfg, f.name) == getattr(cfg_j, f.name), f.name
    assert (cfg.band_width, cfg.band_group, cfg.coupling_dtype, cfg.use_autodiff_jacobians) == (
        5, 6, "bfloat16", True)


def test_render_writes_both_pngs(dataset, tmp_path):
    out = str(tmp_path / "r.png")
    assert main(["solve", dataset, "--linear-solver", "schur", "--iters", "2", "--device", "cpu",
                 "--render", out]) == 0
    for p in (out, str(tmp_path / "r_initial.png")):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p


def test_print_state_matches_jax_line(dataset, capsys):
    """The "State: ..." line equals the JAX package's print_full_state on
    the same (the port's final) state."""
    from boslam.graph.data import print_full_state as print_jax
    from boslam_torch.config import SolverConfig
    from boslam_torch.graph.build import build_graph
    from boslam_torch.io.g2o import parse_g2o
    from boslam_torch.solver.optimizer import solve

    capsys.readouterr()
    assert main(["solve", dataset, "--linear-solver", "schur", "--iters", "3", "--device", "cpu",
                 "--print-state"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("State: ")]
    assert len(lines) == 1
    g, _ = build_graph(parse_g2o(dataset), device="cpu")
    g2, _ = solve(g, SolverConfig(linear_solver="schur", iters=3))
    buf = io.StringIO()
    print_jax(g2.poses.numpy(), g2.landmarks.numpy(), file=buf)
    assert lines[0] == buf.getvalue().rstrip("\n")
    assert len(lines[0].split()) == 1 + 3 * g.n_poses + 2 * g.n_landmarks


def test_profile_writes_trace(dataset, tmp_path, capsys):
    from boslam_torch.utils.profiling import TRACE_FILE

    d = str(tmp_path / "prof")
    assert main(["solve", dataset, "--linear-solver", "schur", "--iters", "2", "--device", "cpu",
                 "--profile", d]) == 0
    assert "profile trace written" in capsys.readouterr().err
    with open(os.path.join(d, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_interactive_refused_headless(dataset, monkeypatch, capsys):
    """On a headless backend (Agg, no DISPLAY) --interactive refuses with the
    JAX CLI's message and returns 2."""
    import matplotlib

    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("MPLBACKEND", raising=False)
    matplotlib.use("Agg")
    capsys.readouterr()
    assert main(["solve", dataset, "--interactive", "--iters", "2", "--device", "cpu"]) == 2
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert cli_jax._interactive_loop(None, None, None) == 2
    assert err == capsys.readouterr().err.strip()
    assert err.startswith("error: --interactive needs a GUI matplotlib backend")


def test_timeit_and_flops():
    from boslam.utils.profiling import gn_step_flops as flops_jax
    from boslam_torch.utils.profiling import gn_step_flops, timeit

    r = timeit(lambda: np.ones(10).sum(), repeats=3, device="cpu")
    assert len(r["times"]) == 3 and r["best_s"] <= r["mean_s"]
    assert gn_step_flops(301, 141, 2000, 300) == flops_jax(301, 141, 2000, 300)
