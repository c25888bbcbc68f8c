"""The system under test behind one interface, and the control that takes
its place.

``Port`` drives the project's PyTorch and CUDA package, ``boslam_torch``:
the entry the window times is

1. ``graph.build.build_graph(parsed, init="triangulate", device=cuda)``,
   which uploads the graph and triangulates the landmarks on the card;
2. ``solver.optimizer.solve(graph, cfg)`` or ``solve_packed(graph, cfg)``
   (the traffic's ``entry``);
3. the final poses and landmarks copied to the host, which ends the solve.

The control, the system with its own lower-precision path switched on
(the cell's ``benchmark/checks/<cell>.json`` names the ``SolverConfig``
fields that switch it on), is a ``Port`` too.

Each ``solve`` returns an ``Answer``: what the timed path produced (the
triangulated start, the robust chi2 at each step's linearisation point,
the final state on the host) and its host-clock spans.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch


class Answer(NamedTuple):
    graph: int  # index into the pool
    t0: float  # host clock: the solve's start
    t_build: float  # the graph built and its landmarks triangulated (synchronised)
    t_solve: float  # the entry returned (enqueued)
    t_end: float  # the final state on the host
    iters: int
    landmarks0: object  # the triangulated start, as the system left it (device tensor)
    chi2: object  # [iters] robust chi2 at each step's linearisation point (device tensor)
    cg_iters: object  # [iters] CG iterations per outer step, or None
    poses: np.ndarray  # final, on the host
    landmarks: np.ndarray


@contextlib.contextmanager
def _span(name: str, traced: bool):
    if not traced:
        yield
        return
    from torch.profiler import record_function

    with record_function(f"benchmark::{name}"):
        yield


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Port:
    """``boslam_torch`` on ``device``, configured from the cell's files.

    ``solver``: the ``SolverConfig`` fields (the configuration's, then the
    traffic's); ``entry``: "solve" or "solve_packed"."""

    def __init__(self, device, solver: dict, entry: str):
        import logging

        import boslam_torch  # noqa: F401  (pins full-f32 products)
        from boslam_torch.config import SolverConfig
        from boslam_torch.graph.build import build_graph
        from boslam_torch.io.g2o import ParsedG2O
        from boslam_torch.solver import optimizer

        # the build warns once per landmark with a single observation;
        # a batch solver does not print a line per map
        logging.getLogger("boslam_torch").setLevel(logging.ERROR)
        self.device = torch.device(device)
        self.cfg = SolverConfig(**solver)
        self.iters = self.cfg.iters
        self._build = build_graph
        self._parsed = ParsedG2O
        if entry not in ("solve", "solve_packed"):
            raise SystemExit(f"unknown entry {entry!r}: solve or solve_packed")
        self._entry = getattr(optimizer, entry)

    def prepare(self, parsed):
        """The generated input as the system's parse result (set-up)."""
        return self._parsed(**parsed._asdict())

    def solve(self, k: int, prepared, traced: bool = False) -> Answer:
        t0 = time.perf_counter()
        with _span("build", traced):
            g, _ = self._build(prepared, init="triangulate", device=self.device)
            _sync(self.device)
        t_build = time.perf_counter()
        with _span("solve", traced):
            out, stats = self._entry(g, self.cfg)
        t_solve = time.perf_counter()
        with _span("readback", traced):
            poses, lms = out.poses.cpu().numpy(), out.landmarks.cpu().numpy()
        t_end = time.perf_counter()
        return Answer(k, t0, t_build, t_solve, t_end, self.iters, g.landmarks,
                      stats["chi2_robust"], stats.get("cg_iters"), poses, lms)
