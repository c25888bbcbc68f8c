"""The system under test with its timed path broken underneath, once for
each fault a cell of this benchmark can have.  A run with any of them in
the system's place has to come out as not correct (``benchmark/tests``,
and on the card ``benchmark/control.py --fault``):

- ``unchanged``: every step returns its state (the chi2 trace repeats the
  start's, the final state is the start);
- ``half_batch``: every second bearing edge left out of the input;
- ``stale``: the answer read back is the state before the last step.

(One card, so there is no exchange between chips to leave out.)
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import system

FAULTS = ("unchanged", "half_batch", "stale")


class Faulty(system.Port):
    def __init__(self, device, solver: dict, entry: str, fault: str):
        if fault not in FAULTS:
            raise SystemExit(f"unknown fault {fault!r}; known: {', '.join(FAULTS)}")
        super().__init__(device, solver, entry)
        self.fault = fault

    def prepare(self, parsed):
        if self.fault == "half_batch":
            keep = np.arange(len(parsed.bearing_meas)) % 2 == 0
            parsed = parsed._replace(**{f: getattr(parsed, f)[keep] for f in (
                "bearing_pose_id", "bearing_lm_id", "bearing_meas", "bearing_omega")})
        return super().prepare(parsed)

    def solve(self, k, prepared, traced=False):
        real = self._entry
        if self.fault == "unchanged":
            def broken(g, cfg):
                _, st = real(g, cfg.replace(iters=1))
                return g, {"chi2_robust": st["chi2_robust"].repeat(cfg.iters)}
        elif self.fault == "stale":
            def broken(g, cfg):
                _, st = real(g, cfg)
                before, _ = real(g, cfg.replace(iters=cfg.iters - 1))
                return before, st
        else:
            return super().solve(k, prepared, traced)
        self._entry = broken
        try:
            return super().solve(k, prepared, traced)
        finally:
            self._entry = real
