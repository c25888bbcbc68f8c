"""What a cell is, read from the data: ``BENCHMARK.json`` at the root of
the checkout names the cells, the configurations' files and the metrics;
each configuration, traffic mix, cell's limits and metric lives in a file
of its own that the harness finds by name:

- ``benchmark/configs/<config>.json`` (the configuration's ``file``);
- ``benchmark/traffic/<traffic>.json``;
- ``benchmark/checks/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from, and the control;
- ``benchmark/metrics/<metric>.py``: a reader ``read(run) -> float | None``.

A cell, configuration or metric is added by adding files and entries; no
code changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = "benchmark"


class Metric(NamedTuple):
    name: str
    unit: str
    read: object  # read(run) -> float | None


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list  # [Metric]
    per_layer: list


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SystemExit(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


def load_reader(root: Path, name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"metric {name!r}: no reader {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise SystemExit(f"metric {name!r}: {path} has no read(run)")
    return mod.read


def cell_names(root: Path) -> list:
    bench = _load_json(Path(root) / "BENCHMARK.json", "benchmark")
    return [w["name"] for w in bench["workloads"]]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read and
    its metrics' readers loaded; exits with a message for an unknown cell
    or a metric without a reader."""
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json", "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has: {', '.join(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SystemExit(f"workload {name!r}: unknown config {w['config']!r}")
    config = _load_json(root / configs[w["config"]]["file"], f"config {w['config']!r}")
    traffic = _load_json(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json",
                         f"traffic {w['traffic']!r}")
    checks = _load_json(root / BENCH_DIR / "checks" / f"{name}.json", f"checks of {name!r}")

    def metrics(kind):
        return [Metric(m["name"], m["unit"], load_reader(root, m["name"]))
                for m in bench[kind] if name in m.get("workloads", [name])]

    return Cell(name, int(w["chips"]), config, traffic, checks, metrics("end_to_end"),
                metrics("per_layer"))
