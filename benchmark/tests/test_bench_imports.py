"""What the harness and the reference import, read from their sources
(``ast``), through every module of the benchmark they reach: no JAX and
no JAX package anywhere, and nothing of the system under test in the
reference.  Top-level names are compared whole (the system's name,
``boslam_torch``, begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "boslam"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
    return names


def _module_file(name: str):
    """The file of a ``benchmark.*`` module, or None."""
    parts = name.split(".")
    if parts[0] != "benchmark":
        return None
    base = BENCH.joinpath(*parts[1:])
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def reached(entries) -> tuple:
    """(files of the benchmark reached, top-level names imported outside it)."""
    todo, seen, outside = list(entries), set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            f = _module_file(name)
            if f is not None:
                todo.append(f)
            elif name.split(".")[0] != "benchmark":
                outside.add(name.split(".")[0])
    return seen, outside


HARNESS = [BENCH / "run.py", BENCH / "control.py", *sorted((BENCH / "metrics").glob("*.py"))]


def test_harness_imports_no_jax():
    files, outside = reached(HARNESS)
    assert BENCH / "harness" / "runner.py" in files and BENCH / "reference" / "slam.py" in files
    assert not outside & FORBIDDEN, outside & FORBIDDEN
    assert "boslam_torch" in outside  # the system under test, driven by harness/system.py


@pytest.mark.parametrize("entry", ["reference/slam.py", "harness/traffic.py",
                                   "harness/devtrace.py", "harness/check.py"])
def test_reference_and_yardstick_import_nothing_of_the_system(entry):
    _, outside = reached([BENCH / entry])
    assert not outside & (FORBIDDEN | {"boslam_torch"}), outside


def test_whole_names_are_compared():
    assert "boslam_torch".split(".")[0] not in FORBIDDEN
