"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
libraries go to ``build/boslam_torch_kernels/`` at the root of the
checkout, named by a hash of the flags, the ``.cu`` file and every
``csrc`` header it includes, so an edited source or header is rebuilt and
an unchanged one is reused.  Nothing is built at import: the first launch
(or ``build()``) compiles, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "boslam_torch_kernels"
KERNELS = ("cholesky", "schur_solve", "gn_step", "windowed_gather")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def sources(name: str) -> list:
    """``<name>.cu`` and every ``csrc`` header it includes, directly or not."""
    order, todo = [], [f"{name}.cu"]
    while todo:
        src = todo.pop(0)
        if src in order:
            continue
        order.append(src)
        todo.extend(_INCLUDE.findall((CSRC / src).read_text()))
    return order


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(name):
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library in ``names`` that is not built yet, in parallel.

    Returns {name: {"path", "seconds", "ptxas"}}; ``seconds`` is 0.0 and
    ``ptxas`` empty for a library that was already built.  Raises with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        lib = library_path(name)
        out[name] = {"path": str(lib), "seconds": 0.0, "ptxas": ""}
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["ptxas"] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``; declares the error helper."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    lib.boslam_error_string.argtypes = [ctypes.c_int]
    lib.boslam_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.boslam_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
