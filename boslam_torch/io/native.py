"""ctypes binding to the port's native C++ g2o tokenizer (``csrc/g2o_reader.cpp``;
port of ``boslam/io/native.py``).

The Python parser (``io/g2o.py``) is the behavioral reference; the native
one is a host-side fast path for large graphs.  The library is compiled
with ``g++ -O2 -fPIC -shared -std=c++14`` at first use into
``build/boslam_torch_native/`` at the root of the checkout, named by a hash
of the flags and the source, so an edited source is rebuilt and an
unchanged one reused.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "g2o_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "boslam_torch_native"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++14"]


class _G2OArrays(ctypes.Structure):
    _fields_ = [
        ("n_poses", ctypes.c_int64),
        ("n_landmarks", ctypes.c_int64),
        ("n_bearing", ctypes.c_int64),
        ("n_odom", ctypes.c_int64),
        ("pose_ids", ctypes.POINTER(ctypes.c_int64)),
        ("pose_xyt", ctypes.POINTER(ctypes.c_float)),
        ("lm_ids", ctypes.POINTER(ctypes.c_int64)),
        ("lm_xy", ctypes.POINTER(ctypes.c_float)),
        ("b_pose_id", ctypes.POINTER(ctypes.c_int64)),
        ("b_lm_id", ctypes.POINTER(ctypes.c_int64)),
        ("b_meas", ctypes.POINTER(ctypes.c_float)),
        ("o_src_id", ctypes.POINTER(ctypes.c_int64)),
        ("o_dst_id", ctypes.POINTER(ctypes.c_int64)),
        ("o_meas", ctypes.POINTER(ctypes.c_float)),
        ("o_omega", ctypes.POINTER(ctypes.c_float)),
        ("fixed_pose_id", ctypes.c_int64),
        ("bound", ctypes.c_float),
        ("n_unknown", ctypes.c_int64),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libboslam_torch_io-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the tokenizer unless it is built already; raises RuntimeError
    when no C++ compiler is found or the compile fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (g++ or $CXX) for the native g2o parser")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.so")
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"cannot run {cxx} for the native g2o parser: {exc}") from exc
    if out.returncode != 0:
        raise RuntimeError(f"building the native g2o parser failed:\n{out.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the tokenizer."""
    lib = ctypes.CDLL(str(build()))
    lib.boslam_parse_g2o.argtypes = [ctypes.c_char_p]
    lib.boslam_parse_g2o.restype = ctypes.POINTER(_G2OArrays)
    lib.boslam_free_g2o.argtypes = [ctypes.POINTER(_G2OArrays)]
    lib.boslam_free_g2o.restype = None
    return lib


def _copy(ptr, count, dtype):
    if count == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def parse_g2o_native(path: str):
    """Parse with the native tokenizer: a ``ParsedG2O`` equal to the Python
    parser's.  Raises if the library cannot be built or the file read."""
    from boslam_torch.io.g2o import ParsedG2O, log

    lib = load_library()
    res = lib.boslam_parse_g2o(os.fsencode(path))
    if not res:
        raise IOError(f"native g2o parser failed on {path}")
    try:
        r = res.contents
        np_, nl, nb, no = int(r.n_poses), int(r.n_landmarks), int(r.n_bearing), int(r.n_odom)
        if r.n_unknown:
            log.warning("%d unrecognized records in %s", int(r.n_unknown), path)
        return ParsedG2O(
            pose_ids=[int(i) for i in _copy(r.pose_ids, np_, np.int64)],
            pose_xyt=_copy(r.pose_xyt, 3 * np_, np.float32).reshape(np_, 3),
            lm_ids=[int(i) for i in _copy(r.lm_ids, nl, np.int64)],
            lm_xy=_copy(r.lm_xy, 2 * nl, np.float32).reshape(nl, 2),
            bearing_pose_id=_copy(r.b_pose_id, nb, np.int64),
            bearing_lm_id=_copy(r.b_lm_id, nb, np.int64),
            bearing_meas=_copy(r.b_meas, nb, np.float32),
            bearing_omega=np.ones(nb, dtype=np.float32),
            odom_src_id=_copy(r.o_src_id, no, np.int64),
            odom_dst_id=_copy(r.o_dst_id, no, np.int64),
            odom_meas=_copy(r.o_meas, 3 * no, np.float32).reshape(no, 3),
            odom_omega=_copy(r.o_omega, 9 * no, np.float32).reshape(no, 3, 3),
            fixed_pose_id=int(r.fixed_pose_id),
            bound=float(r.bound),
        )
    finally:
        lib.boslam_free_g2o(res)
