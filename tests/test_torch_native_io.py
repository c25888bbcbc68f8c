"""The port's native g2o tokenizer (``io/native.py`` over
``io/csrc/g2o_reader.cpp``) against its Python parser and the JAX
package's, on the CPU: the same arrays, to the bit, on a synthetic file and
on unknown and empty lines (test_native_io.py:58-80); the ``parse_g2o``
switch; the library is built under ``build/`` only."""

import hashlib
import logging
import os

import numpy as np
import pytest

from boslam_torch.io import native
from boslam_torch.io.g2o import parse_g2o, write_g2o

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED_LIB = os.path.join(REPO_ROOT, "native", "libboslam_io.so")


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _compare(a, b):
    assert a.pose_ids == b.pose_ids
    assert a.lm_ids == b.lm_ids
    assert a.fixed_pose_id == b.fixed_pose_id
    assert abs(a.bound - b.bound) < 1e-4
    for name in ("pose_xyt", "lm_xy", "bearing_pose_id", "bearing_lm_id", "bearing_meas",
                 "bearing_omega", "odom_src_id", "odom_dst_id", "odom_meas", "odom_omega"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    from boslam_torch.synth import generate_sequence

    _, gt = generate_sequence(200, 80, seed=5, loop_closures=3)
    p = str(tmp_path_factory.mktemp("native") / "synth.g2o")
    write_g2o(p, gt.pose_ids, gt.pose_xyt, gt.lm_ids, gt.lm_xy, parsed=gt,
              fixed_pose_id=gt.fixed_pose_id)
    return p


def test_native_matches_python_on_synthetic(synthetic):
    from boslam.io.g2o import parse_g2o as parse_g2o_jax

    before = _sha(TRACKED_LIB)
    b = native.parse_g2o_native(synthetic)
    _compare(parse_g2o(synthetic, use_native=False), b)
    _compare(parse_g2o_jax(synthetic, use_native=False), b)
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert os.path.commonpath([str(lib), os.path.join(REPO_ROOT, "build")]) == os.path.join(
        REPO_ROOT, "build")
    assert _sha(TRACKED_LIB) == before  # the JAX package's library is not rebuilt


def test_native_handles_unknown_and_empty(tmp_path):
    p = tmp_path / "odd.g2o"
    p.write_text("\nBOGUS 1 2\nVERTEX_SE2 3 1 2 0.5\n\nFIX 3\n")
    b = native.parse_g2o_native(str(p))
    assert b.pose_ids == [3]
    assert b.fixed_pose_id == 3
    _compare(parse_g2o(str(p), use_native=False), b)
    e = tmp_path / "empty.g2o"
    e.write_text("")
    _compare(parse_g2o(str(e), use_native=False), native.parse_g2o_native(str(e)))


def test_parse_g2o_switch(synthetic, monkeypatch, caplog):
    caplog.set_level(logging.INFO, logger="boslam_torch.io")
    monkeypatch.delenv("BOSLAM_NATIVE_IO", raising=False)
    for use_native, env, which in ((None, None, "native"), (True, None, "native"),
                                   (False, None, "python"), (None, "0", "python")):
        if env is not None:
            monkeypatch.setenv("BOSLAM_NATIVE_IO", env)
        caplog.clear()
        parse_g2o(synthetic, use_native=use_native)
        assert f"with the {which} parser" in caplog.text, (use_native, env)


def test_unbuildable_native_falls_back_or_raises(synthetic, monkeypatch, tmp_path, caplog):
    """Without a working compiler: None falls back to Python (logged), True
    raises."""
    caplog.set_level(logging.INFO, logger="boslam_torch.io")
    monkeypatch.delenv("BOSLAM_NATIVE_IO", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nobuild")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    native.load_library.cache_clear()
    try:
        _compare(parse_g2o(synthetic), parse_g2o(synthetic, use_native=False))
        assert "native g2o parser unavailable" in caplog.text
        with pytest.raises(RuntimeError, match="native g2o parser"):
            parse_g2o(synthetic, use_native=True)
    finally:
        native.load_library.cache_clear()
