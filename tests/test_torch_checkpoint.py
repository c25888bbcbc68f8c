"""Checkpoint and resume (``io/checkpoint.py``, ``solve --save/--resume``)
on the CPU: a round trip, files written by either package loading in the
other, a checkpoint of another problem refused, and resumed runs equal to
uninterrupted ones to the bit.
"""

import numpy as np
import pytest
import torch

from boslam.graph.build import build_graph as build_graph_jax
from boslam.io import checkpoint as ck_jax
from boslam_torch.cli import main
from boslam_torch.graph.build import build_graph
from boslam_torch.io import checkpoint as ck
from boslam_torch.synth import generate_sequence


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _problem(n=40, seed=0, **kw):
    ig, _ = generate_sequence(n, n // 2, seed=seed, **kw)
    g, meta = build_graph(ig, init="triangulate", device="cpu")
    return ig, g, meta


def test_roundtrip(tmp_path):
    _, g, meta = _problem()
    p = str(tmp_path / "ck.npz")
    blank = g.with_state(torch.zeros_like(g.poses), torch.zeros_like(g.landmarks))
    ck.save_npz(p, g, meta, iteration=7, lm_lambda=0.5)
    g2, meta2, it, lam, dp = ck.load_npz(p, blank, meta)
    assert (it, lam, dp, meta2) == (7, 0.5, None, meta)
    assert torch.equal(g2.poses, g.poses) and torch.equal(g2.landmarks, g.landmarks)
    dp_in = np.arange(g.n_poses * 3, dtype=np.float32).reshape(-1, 3)
    ck.save_npz(p, g, meta, iteration=9, dp=torch.from_numpy(dp_in))
    _, _, it, lam, dp = ck.load_npz(p, blank, meta)
    assert it == 9 and lam is None
    np.testing.assert_array_equal(dp, dp_in)


def test_files_load_across_packages(tmp_path):
    """Same keys and dtypes from both writers; each package loads the
    other's file to the bit."""
    ig, g, meta = _problem(seed=1)
    gj, meta_j = build_graph_jax(ig, init="triangulate")
    assert (meta_j.pose_ids, meta_j.lm_ids) == (meta.pose_ids, meta.lm_ids)
    rng = np.random.default_rng(0)
    poses = rng.standard_normal((g.n_poses, 3)).astype(np.float32)
    lms = rng.standard_normal((g.n_landmarks, 2)).astype(np.float32)
    dp = rng.standard_normal((g.n_poses, 3)).astype(np.float32)
    p_t, p_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ck.save_npz(p_t, g.with_state(torch.from_numpy(poses), torch.from_numpy(lms)), meta,
                iteration=5, lm_lambda=0.25, dp=dp)
    import jax.numpy as jnp

    ck_jax.save_npz(p_j, gj.with_state(jnp.asarray(poses), jnp.asarray(lms)), meta_j,
                    iteration=5, lm_lambda=0.25, dp=dp)
    z_t, z_j = np.load(p_t), np.load(p_j)
    assert sorted(z_t.files) == sorted(z_j.files)
    for k in z_j.files:
        assert z_t[k].dtype == z_j[k].dtype, k
        np.testing.assert_array_equal(z_t[k], z_j[k], err_msg=k)
    g2, _, it, lam, dp2 = ck.load_npz(p_j, g, meta)
    np.testing.assert_array_equal(g2.poses.numpy(), poses)
    np.testing.assert_array_equal(g2.landmarks.numpy(), lms)
    assert (it, lam) == (5, 0.25)
    np.testing.assert_array_equal(dp2, dp)
    gj2, _, it_j, lam_j, dp_j = ck_jax.load_npz(p_t, gj, meta_j)
    np.testing.assert_array_equal(np.asarray(gj2.poses), poses)
    np.testing.assert_array_equal(np.asarray(gj2.landmarks), lms)
    assert (it_j, lam_j) == (5, 0.25)
    np.testing.assert_array_equal(dp_j, dp)


def test_other_problem_refused(tmp_path, capsys):
    """load_npz raises the JAX package's ValueError; the CLI returns 2."""
    _, g, meta = _problem(seed=2)
    _, g_o, meta_o = _problem(n=44, seed=2)
    p = str(tmp_path / "other.npz")
    ck.save_npz(p, g_o, meta_o)
    with pytest.raises(ValueError, match="belongs to a different problem") as exc:
        ck.load_npz(p, g, meta)
    gj, meta_j = build_graph_jax(generate_sequence(40, 20, seed=2)[0], init="triangulate")
    with pytest.raises(ValueError) as exc_j:
        ck_jax.load_npz(p, gj, meta_j)
    assert str(exc.value) == str(exc_j.value)
    from boslam_torch.io.g2o import write_g2o

    ds = str(tmp_path / "s.g2o")
    ig, _ = generate_sequence(40, 20, seed=2)
    write_g2o(ds, ig.pose_ids, ig.pose_xyt, ig.lm_ids, ig.lm_xy, parsed=ig,
              fixed_pose_id=ig.fixed_pose_id)
    capsys.readouterr()
    assert main(["solve", ds, "--iters", "2", "--resume", p, "--device", "cpu"]) == 2
    assert "error: checkpoint" in capsys.readouterr().err


def _dataset(tmp_path, **kw):
    ds = str(tmp_path / "s.g2o")
    assert main(["synth", "--poses", "120", "--landmarks", "50", "--seed", "3", "--out", ds,
                 *[str(a) for kv in kw.items() for a in kv]]) == 0
    return ds


@pytest.mark.parametrize("extra", [
    ["--linear-solver", "schur"],
    ["--linear-solver", "schur", "--optimizer", "lm"],
    ["--packed", "--linear-solver", "schur_cg", "--optimizer", "lm", "--cg-warm-start",
     "--cg-iters", "30", "--preconditioner", "two_level"],
    ["--packed", "--linear-solver", "schur_cg", "--gnc-kt0", "50", "--gnc-iters", "6",
     "--cg-warm-start", "--cg-iters", "30"],
], ids=["gn-schur", "lm-schur", "packed-lm-warm-two-level", "packed-gnc-warm"])
def test_resume_matches_uninterrupted(tmp_path, capsys, extra):
    """solve 10 == solve 5, --save, --resume to 10: every array of the two
    final checkpoints equal to the bit (state, iteration, the next LM
    trial's damping, the warm-start delta; GNC resumes its schedule)."""
    ds = _dataset(tmp_path, **{"--loop-closures": 2})
    common = ["--device", "cpu", *extra]
    full, half, res = (str(tmp_path / f"{k}.npz") for k in ("full", "half", "res"))
    assert main(["solve", ds, "--iters", "10", "--save", full, *common]) == 0
    assert main(["solve", ds, "--iters", "5", "--save", half, *common]) == 0
    capsys.readouterr()
    assert main(["solve", ds, "--iters", "10", "--resume", half, "--save", res, *common]) == 0
    err = capsys.readouterr().err
    assert "resumed from" in err and "5 iterations remain" in err
    z_full, z_res = np.load(full), np.load(res)
    assert int(z_res["iteration"]) == 10
    for k in z_full.files:
        np.testing.assert_array_equal(z_res[k], z_full[k], err_msg=k)
    if "--optimizer" in extra:
        assert float(z_full["lm_lambda"]) > 0 and "lm lambda" in err
    if "--packed" in extra:
        assert z_full["dp"].shape[0] > 0


def test_resume_nothing_to_do(tmp_path, capsys):
    ds = _dataset(tmp_path)
    ck_path = str(tmp_path / "c.npz")
    assert main(["solve", ds, "--iters", "3", "--save", ck_path, "--device", "cpu",
                 "--linear-solver", "schur"]) == 0
    capsys.readouterr()
    assert main(["solve", ds, "--iters", "3", "--resume", ck_path, "--device", "cpu",
                 "--linear-solver", "schur"]) == 0
    assert "nothing to do" in capsys.readouterr().err
