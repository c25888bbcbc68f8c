"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  The test
package's conftest.py imports JAX, which the card's machine need not have,
so run them there without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import boslam_torch  # noqa: F401  (full-f32 matmul precision)

    return torch.device("cuda")


def _spd(n, rng, cond=1e4):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((Q * np.geomspace(1.0, cond, n)) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("n", [128, 384, 1024])
def test_cholesky_kernel_matches_plain(cuda, n):
    """Kernel error against f64 within 10x the plain version's + 1e-4
    (test_pallas_cholesky.py:91's bound)."""
    from boslam_torch.ops import cholesky as chol

    rng = np.random.default_rng(n)
    H = torch.from_numpy(_spd(n, rng)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    before = chol.cholesky_solve_padded.launches
    x_k = chol.cholesky_solve_padded(H, b)
    assert chol.cholesky_solve_padded.launches == before + 1
    x_p = chol.cholesky_solve_padded_plain(H, b)
    x64 = torch.linalg.solve(H.double(), b.double())
    err_k = (x_k.double() - x64).abs().max().item()
    err_p = (x_p.double() - x64).abs().max().item()
    assert err_k <= 10 * err_p + 1e-4


def test_cholesky_kernel_not_spd_gives_nan(cuda):
    from boslam_torch.ops import cholesky as chol

    H = torch.eye(256, device=cuda)
    H[100, 100] = -1.0
    x = chol.cholesky_solve_padded(H, torch.ones(256, device=cuda))
    assert torch.isnan(x).any()


def test_schur_kernel_matches_plain(cuda):
    from boslam_torch.ops import schur_solve as ss

    rng = np.random.default_rng(1)
    Np, Ml = 384, 256
    U = (0.1 * rng.standard_normal((Np, Ml))).astype(np.float32)
    blocks = np.stack([_spd(2, rng, cond=3.0) for _ in range(Ml // 2)])
    HllD = np.zeros((Ml, Ml), np.float32)
    for l in range(Ml // 2):
        HllD[2 * l:2 * l + 2, 2 * l:2 * l + 2] = blocks[l]
    Hpp = (_spd(Np, rng, cond=1e3) + U @ HllD @ U.T).astype(np.float32)
    bp, bl = rng.standard_normal(Np).astype(np.float32), rng.standard_normal(Ml).astype(np.float32)
    m = np.ones(Np, np.float32)
    m[3:6] = 0.0
    m[-20:] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in (Hpp, U, blocks, bp, bl, m)]
    before = ss.fused_schur_solve_blocks.launches
    x_k, dl_k = ss.fused_schur_solve_blocks(*args, 0.25)
    assert ss.fused_schur_solve_blocks.launches == before + 1
    x_p, dl_p = ss.fused_schur_solve_blocks_plain(*args, 0.25)
    torch.testing.assert_close(x_k, x_p, rtol=2e-3, atol=2e-5)
    torch.testing.assert_close(dl_k, dl_p, rtol=2e-3, atol=2e-5)
    assert bool((x_k[args[5] == 0] == 0).all())
    # the dense-HllD signature reads the same blocks, through the same kernel
    dense = list(args)
    dense[2] = torch.from_numpy(HllD).to(cuda)
    x_d, dl_d = ss.fused_schur_solve_padded(*dense, 0.25)
    assert torch.equal(x_d, x_k) and torch.equal(dl_d, dl_k)
