"""Block-banded preconditioner for the reduced camera system S (port of
``boslam/solver/bband.py``).

T = band_w(S): the exact blocks S[i, i+d] for |d| <= w, the bearing Schur
correction -B_i Hll^-1 B_j^T of pose pairs that co-observe a landmark
within the band included.  The JAX package measured it between
block-Jacobi and btridiag on chain graphs and never picks it by "auto";
it is opt-in (``preconditioner="bband"``) here too.

Assembly from the pose-packed slot grid: the band block at offset d is a
slot-match contraction between rows i and i+d,

    C_d[i] = sum_{k,m} [p_lm[i,k] == p_lm[i+d,m]] * W[i,k] @ Bp[i+d,m]^T,
    W[i,k] = Bp[i,k] @ Hll_inv[p_lm[i,k]],

through one [NP-d, K, K] equality mask per offset (padding slots carry
zero blocks, so their spurious matches add 0), plus the odometry
couplings at offset d.

Factorization: the w-banded matrix is block-tridiagonal over super-nodes
of q >= w consecutive poses ([3q, 3q] blocks); it is prescaled by the
Cholesky factors of the diagonal super-blocks, its scaled couplings are
clamped in spectral norm, and the cyclic reduction of ``btridiag.py`` runs
over the super-nodes with batched Cholesky, triangular solves and
inverses.  A diagonal super-block whose Cholesky fails falls back to the
square root of its diagonal, as in the JAX package; the failure is read on
the device (``cholesky_ex``'s flag or a NaN), never by the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from boslam_torch.solver.schur import _segment_sum


def _specnorm(B: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Batched spectral norm of [..., n, n] blocks by power iteration."""
    n = B.shape[-1]
    v = torch.full(B.shape[:-2] + (n,), 1.0 / n ** 0.5, dtype=B.dtype, device=B.device)
    for _ in range(iters):
        w = torch.einsum("...ij,...j->...i", B, v)
        v = torch.einsum("...ji,...j->...i", B, w)
        nv = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        v = v / torch.clamp(nv, min=1e-30)
    w = torch.einsum("...ij,...j->...i", B, v)
    return torch.sqrt(torch.sum(w * w, dim=-1))


def assemble_sband(blocks, pk, w: int, mask: torch.Tensor, compensate: bool = False, mesh=None):
    """(diag f32[NP,3,3], band f32[w,NP,3,3]) of the reduced system S.

    ``band[d-1, i] = S[i, i+d]`` for ``i < NP-d`` (zero rows past that).
    The fixed pose's diagonal block is pinned to the identity and its band
    entries zeroed, as in the masked CG matvec.

    ``compensate`` (measured worse than off in the JAX package, kept for
    the record): every dropped out-of-band correction block adds a
    Frobenius bound of its norm to both of its rows' diagonals, which makes
    T SPD by construction.

    Under a ``mesh`` the grids are the rank's slot columns, but the slot
    match of rows i and i+d is a product of per-slot sums, so partial
    products do not add up: W, Bp and p_lm are all-gathered along the slot
    axis (once per outer iteration; the same numbers as the JAX package's
    zero-padded psum), and the odometry partials are psums.
    """
    from boslam_torch.solver.schur_packed import _take, packed_s_diag

    NP_ = blocks.Hpp_diag.shape[0]
    p_lm = pk.p_lm
    Bp = blocks.Bp.float()  # bf16 storage is exact in f32
    Hinv_g = _take(blocks.Hll_inv, p_lm, pk.p_plan)  # [NP, K, 2, 2]
    W = torch.einsum("pkij,pkjl->pkil", Bp, Hinv_g)  # [NP, K, 3, 2]
    if mesh is not None:
        W, Bp, p_lm = (mesh.all_gather(x, dim=1) for x in (W, Bp, p_lm))

    diag = packed_s_diag(blocks, pk, mesh)
    eye3 = torch.eye(3, dtype=diag.dtype, device=diag.device)
    m1 = mask.reshape(-1)  # [NP] (the solver's mask is [NP, 1])
    diag = m1[:, None, None] * diag + (1.0 - m1[:, None, None]) * eye3

    o_src, o_dst, Ho = blocks.o_src, blocks.o_dst, blocks.Ho_sd
    if compensate:
        NL = blocks.Hll_inv.shape[0]
        nrmW = torch.sqrt(torch.sum(W * W, dim=(-2, -1)))  # [NP, K]
        nrmB = torch.sqrt(torch.sum(Bp * Bp, dim=(-2, -1)))  # [NP, K]
        totB = _segment_sum(nrmB.reshape(-1), p_lm.reshape(-1), NL)
        inband = nrmB.clone()  # running sum_{|i-j| <= w} ||B_jl||; self term j == i
    bands = []
    for d in range(1, w + 1):
        if d >= NP_:
            bands.append(Ho.new_zeros((NP_, 3, 3)))
            continue
        # bearing correction: -sum over co-observed landmarks
        match = (p_lm[: NP_ - d, :, None] == p_lm[d:, None, :]).to(W.dtype)  # [NP-d, K, K]
        tmp = torch.einsum("pkiv,pkm->pmiv", W[: NP_ - d], match)
        bd = -torch.einsum("pmiv,pmjv->pij", tmp, Bp[d:])
        if compensate:
            inband[: NP_ - d] += torch.einsum("pkm,pm->pk", match, nrmB[d:])
            inband[d:] += torch.einsum("pkm,pk->pm", match, nrmB[: NP_ - d])
        del match, tmp
        # odometry couplings at offset d; Ho_sd is the (src, dst) block, so
        # reversed edges add their transpose.  Edges at another offset add
        # zeros (their rows may lie past NP-d, hence the sums over NP rows)
        fwd = (o_dst - o_src == d)[:, None, None].to(Ho.dtype)
        rev = (o_src - o_dst == d)[:, None, None].to(Ho.dtype)
        ob = _segment_sum(Ho * fwd, o_src, NP_)[: NP_ - d]
        ob = ob + _segment_sum(Ho.transpose(1, 2) * rev, o_dst, NP_)[: NP_ - d]
        if mesh is not None:
            ob = mesh.psum(ob)
        bd = (bd + ob) * (m1[: NP_ - d, None, None] * m1[d:, None, None])
        bands.append(torch.cat([bd, bd.new_zeros((d, 3, 3))]))
    band = torch.stack(bands) if bands else Ho.new_zeros((0, NP_, 3, 3))
    if compensate:
        # dropped bearing-correction mass per row (Frobenius bound)
        dropped = torch.clamp(totB[p_lm] - inband, min=0.0)
        comp = torch.sum(nrmW * dropped, dim=1)  # [NP]
        # dropped (out-of-band) odometry couplings, e.g. loop closures
        far = (torch.abs(o_dst - o_src) > w).to(Ho.dtype)
        nrmO = torch.sqrt(torch.sum(Ho * Ho, dim=(-2, -1))) * far
        ocomp = _segment_sum(nrmO, o_src, NP_) + _segment_sum(nrmO, o_dst, NP_)
        if mesh is not None:
            ocomp = mesh.psum(ocomp)
        comp = (comp + ocomp) * m1
        diag = diag + comp[:, None, None] * eye3
    return diag, band


class BBFactor(NamedTuple):
    """Prescaled cyclic-reduction factorization over [3q, 3q] super-nodes.

    ``levels[k] = (alpha, gamma, Binv_e, Ae, Ce)``; ``Binv_last`` the
    1-block root; ``L`` the [G, 3q, 3q] block-Cholesky prescaling factors;
    ``n`` unpadded pose count, ``q`` poses per super-node."""

    levels: tuple
    Binv_last: torch.Tensor
    L: torch.Tensor
    n: int
    q: int


def _tri_solve(L, b, trans=False):
    """Solve L x = b (or L^T x = b) for lower-triangular batched L."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, b, upper=True)
    return torch.linalg.solve_triangular(L, b, upper=False)


def _inv(B: torch.Tensor) -> torch.Tensor:
    """Batched inverse without a host check (``inv_ex`` keeps its flag on
    the device; a singular block gives non-finite entries, as jnp.linalg.inv)."""
    return torch.linalg.inv_ex(B)[0]


@functools.lru_cache(maxsize=16)
def _grids(q: int, w: int, device: str):
    """Flat [3q*3q] index grids of the super-node assembly, built on the
    device once per (q, w): the diagonal blocks, and per offset d the
    intra-group upper blocks, their transposes and the cross-group blocks."""
    dev = torch.device(device)
    nb = 3 * q
    ii = torch.arange(9, device=dev) // 3  # row within a 3x3 block
    jj = torch.arange(9, device=dev) % 3  # column within it

    def flat(rows, cols):
        r = (3 * rows[:, None] + ii[None, :]).reshape(-1)
        c = (3 * cols[:, None] + jj[None, :]).reshape(-1)
        return r * nb + c, c * nb + r

    a = torch.arange(q, device=dev)
    diag = flat(a, a)[0]
    offsets = []
    for d in range(1, w + 1):
        a_in = torch.arange(q - d, device=dev)  # d <= w <= q
        intra, intra_t = flat(a_in, a_in + d)
        a_x = torch.arange(q - d, q, device=dev)
        cross = flat(a_x, a_x + d - q)[0]
        offsets.append((intra, intra_t, cross))
    return diag, tuple(offsets)


def bband_factor(diag: torch.Tensor, band: torch.Tensor, q: int,
                 clamp_band: "float | None" = 0.4999) -> BBFactor:
    """Factor T = the band-w block matrix (diag [N,3,3], band [w,N,3,3]).

    Requires q >= w so that every coupling is intra-group or between
    adjacent groups.  Super-node assembly is index_add_ over fixed index
    grids (each entry receives at most one value, so the order of the adds
    does not matter); the cyclic reduction runs log2(G) batched levels of
    [*, 3q, 3q] linear algebra.
    """
    w = band.shape[0]
    if q < max(w, 1):
        raise ValueError(f"band_group q={q} must be >= band width w={w}")
    N = diag.shape[0]
    dtype, dev = diag.dtype, diag.device
    G = -(-N // q)
    Npad = G * q
    if Npad > N:
        eye = torch.eye(3, dtype=dtype, device=dev).expand(Npad - N, 3, 3)
        diag = torch.cat([diag, eye])
        band = torch.cat([band, band.new_zeros((w, Npad - N, 3, 3))], dim=1)

    nb = 3 * q
    g_diag, g_off = _grids(q, w, str(dev))
    D = torch.zeros((G, nb * nb), dtype=dtype, device=dev)
    E = torch.zeros((G, nb * nb), dtype=dtype, device=dev)
    D.index_add_(1, g_diag, diag.reshape(G, -1))
    for d, (intra, intra_t, cross) in enumerate(g_off, start=1):
        bd = band[d - 1].reshape(G, q, 9)
        if intra.numel():
            vals = bd[:, : q - d].reshape(G, -1)
            D.index_add_(1, intra, vals)
            D.index_add_(1, intra_t, vals)  # the transpose below the diagonal
        # slots a in [q-d, q) couple to slot a+d-q of group g+1
        E.index_add_(1, cross, bd[:, q - d:].reshape(G, -1))
    D = D.reshape(G, nb, nb)
    E = E.reshape(G, nb, nb)
    # E[G-1] == 0: the last group's cross rows came from the zero band rows

    # --- prescale: T' = L^-1 T L^-T with L = chol(blockdiag(D)) ---
    Dd = torch.diagonal(D, dim1=-2, dim2=-1)
    dmax = torch.max(torch.abs(Dd), dim=-1).values
    eye = torch.eye(nb, dtype=dtype, device=dev)
    L, info = torch.linalg.cholesky_ex(D + (1e-6 * dmax)[:, None, None] * eye)
    # a group indefinite beyond the jitter falls back to sqrt(diag):
    # cholesky_ex leaves a partial factor there, so its flag marks it too
    bad = ((info != 0) | torch.isnan(L).any(dim=(-2, -1)))[:, None, None]
    dfloor = torch.sqrt(torch.maximum(Dd, 1e-12 * dmax[:, None]))
    L = torch.where(bad, torch.diag_embed(dfloor), L)

    # E'[g] = L_g^-1 E_g L_{g+1}^-T
    Y = _tri_solve(L, E)
    Lnext = torch.cat([L[1:], eye[None]])
    Ep = _tri_solve(Lnext, Y.transpose(1, 2)).transpose(1, 2)
    if clamp_band is not None:
        s = _specnorm(Ep)
        Ep = Ep * torch.clamp(clamp_band / torch.clamp(s, min=1e-30), max=1.0)[:, None, None]

    # --- cyclic reduction on tridiag(I, Ep) over G super-nodes ---
    M = 1 << max(0, (G - 1).bit_length())
    B = eye.expand(M, nb, nb)
    C = Ep[: G - 1] if G > 1 else Ep.new_zeros((0, nb, nb))
    if M - 1 > C.shape[0]:
        C = torch.cat([C, C.new_zeros((M - 1 - C.shape[0], nb, nb))])
    z1 = Ep.new_zeros((1, nb, nb))
    A = torch.cat([z1, C.transpose(1, 2)])
    Cf = torch.cat([C, z1])

    levels = []
    first = True
    while M > 1:
        Be, Bo = B[0::2], B[1::2]
        Ae, Ce = A[0::2], Cf[0::2]
        Ao, Co = A[1::2], Cf[1::2]
        # level 0: the prescaled diagonal is exactly I, no inversion
        Binv_e = Be if first else _inv(Be)
        first = False
        Binv_next = torch.cat([Binv_e[1:], z1])
        Ae_next = torch.cat([Ae[1:], z1])
        Ce_next = torch.cat([Ce[1:], z1])
        alpha = Ao @ Binv_e
        gamma = Co @ Binv_next
        B = Bo - alpha @ Ce - gamma @ Ae_next
        A = -(alpha @ Ae)
        Cf = -(gamma @ Ce_next)
        levels.append((alpha, gamma, Binv_e, Ae, Ce))
        M //= 2

    return BBFactor(tuple(levels), _inv(B), L, N, q)


def _bmv(a, v):
    return torch.einsum("...ij,...j->...i", a, v)


def bband_solve(factor: BBFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Apply T^-1: rhs f32[N, 3] -> x f32[N, 3]."""
    N, q = factor.n, factor.q
    nb = 3 * q
    G = factor.L.shape[0]
    r = torch.cat([rhs.reshape(-1), rhs.new_zeros((G * nb - 3 * N,))]).reshape(G, nb, 1)
    f = _tri_solve(factor.L, r)[..., 0]  # r' = L^-1 r, [G, nb]

    M = 1 << max(0, (G - 1).bit_length())
    if M > G:
        f = torch.cat([f, f.new_zeros((M - G, nb))])
    z1 = f.new_zeros((1, nb))
    f_evens = []
    for alpha, gamma, _Binv_e, _Ae, _Ce in factor.levels:
        fe, fo = f[0::2], f[1::2]
        fe_next = torch.cat([fe[1:], z1])
        f_evens.append(fe)
        f = fo - _bmv(alpha, fe) - _bmv(gamma, fe_next)

    x = _bmv(factor.Binv_last, f)
    for (_alpha, _gamma, Binv_e, Ae, Ce), fe in zip(reversed(factor.levels), reversed(f_evens)):
        x_prev = torch.cat([z1, x[:-1]])
        x_even = _bmv(Binv_e, fe - _bmv(Ae, x_prev) - _bmv(Ce, x))
        x = torch.stack([x_even, x], dim=1).reshape(-1, nb)

    x = _tri_solve(factor.L, x[:G, :, None], trans=True)[..., 0]  # L^-T x'
    return x.reshape(-1)[: 3 * N].reshape(N, 3)


def bband_dense(diag: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """Materialize the banded T as dense [3N, 3N] (tests only)."""
    N = diag.shape[0]
    w = band.shape[0]
    T = diag.new_zeros((3 * N, 3 * N))
    for i in range(N):
        T[3 * i:3 * i + 3, 3 * i:3 * i + 3] += diag[i]
    for d in range(1, w + 1):
        for i in range(N - d):
            T[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3] += band[d - 1, i]
            T[3 * (i + d):3 * (i + d) + 3, 3 * i:3 * i + 3] += band[d - 1, i].T
    return T
