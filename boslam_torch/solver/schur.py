"""Per-landmark Schur complement (port of ``boslam/solver/schur.py``).

Landmark blocks of H are 2x2 and block-diagonal, so eliminating them is a
batched closed-form 2x2 inverse.  The reduced pose system
S = Hpp - Hpl Hll^-1 Hlp (3*NP square) is solved

- exactly (``linear_solver="schur"``) by Cholesky: on a CUDA tensor within
  ``fused_fits`` by the hand-written Schur kernel (``ops/schur_solve.py``),
  otherwise by materializing S and the masked solve of the dense path;
- or matrix-free (``"schur_cg"``) by preconditioned CG (``pcg``), where S
  is only applied (``s_matvec``: gathers, small batched products and
  segment sums) and the preconditioner is block-Jacobi, the
  block-tridiagonal chain solve (``solver/btridiag.py``) or the two-level
  chain scheme (``solver/two_level.py``).

``pcg`` is also the inner solver of the packed path (``schur_packed.py``).

Under edge sharding (``mesh``, ``parallel/mesh.py``; None is one device)
the state and the reduced system are replicated and the edge arrays are
the rank's shard: the per-vertex sums are completed by ``psum`` before
damping and inversion, and each CG matvec takes two psums.  The Schur
kernel is not used under a mesh (the JAX package's gate); the exact path
materializes S and solves it on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_torch.config import SolverConfig
from boslam_torch.device import host_sync
from boslam_torch.graph.data import FactorGraph
from boslam_torch.ops import counters
from boslam_torch.solver.normal_eq import EdgeTerms, edge_terms
from boslam_torch.utils.spans import count, span

CG_POLL_EVERY = 4  # CG iterations between two host reads of the "still running" flag
# The least CG cap whose loop runs as a CUDA graph: a capture costs its host
# about 2 ms more than the eager body it stands for, a replay about 1.5 ms
# less (an H100 at 10k poses, tools/port_cg_graph_probe.py), so a loop of 2
# bodies loses by the capture, 3 ties and 4 wins; once entered, the loop
# runs min(cap, poll interval) bodies at least
CG_GRAPH_MIN_ITERS = 4


class SchurBlocks(NamedTuple):
    """Block-sparse damped normal equations."""

    Hpp_diag: torch.Tensor  # f32[NP, 3, 3] per-pose diagonal blocks
    Ho_sd: torch.Tensor  # f32[NO, 3, 3] odometry src->dst coupling blocks
    Hll_inv: torch.Tensor  # f32[NL, 2, 2] inverse damped landmark blocks
    Hpl: torch.Tensor  # f32[NB, 3, 2] per-bearing-edge pose-landmark blocks
    bp: torch.Tensor  # f32[NP, 3]
    bl: torch.Tensor  # f32[NL, 2]


def _inv2x2(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 inverse."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack(
        [
            torch.stack([d * inv_det, -b * inv_det], dim=-1),
            torch.stack([-c * inv_det, a * inv_det], dim=-1),
        ],
        dim=-2,
    )


def _segment_sum(v: torch.Tensor, ix: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    return out.index_add_(0, ix, v)


def build_blocks(g: FactorGraph, cfg: SolverConfig, damping, terms: EdgeTerms | None = None,
                 mesh=None):
    """Assemble the block-sparse damped H and b by segment sums; under a
    ``mesh`` the per-vertex sums are completed before damping."""
    if terms is None:
        terms = edge_terms(g, cfg)
    NP_, NL = g.n_poses, g.n_landmarks
    dtype, dev = g.poses.dtype, g.device

    wH_b = (g.b_omega * terms.bw_H)[:, None, None]
    jp, jl = terms.bjp, terms.bjl
    NB, NO = jp.shape[0], terms.ojs.shape[0]
    Hpp_b = wH_b * jp[:, :, None] * jp[:, None, :]
    Hll_b = wH_b * jl[:, :, None] * jl[:, None, :]
    Hpl = wH_b * jp[:, :, None] * jl[:, None, :]
    coef_b = (g.b_omega * terms.bw_b * terms.be)[:, None]
    bp_b = coef_b * jp
    bl_b = coef_b * jl

    lm_sums = _segment_sum(torch.cat([Hll_b.reshape(NB, 4), bl_b], dim=1), g.b_lm, NL)
    Hll = lm_sums[:, :4].reshape(NL, 2, 2)
    bl = lm_sums[:, 4:6]

    js, jd = terms.ojs, terms.ojd
    Om = g.o_omega * terms.ow_H[:, None, None]
    OmJs = torch.einsum("eij,ejk->eik", Om, js)
    OmJd = torch.einsum("eij,ejk->eik", Om, jd)
    H_ss = torch.einsum("eij,eik->ejk", js, OmJs)
    H_dd = torch.einsum("eij,eik->ejk", jd, OmJd)
    H_sd = torch.einsum("eij,eik->ejk", js, OmJd)
    e_w = (g.o_omega @ (terms.ow_b[:, None] * terms.oe)[..., None])[..., 0]
    bp_s = torch.einsum("eij,ei->ej", js, e_w)
    bp_d = torch.einsum("eij,ei->ej", jd, e_w)

    pose_idx = torch.cat([g.b_pose, g.o_src, g.o_dst])
    pose_payload = torch.cat(
        [
            torch.cat([Hpp_b.reshape(NB, 9), bp_b], dim=1),
            torch.cat([H_ss.reshape(NO, 9), bp_s], dim=1),
            torch.cat([H_dd.reshape(NO, 9), bp_d], dim=1),
        ],
        dim=0,
    )
    pose_sums = _segment_sum(pose_payload, pose_idx, NP_)
    Hpp_diag = pose_sums[:, :9].reshape(NP_, 3, 3)
    bp = pose_sums[:, 9:12]
    if mesh is not None:
        Hpp_diag, Hll, bp, bl = mesh.psum(Hpp_diag, Hll, bp, bl)

    # damping: a float or a device tensor (LM), never copied to the card
    Hpp_diag = Hpp_diag + damping * torch.eye(3, dtype=dtype, device=dev)
    Hll = Hll + damping * torch.eye(2, dtype=dtype, device=dev)
    return SchurBlocks(Hpp_diag, H_sd, _inv2x2(Hll), Hpl, bp, bl), terms


def _pose_mask(NP_: int, fixed_ix: torch.Tensor, dtype) -> torch.Tensor:
    """f32[NP, 1] gauge mask over pose blocks (1 except the fixed pose)."""
    return (torch.arange(NP_, device=fixed_ix.device) != fixed_ix).to(dtype)[:, None]


def s_matvec(blocks: SchurBlocks, g: FactorGraph, x: torch.Tensor, mask: torch.Tensor,
             mesh=None):
    """y = S_masked @ x with S = Hpp - Hpl Hll^-1 Hlp, x f32[NP, 3].

    The gauge mask zeroes the fixed pose's rows and columns and pins its
    diagonal to the identity, as the dense path masks.  Under a ``mesh``
    the edge-coupled partials are completed by two psums: (y_edge, z) in
    one call, then the back-coupling.
    """
    NP_, NL, NO = g.n_poses, g.n_landmarks, g.n_odometry
    xm = x * mask
    # odometry couplings (sd and its transpose): one gather, one segment sum
    x_ends = xm[torch.cat([g.o_dst, g.o_src])]
    y_sd = torch.einsum("eij,ej->ei", blocks.Ho_sd, x_ends[:NO])
    y_ds = torch.einsum("eji,ej->ei", blocks.Ho_sd, x_ends[NO:])
    y_edge = _segment_sum(torch.cat([y_sd, y_ds]), torch.cat([g.o_src, g.o_dst]), NP_)
    # Hlp x into landmark space, Hll^-1, then back through Hpl
    z = torch.einsum("eji,ej->ei", blocks.Hpl, xm[g.b_pose])
    z = _segment_sum(z, g.b_lm, NL)
    if mesh is not None:
        y_edge, z = mesh.psum(y_edge, z)
    y = torch.einsum("pij,pj->pi", blocks.Hpp_diag, xm) + y_edge
    w = torch.einsum("lij,lj->li", blocks.Hll_inv, z)
    yb = _segment_sum(torch.einsum("eij,ej->ei", blocks.Hpl, w[g.b_lm]), g.b_pose, NP_)
    if mesh is not None:
        yb = mesh.psum(yb)
    y = y - yb
    # identity on the fixed block keeps CG well-posed there
    return y * mask + x * (1.0 - mask)


def s_diag_blocks(blocks: SchurBlocks, g: FactorGraph, mesh=None) -> torch.Tensor:
    """Exact 3x3 diagonal of S for the block-Jacobi preconditioner:
    Hpp_ii - sum_e Hpl_e Hll_inv[lm_e] Hpl_e^T over the edges at pose i."""
    corr = torch.einsum("eij,ejk,elk->eil", blocks.Hpl, blocks.Hll_inv[g.b_lm], blocks.Hpl)
    corr = _segment_sum(corr, g.b_pose, g.n_poses)
    if mesh is not None:
        corr = mesh.psum(corr)
    return blocks.Hpp_diag - corr


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse via the adjugate."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    inv_det = (1.0 / det)[..., None, None]
    adj = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det


def poll(flag: torch.Tensor, mesh=None) -> bool:
    """Read a device flag on the host: the CG loop's one wait for the card.
    Under a ``mesh`` the flag is first the maximum over the ranks, so that
    every rank takes the same branch (a rank that left the loop while
    another entered a collective would hang the group)."""
    with span("poll"):
        if mesh is not None:
            flag = mesh.pmax(flag)
        with host_sync(flag.device):
            return bool(flag.item())


class CGState(NamedTuple):
    """The state one CG body reads and writes: the iterate, residual,
    preconditioned residual and direction f32[NP, 3], r^T z and r^T r, the
    breakdown events and iterations so far, the best-residual iterate and
    its r^T r, and ``active``, the loop condition as a device flag."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor
    nbrk: torch.Tensor
    k: torch.Tensor
    x_best: torch.Tensor
    rr_best: torch.Tensor
    active: torch.Tensor


# per device: the side stream the CG body is captured on, and the last
# graph captured there, whose memory pool the next capture shares (so the
# captures of successive solves reuse one pool rather than each reserving
# its own; a pool lives while a graph that uses it does)
_CAPTURE = {}


class _GraphedBody:
    """One CG body as a CUDA graph over fixed state buffers, which it reads
    and writes in place (``out=``), so a replay needs no copy: captured at
    the first call, from that call's state, and replayed at each call.  A
    replay adds to the kernels' launch counters what an eager body adds;
    the capture, which launched nothing, adds nothing."""

    def __init__(self, body):
        self.body = body
        self.graph = self.state = self.launches = None

    def __call__(self, s: CGState) -> CGState:
        if self.graph is None:
            self._capture(s)
        self.graph.replay()
        counters.add(self.launches)
        return self.state

    def _capture(self, s: CGState) -> None:
        dev = s.x.device
        stream, last = _CAPTURE.get(dev.index) or (torch.cuda.Stream(dev), None)
        self.state = CGState(*(t.clone() for t in s))
        self.graph = torch.cuda.CUDAGraph()
        before = counters.read()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=None if last is None else last.pool(),
                                     capture_error_mode="thread_local")
            try:
                self.body(self.state, out=self.state)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        _CAPTURE[dev.index] = (stream, self.graph)
        self.launches = [a - b for a, b in zip(counters.read(), before)]
        counters.add([-n for n in self.launches])


def cg_step(s: CGState, Ap: torch.Tensor, apply_m, dot, cond,
            out: CGState | None = None) -> CGState:
    """One CG iteration from ``s`` and its ``Ap`` = A p: ``pcg``'s body past
    the matvec, with ``apply_m`` r -> M^-1 r, ``dot`` and the loop condition
    ``cond(k, nbrk, rr)``.  Committed where ``s.active`` holds and frozen
    elsewhere; written into ``out``'s tensors when given."""
    tiny = torch.finfo(Ap.dtype).tiny
    pAp = dot(s.p, Ap)
    curv_ok = pAp > 0
    alpha = torch.where(curv_ok, s.rz, 0.0) / torch.where(curv_ok, pAp, 1.0)
    x_n = s.x + alpha * s.p
    r_n = s.r - alpha * Ap
    # the best-residual iterate: after a breakdown the last can be far worse
    rr_n = dot(r_n, r_n)
    better = rr_n < s.rr_best
    x_best_n = torch.where(better, x_n, s.x_best)
    rr_best_n = torch.where(better, rr_n, s.rr_best)
    z_n = apply_m(r_n)
    rz_new = dot(r_n, z_n)
    rz_ok = rz_new > 0
    healthy = curv_ok & rz_ok
    # healthy: conjugate update; curvature event: restart p = z;
    # indefinite preconditioner: restart p = r
    beta = torch.where(healthy, rz_new, 0.0) / torch.clamp(s.rz, min=tiny)
    z_eff = torch.where(rz_ok, z_n, r_n)
    rz_eff = torch.where(rz_ok, rz_new, rr_n)
    p_n = z_eff + beta * s.p
    nbrk_n = s.nbrk + (~healthy).to(torch.int32)
    # commit the body where the loop was still running, freeze it elsewhere
    new = (x_n, r_n, z_eff, p_n, rz_eff, rr_n, nbrk_n, s.k + 1, x_best_n, rr_best_n)
    if out is None:
        t = [torch.where(s.active, n, o) for n, o in zip(new, s)]
        t.append(s.active & cond(t[7], t[6], t[5]))
    else:
        t = [torch.where(s.active, n, o, out=w) for n, o, w in zip(new, s, out)]
        t.append(torch.bitwise_and(s.active, cond(t[7], t[6], t[5]), out=out.active))
    return CGState(*t)


def cg_cond(b2, tol2: float, restarts: int, max_iters: int):
    """``pcg``'s loop condition (k, nbrk, rr) -> still running."""
    return lambda k, nbrk, rr: (nbrk <= restarts) & (k < max_iters) & (rr / b2 > tol2)


def pcg(matvec, rhs, precond, max_iters: int, tol: float, x0=None, restarts: int = 0,
        poll_every: int = CG_POLL_EVERY, mesh=None, split: bool = False, make_body=None,
        _eager: bool = False):
    """Preconditioned conjugate gradients over pose-block arrays f32[NP, 3].

    ``precond`` is a batched 3x3 block-inverse array (block-Jacobi) or a
    callable r -> M^-1 r.  ``x0`` warm-starts (default zeros).  Returns
    (x, n_iters, final rel. residual^2, breakdown, info): the first four as
    the JAX package's ``pcg`` returns them, as device tensors; ``info`` the
    host counts {"matvecs", "polls", "graph_bodies", "captures",
    "fused_bodies"} of this call and "events", the number of breakdown
    events (restarts, and the one that stopped the loop), a device tensor.

    Breakdown handling is the JAX package's: a non-positive curvature
    (p^T A p <= 0) or indefinite preconditioner apply (r^T z <= 0) restarts
    the Krylov space, up to ``restarts`` events, after which the iteration
    stops; after any event the best-residual iterate is returned, else the
    last one.  An indefinite first apply restarts from r0.

    The JAX package runs the loop as a ``while_loop`` on the device.  Here
    a Python loop runs the body with the state frozen (``torch.where`` on a
    device flag ``active``) once the loop condition fails, so ``n_iters``,
    the iterate and the stats are the JAX loop's, with no host wait per
    iteration.  The host reads ``active`` before every ``poll_every``-th
    body and leaves the loop when it is false; the frozen bodies run in
    between (at most ``poll_every - 1`` per solve) are the price, counted
    in ``info["matvecs"]``.

    On a CUDA device with no ``mesh`` and a cap of ``CG_GRAPH_MIN_ITERS`` or
    more, the body is a CUDA graph: the first runs eagerly (the warm-up),
    the second is captured, and it and every later one are one replay each
    (``info``: "graph_bodies", the bodies replayed; "captures", 0 or 1).
    The replayed kernels are the eager ones, so the results are too, up to
    the order of the atomic sums.  Every preconditioner's apply reads
    nothing back to the host, so each is captured.  ``_eager`` turns the
    graph off (the card tests).

    ``make_body``: None for the body below, or a factory (b2, tol2,
    restarts, max_iters) -> a body of the same iteration and loop condition
    (the packed solver's ``schur_packed.fused_cg_body``), called once; every
    body then runs it, eager or captured ("fused_bodies").

    ``mesh``: the ranks of a multi-device layout, whose polls go through
    ``poll``'s maximum.  ``split``: the vectors are split over the ranks
    (the pose-range layout) and the dots are completed by a psum, as the
    JAX package's ``axis_name``; the edge-sharded layouts keep replicated
    vectors and local dots.
    """
    if callable(precond):
        apply_m = precond
    else:
        apply_m = lambda r: torch.einsum("pij,pj->pi", precond, r)  # noqa: E731

    def dot(u, v):
        d = torch.sum(u * v)
        return mesh.psum(d) if split else d

    tiny = torch.finfo(rhs.dtype).tiny
    tol2 = tol * tol
    matvecs = polls = graph_bodies = 0
    if x0 is None:
        x0 = torch.zeros_like(rhs)
        r0 = rhs
    else:
        r0 = rhs - matvec(x0)
        matvecs += 1
    z0 = apply_m(r0)
    rz0 = dot(r0, z0)
    b2 = torch.clamp(dot(rhs, rhs), min=tiny)
    rr0 = dot(r0, r0)
    first_bad = (rz0 <= 0) & (rr0 / b2 > tol2)
    d0 = torch.where(first_bad, r0, z0)

    cond = cg_cond(b2, tol2, restarts, max_iters)

    if make_body is None:
        def body(s: CGState, out: CGState | None = None) -> CGState:
            return cg_step(s, matvec(s.p), apply_m, dot, cond, out)
    else:
        body = make_body(b2, tol2, restarts, max_iters)
    k = torch.zeros((), dtype=torch.int32, device=rhs.device)
    nbrk = first_bad.to(torch.int32)
    s = CGState(x0, r0, d0, d0, torch.where(first_bad, rr0, rz0), rr0, nbrk, k, x0, rr0,
                cond(k, nbrk, rr0))
    graphed = (_GraphedBody(body) if rhs.is_cuda and mesh is None and not _eager
               and max_iters >= CG_GRAPH_MIN_ITERS else None)
    bodies = 0
    for it in range(max_iters):
        if it % poll_every == 0:
            polls += 1
            if not poll(s.active, mesh):
                break
        if graphed is not None and it > 0:
            s = graphed(s)
            graph_bodies += 1
        else:
            s = body(s)
        bodies += 1
    breakdown = s.nbrk > 0
    x_out = torch.where(breakdown, s.x_best, s.x)
    rr_out = torch.where(breakdown, s.rr_best, s.rr)
    return x_out, s.k, rr_out / b2, breakdown, {
        "matvecs": matvecs + bodies, "polls": polls, "graph_bodies": graph_bodies,
        "captures": int(graph_bodies > 0), "fused_bodies": 0 if make_body is None else bodies,
        "events": s.nbrk}


def flat_chain_band(Ho_sd: torch.Tensor, o_src: torch.Tensor, o_dst: torch.Tensor,
                    n_poses: int, mesh=None) -> torch.Tensor:
    """f32[NP-1, 3, 3] odometry-chain band from odometry edge arrays: the
    coupling between poses i and i+1 summed over every consecutive-pair
    edge, completed by a psum under a ``mesh``; other edges affect
    preconditioner quality only."""
    is_band = (o_dst == o_src + 1)[:, None, None].to(Ho_sd.dtype)
    band = _segment_sum(Ho_sd * is_band, o_src, n_poses - 1)
    return band if mesh is None else mesh.psum(band)


def resolve_preconditioner(which: str, n_poses: int, has_chain: bool,
                           bband: bool = False) -> str:
    """The preconditioner a PCG solve builds for ``cfg.preconditioner``, by
    the JAX package's rules: "auto" is btridiag up to 32768 poses (measured
    on its TPU), a chain preconditioner without a chain is block-Jacobi, and
    "bband" is itself on the path that builds it (``bband``) and
    block-Jacobi elsewhere."""
    if which == "auto":
        which = "btridiag" if n_poses <= 32768 else "block_jacobi"
    if which not in ("block_jacobi", "bband", "btridiag", "two_level"):
        raise ValueError(f"unknown preconditioner {which!r}")
    if which == "bband":
        return which if bband else "block_jacobi"
    return which if has_chain else "block_jacobi"


def preconditioner_apply(which: str, s_diag: torch.Tensor, chain_band, mask: torch.Tensor,
                         cfg: SolverConfig):
    """The apply of the resolved preconditioner ``which`` from the unmasked
    diag(S): the 3x3 block-inverse array (block-Jacobi), or r -> M^-1 r for
    T = tridiag(diag(S), ``chain_band()``) by the PD-clamped chain solve
    (``solver/btridiag.py``) or the two-level scheme
    (``solver/two_level.py``).  The fixed pose's block is pinned to the
    identity and its band entries zeroed, as the masked matvec."""
    eye3 = torch.eye(3, dtype=mask.dtype, device=mask.device)
    d = mask[..., None] * s_diag + (1.0 - mask[..., None]) * eye3
    if which == "block_jacobi":
        return _inv3x3(d)
    band = chain_band() * (mask[:-1, :, None] * mask[1:, :, None])
    if which == "two_level":
        from boslam_torch.solver.two_level import aggregate_size, two_level_factor, two_level_solve

        factor = two_level_factor(d, band, aggregate_size(cfg.coarse_q, d.shape[0]), mask,
                                  cycle=cfg.two_level_cycle)
        return lambda r: two_level_solve(factor, r)
    from boslam_torch.solver.btridiag import btridiag_factor, btridiag_solve

    # clamp_band 0.4999 < 1/2: the scaled factorization is provably PD;
    # healthy stiff-chain blocks sit just below 1/2 and are left alone
    factor = btridiag_factor(d, band, clamp_band=0.4999)
    return lambda r: btridiag_solve(factor, r)


def _flat_preconditioner(blocks: SchurBlocks, g: FactorGraph, cfg: SolverConfig,
                         mask: torch.Tensor, mesh=None):
    """PCG preconditioner of the flat path, where a graph of two poses or
    more has a chain and "bband" is block-Jacobi (the JAX package's)."""
    which = resolve_preconditioner(cfg.preconditioner, g.n_poses, g.n_poses > 1)
    band = lambda: flat_chain_band(blocks.Ho_sd, g.o_src, g.o_dst, g.n_poses, mesh)  # noqa: E731
    return preconditioner_apply(which, s_diag_blocks(blocks, g, mesh), band, mask, cfg)


def cg_stats(n_iters, rel_res2, breakdown, info, device, loop_rows: bool = False) -> dict:
    """The CG stats of one solve, as device tensors; the host counts are
    also charged to the open root span as "cg.bodies", "cg.polls",
    "cg.graph_bodies", "cg.fused_bodies" and "cg.loop_fused_bodies", the
    fused bodies where the system carries loop-closure rows
    (``loop_rows``, which the packed solver sets)."""
    count("cg.bodies", info["matvecs"])
    count("cg.polls", info["polls"])
    count("cg.graph_bodies", info["graph_bodies"])
    count("cg.fused_bodies", info["fused_bodies"])
    count("cg.loop_fused_bodies", info["fused_bodies"] if loop_rows else 0)
    return {
        "cg_iters": n_iters,
        "cg_rel_res2": rel_res2,
        "cg_breakdown": breakdown,
        "cg_matvecs": torch.full((), info["matvecs"], dtype=torch.int32, device=device),
        "cg_polls": torch.full((), info["polls"], dtype=torch.int32, device=device),
        "cg_breakdown_events": info["events"],
    }


def _scatter(M: torch.Tensor, rows, cols, vals) -> None:
    """M[rows[e, i], cols[e, j]] += vals[e, i, j], in place."""
    r = rows[:, :, None].expand(vals.shape)
    c = cols[:, None, :].expand(vals.shape)
    M.index_put_((r.reshape(-1), c.reshape(-1)), vals.reshape(-1), accumulate=True)


def _dense_pieces(blocks: SchurBlocks, g: FactorGraph, mesh=None):
    """Dense damped Hpp [3NP, 3NP] and coupling U [3NP, 2NL] from the blocks.
    Under a ``mesh`` the edge-scattered parts are completed by one psum
    before the (replicated) diagonal blocks are added."""
    NP_, NL = g.n_poses, g.n_landmarks
    dtype, dev = g.poses.dtype, g.device
    ar3 = torch.arange(3, device=dev)
    Hpp = torch.zeros((3 * NP_, 3 * NP_), dtype=dtype, device=dev)
    s3 = 3 * g.o_src[:, None] + ar3
    d3 = 3 * g.o_dst[:, None] + ar3
    _scatter(Hpp, s3, d3, blocks.Ho_sd)
    _scatter(Hpp, d3, s3, blocks.Ho_sd.transpose(1, 2))
    U = torch.zeros((3 * NP_, 2 * NL), dtype=dtype, device=dev)
    bp3 = 3 * g.b_pose[:, None] + ar3
    bl2 = 2 * g.b_lm[:, None] + torch.arange(2, device=dev)
    _scatter(U, bp3, bl2, blocks.Hpl)
    if mesh is not None:
        Hpp, U = mesh.psum(Hpp, U)
    ix3 = 3 * torch.arange(NP_, device=dev)[:, None] + ar3
    _scatter(Hpp, ix3, ix3, blocks.Hpp_diag)
    return Hpp, U


def dense_reduced_system(blocks: SchurBlocks, g: FactorGraph, mesh=None):
    """Materialize S (3NP x 3NP) and the reduced rhs.  Under a ``mesh`` U
    is completed before S = Hpp - U Hll^-1 U^T, which is quadratic in it."""
    NP_, NL = g.n_poses, g.n_landmarks
    Hpp, U = _dense_pieces(blocks, g, mesh)
    W = torch.einsum("plh,lhj->plj", U.reshape(3 * NP_, NL, 2), blocks.Hll_inv).reshape(
        3 * NP_, 2 * NL
    )
    S = Hpp - W @ U.T
    rhs = -blocks.bp.reshape(-1) + W @ blocks.bl.reshape(-1)
    return S, rhs


def fused_schur_inputs(g: FactorGraph, cfg: SolverConfig, damping, terms: EdgeTerms,
                       mask: torch.Tensor):
    """The padded inputs (Hpp, U, Hb, bp, bl, m) of
    ``fused_schur_solve_blocks``, assembled by scatter from damped blocks;
    ``Hb`` holds the [Ml/2, 2, 2] blocks of Hll^-1 (zero on the padding).

    Pad rows carry mask 0, so they are exactly decoupled.
    """
    from boslam_torch.ops.schur_solve import B as TB

    NP_, NL = g.n_poses, g.n_landmarks
    dtype, dev = g.poses.dtype, g.device
    blocks, _ = build_blocks(g, cfg, damping, terms=terms)
    Hpp, U = _dense_pieces(blocks, g)

    Np, Ml = 3 * NP_, 2 * NL
    Np_pad = ((Np + TB - 1) // TB) * TB
    Ml_pad = ((Ml + TB - 1) // TB) * TB
    Hpp_p = torch.zeros((Np_pad, Np_pad), dtype=dtype, device=dev)
    Hpp_p[:Np, :Np] = Hpp
    U_p = torch.zeros((Np_pad, Ml_pad), dtype=dtype, device=dev)
    U_p[:Np, :Ml] = U
    Hb = torch.zeros((Ml_pad // 2, 2, 2), dtype=dtype, device=dev)
    Hb[:NL] = blocks.Hll_inv
    bpf = torch.zeros(Np_pad, dtype=dtype, device=dev)
    bpf[:Np] = blocks.bp.reshape(-1)
    blf = torch.zeros(Ml_pad, dtype=dtype, device=dev)
    blf[:Ml] = blocks.bl.reshape(-1)
    m = torch.zeros(Np_pad, dtype=dtype, device=dev)
    m[:Np] = mask[:, 0].repeat_interleave(3)
    return Hpp_p, U_p, Hb, bpf, blf, m


def fused_schur_solve(g: FactorGraph, cfg: SolverConfig, damping, terms: EdgeTerms,
                      mask: torch.Tensor, band_tiles: int | None = None):
    """Exact Schur solve through ``ops.schur_solve.fused_schur_solve_blocks``:
    damping -> Schur correction -> Cholesky -> both back-substitutions in
    the kernel module, on the band route for a ``band_tiles`` (``kernel_band``)
    and the dense route for None.  Returns (dp f32[NP,3], dl f32[NL,2])."""
    from boslam_torch.ops.schur_solve import fused_schur_solve_blocks

    inputs = fused_schur_inputs(g, cfg, damping, terms, mask)
    # the blocks are already damped, so the kernel adds zero
    x, dl = fused_schur_solve_blocks(*inputs, 0.0, band_tiles)
    Np, Ml = 3 * g.n_poses, 2 * g.n_landmarks
    return x[:Np].reshape(g.n_poses, 3), dl[:Ml].reshape(g.n_landmarks, 2)


def _nan_guard(dp, dl):
    ok = torch.logical_not(torch.any(torch.isnan(dp)) | torch.any(torch.isnan(dl)))
    return (torch.where(ok, dp, torch.zeros_like(dp)),
            torch.where(ok, dl, torch.zeros_like(dl)), ok)


def _takes_kernel(g: FactorGraph, cfg: SolverConfig) -> bool:
    """The exact Schur kernel: a CUDA graph within ``fused_fits``, unless
    ``cholesky_backend="xla"`` (the JAX package's rule)."""
    from boslam_torch.ops.schur_solve import fused_fits

    return (cfg.cholesky_backend != "xla" and g.poses.is_cuda
            and fused_fits(3 * g.n_poses, 2 * g.n_landmarks))


def kernel_band(g: FactorGraph, cfg: SolverConfig) -> int | None:
    """The Schur kernel's route for a solve of ``g`` under ``cfg``: S's tile
    band (``gn_step.tile_band``) where the exact Schur kernel runs and the
    band fits, else None.  Computed once per solve (one host wait for the
    edges' structure), never per iteration."""
    if cfg.linear_solver != "schur" or not _takes_kernel(g, cfg):
        return None
    from boslam_torch.ops.gn_step import tile_band

    return tile_band(g)


def schur_build_and_solve(g: FactorGraph, cfg: SolverConfig, damping, use_cg: bool | None = None,
                          band_tiles: int | None = None, mesh=None):
    """Schur linear solve; same interface as the dense path.

    Returns (delta_poses f32[NP,3], delta_landmarks f32[NL,2], terms, ok,
    extra); ``extra`` holds the CG stats on the CG path, else nothing.
    Exact (``use_cg=False``): on a CUDA tensor within ``fused_fits`` the
    Schur kernel runs (unless ``cholesky_backend="xla"``); otherwise S is
    materialized and solved by ``solve_gauge_fixed`` under the same
    backend, as on the JAX package's non-TPU backends.  ``use_cg=True`` ("schur_cg"): matrix-free
    PCG to ``cfg.cg_tol``, a truncated inner solve of inexact Newton.
    ``band_tiles`` (from ``kernel_band``) picks the kernel's route.  Under
    edge sharding (``mesh``) the Schur kernel is not used, as in the JAX
    package: S is completed by psums and solved on every rank (through
    ``solve_gauge_fixed``, so by the Cholesky kernel on the card), and CG
    runs replicated.
    """
    if use_cg is None:
        use_cg = cfg.linear_solver == "schur_cg"
    mask = _pose_mask(g.n_poses, g.fixed_pose_ix, g.poses.dtype)
    extra = {}
    if not use_cg and mesh is None and _takes_kernel(g, cfg):
        terms = edge_terms(g, cfg)
        dp, dl = fused_schur_solve(g, cfg, damping, terms, mask, band_tiles)
        dp, dl, ok = _nan_guard(dp, dl)
        return dp, dl, terms, ok, extra

    blocks, terms = build_blocks(g, cfg, damping, mesh=mesh)
    if not use_cg:
        from boslam_torch.solver.gauss_newton import solve_gauge_fixed

        S, rhs_flat = dense_reduced_system(blocks, g, mesh)
        m = mask[:, 0].repeat_interleave(3)
        delta, _spd = solve_gauge_fixed(S, -rhs_flat, m, cfg)
        dp = delta.reshape(g.n_poses, 3)
    else:
        # reduced rhs: -bp + Hpl Hll^-1 bl, gauge-masked
        w = torch.einsum("lij,lj->li", blocks.Hll_inv, blocks.bl)
        corr = _segment_sum(torch.einsum("eij,ej->ei", blocks.Hpl, w[g.b_lm]), g.b_pose,
                            g.n_poses)
        if mesh is not None:
            corr = mesh.psum(corr)
        rhs = (-blocks.bp + corr) * mask
        precond = _flat_preconditioner(blocks, g, cfg, mask, mesh)
        dp, n_iters, rel_res2, breakdown, info = pcg(
            lambda x: s_matvec(blocks, g, x, mask, mesh), rhs, precond, cfg.cg_iters,
            cfg.cg_tol, restarts=cfg.cg_restarts, mesh=mesh,
        )
        extra = cg_stats(n_iters, rel_res2, breakdown, info, g.device)
    dp = dp * mask  # exact zero delta on the gauge pose

    # landmark back-substitution: dl = Hll^-1 (-bl - Hlp dp)
    hlp_dp = torch.einsum("eji,ej->ei", blocks.Hpl, dp[g.b_pose])
    hlp_dp = _segment_sum(hlp_dp, g.b_lm, g.n_landmarks)
    if mesh is not None:
        hlp_dp = mesh.psum(hlp_dp)
    dl = torch.einsum("lij,lj->li", blocks.Hll_inv, -blocks.bl - hlp_dp)
    dp, dl, ok = _nan_guard(dp, dl)
    return dp, dl, terms, ok, extra
