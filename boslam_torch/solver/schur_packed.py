"""Schur + PCG on the dual-packed layout, the scale-regime solver (port of
``boslam/solver/schur_packed.py``).

The math of ``schur.py``: every vertex-keyed reduction is a masked sum over
the packed slot axis, and the indexed operations are row gathers of the
slot grids, two per CG matvec.  The chain-prefix odometry couplings are
shifts; loop-closure edges past the prefix go through a small gather and
segment sum (in the fused body, through their per-pose lists,
``graph/packed.LoopRows``).  A grid with a windowed-gather plan gathers
through the windowed kernel (``ops/windowed_gather.py``), one launch per
gather: two in the build, one for the reduced rhs, one in
``packed_s_diag``, two per matvec and one in the back-substitution, so
5 + 2 k per outer iteration with k matvecs (LM's cost check adds one;
"bband" adds one for its assembly).  On the card, the solver hands ``pcg`` the kernel's body
(``fused_cg_body``) where ``fused_body_rule`` admits the system from the
preconditioner's resolved name (no mesh, block-Jacobi, f32 blocks, no row
chunks; the odometry a chain prefix with or without loop closures past
it): each CG body is then one ``ops/pcg_body.py`` call, four launches that
read both grids through their plans themselves, so its bodies launch no
``windowed_take``.  With ``coupling_dtype="bfloat16"`` the coupling
blocks are stored bf16 and every contraction with them (``_couple``)
rounds the other operand to bf16 too and sums in f32, as the JAX package's
MXU-native bf16 x bf16 -> f32 einsum; the CG tolerance is then clamped to
``BF16_CG_TOL_FLOOR``.

Under a ``mesh`` (``parallel/sharded_packed.py``) the slot grids are the
rank's slot columns and the odometry its edge shard; the state, the
per-vertex blocks and the CG vectors are replicated.  The build completes
its sums with one psum call, and each CG matvec takes two psums (z before
the Hll^-1 back-coupling, then the y partials).  Odometry then takes the
general gather/segment-sum path: a shard's place in the chain is unknown.

A step's phases are the spans "assemble" (blocks, reduced rhs,
preconditioner), "pcg" and "update" (back-substitution, NaN guard, stats,
then the step's boxplus: two ranges per step), under the caller's "step".
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from boslam_torch.config import BF16_CG_TOL_FLOOR, SolverConfig
from boslam_torch.geometry.se2 import boxplus_state
from boslam_torch.graph.data import FactorGraph
from boslam_torch.graph.packed import PackedEdges
from boslam_torch.ops.counters import counter
from boslam_torch.ops.pcg_body import PCGSystem, pcg_body
from boslam_torch.ops.windowed_gather import WindowPlan, windowed_take
from boslam_torch.solver.gauss_newton import delta_norm
from boslam_torch.solver import residuals as R
from boslam_torch.solver.robust import robust_cost, robust_weights
from boslam_torch.solver.schur import (
    CGState, _inv2x2, _nan_guard, _pose_mask, _segment_sum, cg_cond, cg_stats, cg_step,
    flat_chain_band, pcg, preconditioner_apply, resolve_preconditioner,
)
from boslam_torch.utils.spans import span


def _take(values: torch.Tensor, idx: torch.Tensor, plan: "WindowPlan | None"):
    """values[idx] by plain gather, or by the windowed kernel when the grid
    has a plan.  The plain gather fetches row 0 for padding slots (omega
    masks it downstream); the windowed one gives exact zeros.  Each call
    counts its route (``gather_counts``)."""
    if plan is None:
        _take.plain += 1
        return values[idx]
    _take.windowed += 1
    flat = values.reshape(values.shape[0], -1).contiguous()
    return windowed_take(flat, idx, plan).reshape(idx.shape + values.shape[1:])


counter(_take, "windowed", "plain")


def gather_counts() -> tuple:
    """(windowed, plain): the packed gathers made so far by route.

    Counted on every device, the CPU's plain version of the windowed gather
    too; on the card a windowed gather is one ``windowed_take.launches``.
    Registered in ``ops/counters.py``, so a CUDA graph's replay charges
    what its captured body counted."""
    return _take.windowed, _take.plain


def _couple(spec: str, B: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Coupling-block einsum with f32 sums whatever the storage.

    bf16 blocks: ``x`` is rounded to bf16 (nearest even) and both operands
    are widened to f32, whose products of two bf16 values are exact, so
    only the order of the sums can differ from a bf16 x bf16 -> f32
    contraction.  The widened copy of the blocks is made on every call (a
    fused contraction is later work)."""
    if B.dtype == torch.bfloat16:
        return torch.einsum(spec, B.float(), x.to(torch.bfloat16).float())
    return torch.einsum(spec, B, x)


def _lm_rows_sum(x, pk: PackedEdges, NL: int):
    """Finish a landmark-keyed reduction over the grid's virtual rows:
    identity with one row per landmark, else a segment sum by ``l_virt``."""
    if pk.l_virt is None:
        return x
    return _segment_sum(x, pk.l_virt, NL)


class PackedBlocks(NamedTuple):
    Hpp_diag: torch.Tensor  # [NP, 3, 3]
    Hll_inv: torch.Tensor  # [NL, 2, 2]
    Bp: torch.Tensor  # [NP, K, 3, 2] pose-packed coupling blocks (f32 or bf16)
    Bl: torch.Tensor  # [NLV, K2, 3, 2] landmark-packed coupling blocks (f32 or bf16)
    bp: torch.Tensor  # [NP, 3]
    bl: torch.Tensor  # [NL, 2]
    Ho_sd: torch.Tensor  # [NO, 3, 3] odometry couplings
    o_src: torch.Tensor  # [NO]
    o_dst: torch.Tensor  # [NO]


def _bearing_slot_terms(p_slot, l_slot, meas, omega, cfg, kt=None):
    """Residual, Jacobian and weighted blocks for a [*, K] slot grid.

    ``p_slot`` f32[*, K, 3] poses per slot, ``l_slot`` f32[*, K, 2]
    landmarks per slot; padding slots (omega == 0) contribute zero.  ``kt``
    overrides the robust threshold (GNC).
    """
    err = R.bearing_error_from(p_slot, l_slot, meas)
    jp, jl = R.bearing_jacobians_from(p_slot, l_slot)
    chi2 = omega * err * err
    wH, wb = robust_weights(chi2, cfg, kt)
    womega_H = omega * wH
    Hpp = womega_H[..., None, None] * jp[..., :, None] * jp[..., None, :]
    Hll = womega_H[..., None, None] * jl[..., :, None] * jl[..., None, :]
    B = womega_H[..., None, None] * jp[..., :, None] * jl[..., None, :]
    coef = (omega * wb * err)[..., None]
    return err, chi2, Hpp, Hll, B, coef * jp, coef * jl


def _odometry_terms(ps, pd, meas, omega, cfg: SolverConfig, kt=None):
    """Odometry chi2 and blocks of edges with endpoint poses ``ps``, ``pd``:
    (ochi2, H_ss, H_dd, H_sd, bp_s, bp_d)."""
    oe = R.odometry_error_from(ps, pd, meas)
    js, jd = R.odometry_jacobians_from(ps, pd)
    ochi2 = torch.einsum("ei,eij,ej->e", oe, omega, oe)
    owH, owb = robust_weights(ochi2, cfg, kt)
    OmJs = torch.einsum("eij,ejk->eik", omega, js)
    OmJd = torch.einsum("eij,ejk->eik", omega, jd)
    w = owH[:, None, None]
    H_ss = w * torch.einsum("eai,eaj->eij", js, OmJs)
    H_dd = w * torch.einsum("eai,eaj->eij", jd, OmJd)
    H_sd = w * torch.einsum("eai,eaj->eij", js, OmJd)
    e_w = torch.einsum("eij,ej->ei", omega, owb[:, None] * oe)
    bp_s = torch.einsum("eij,ei->ej", js, e_w)
    bp_d = torch.einsum("eij,ei->ej", jd, e_w)
    return ochi2, H_ss, H_dd, H_sd, bp_s, bp_d


def build_packed_blocks(g: FactorGraph, pk: PackedEdges, cfg: SolverConfig, damping, kt=None,
                        mesh=None):
    """Damped packed normal-equation blocks and the chi2 stats of the state.

    ``damping`` is a float or a device scalar (LM); ``kt`` a host float or
    None.  Under a ``mesh`` the per-vertex sums and the stats are completed
    by psums before damping.  Returns (PackedBlocks, stats).
    """
    NP_, NL = g.n_poses, g.n_landmarks
    dtype, dev = g.poses.dtype, g.device

    # pose-packed pass: pose broadcast, landmarks gathered
    p_slot = g.poses[:, None, :].expand(NP_, pk.K, 3)
    l_slot = _take(g.landmarks, pk.p_lm, pk.p_plan)
    _be, bchi2_p, Hpp_b, _Hll_p, Bp, bp_b, _bl_p = _bearing_slot_terms(
        p_slot, l_slot, pk.p_meas, pk.p_omega, cfg, kt)
    Hpp_diag = torch.sum(Hpp_b, dim=1)
    bp = torch.sum(bp_b, dim=1)

    # landmark-packed pass: landmark broadcast, poses gathered; with
    # hot-landmark splitting the sums finish over the virtual rows
    lm_rows = g.landmarks if pk.l_virt is None else g.landmarks[pk.l_virt]
    NLV = pk.l_pose.shape[0]
    l_slot2 = lm_rows[:, None, :].expand(NLV, pk.K2, 2)
    p_slot2 = _take(g.poses, pk.l_pose, pk.l_plan)
    _, _, _, Hll_b, Bl, _, bl_b = _bearing_slot_terms(
        p_slot2, l_slot2, pk.l_meas, pk.l_omega, cfg, kt)
    Hll = _lm_rows_sum(torch.sum(Hll_b, dim=1), pk, NL)
    bl = _lm_rows_sum(torch.sum(bl_b, dim=1), pk, NL)

    # odometry: shifts for the leading chain prefix, segment sum for the rest
    ochi2, H_ss, H_dd, H_sd, bp_s, bp_d = _odometry_terms(
        g.poses[g.o_src], g.poses[g.o_dst], g.o_meas, g.o_omega, cfg, kt)
    nc, NO = (pk.chain_len if mesh is None else 0), g.n_odometry
    if nc > 0:
        Hpp_diag = Hpp_diag.clone()
        bp = bp.clone()
        Hpp_diag[:nc] += H_ss[:nc]
        Hpp_diag[1:nc + 1] += H_dd[:nc]
        bp[:nc] += bp_s[:nc]
        bp[1:nc + 1] += bp_d[:nc]
    if nc < NO:
        rest = NO - nc
        payload = torch.cat([
            torch.cat([H_ss[nc:].reshape(rest, 9), bp_s[nc:]], dim=1),
            torch.cat([H_dd[nc:].reshape(rest, 9), bp_d[nc:]], dim=1),
        ])
        sums = _segment_sum(payload, torch.cat([g.o_src[nc:], g.o_dst[nc:]]), NP_)
        Hpp_diag = Hpp_diag + sums[:, :9].reshape(NP_, 3, 3)
        bp = bp + sums[:, 9:12]

    ktv = cfg.kernel_threshold if kt is None else kt
    stats = {
        "chi2_bearing": torch.sum(bchi2_p),
        "chi2_odometry": torch.sum(ochi2),
        "chi2_robust": torch.sum(robust_cost(bchi2_p, cfg, kt) * (pk.p_omega > 0))
        + torch.sum(robust_cost(ochi2, cfg, kt) * (ochi2 > 0)),
        "n_bearing_clamped": torch.sum(bchi2_p > ktv),
        "n_odometry_clamped": torch.sum(ochi2 > ktv),
    }
    if mesh is not None:
        Hpp_diag, Hll, bp, bl, *vals = mesh.psum(Hpp_diag, Hll, bp, bl, *stats.values())
        stats = dict(zip(stats, vals))

    Hpp_diag = Hpp_diag + damping * torch.eye(3, dtype=dtype, device=dev)
    Hll_inv = _inv2x2(Hll + damping * torch.eye(2, dtype=dtype, device=dev))
    if cfg.coupling_dtype == "bfloat16":
        Bp = Bp.to(torch.bfloat16)
        Bl = Bl.to(torch.bfloat16)
    return PackedBlocks(Hpp_diag, Hll_inv, Bp, Bl, bp, bl, H_sd, g.o_src, g.o_dst), stats


def _odometry_coupling(blocks: PackedBlocks, pk: PackedEdges, xm, NP_: int, mesh=None):
    """(Ho_sd + Ho_sd^T cross terms) @ x over all odometry edges: shifts for
    the chain prefix, one gather + segment sum for the rest (all of them
    under a ``mesh``, whose caller completes the partial)."""
    nc = pk.chain_len if mesh is None else 0
    NO = blocks.Ho_sd.shape[0]
    y = torch.zeros((NP_, 3), dtype=xm.dtype, device=xm.device)
    if nc > 0:
        Ho = blocks.Ho_sd[:nc]
        y[:nc] += torch.einsum("eij,ej->ei", Ho, xm[1:nc + 1])
        y[1:nc + 1] += torch.einsum("eji,ej->ei", Ho, xm[:nc])
    if nc < NO:
        src, dst = blocks.o_src[nc:], blocks.o_dst[nc:]
        Ho = blocks.Ho_sd[nc:]
        x_ends = xm[torch.cat([dst, src])]
        m = NO - nc
        y_sd = torch.einsum("eij,ej->ei", Ho, x_ends[:m])
        y_ds = torch.einsum("eji,ej->ei", Ho, x_ends[m:])
        y = y + _segment_sum(torch.cat([y_sd, y_ds]), torch.cat([src, dst]), NP_)
    return y


def _chunked_rows(fn, arrs, n_rows: int, chunk: int):
    """``fn`` over row chunks of the leading axis of every array in
    ``arrs``, concatenated: bounds the gathered slot intermediates to one
    chunk (``cfg.matvec_row_chunk``)."""
    return torch.cat([fn(*[a[i:i + chunk] for a in arrs]) for i in range(0, n_rows, chunk)])


def packed_s_matvec(blocks: PackedBlocks, pk: PackedEdges, x, mask, row_chunk: int = 0,
                    mesh=None):
    """y = S_masked @ x with two row gathers and, on a chain, no scatter;
    under a ``mesh`` two psums (z, then the y partials)."""
    xm = x * mask
    NP_ = x.shape[0]
    use_chunks = row_chunk > 0 and pk.p_plan is None and pk.l_plan is None

    # z = Hlp x (landmark-packed: gather x by slot pose, sum the slots)
    if use_chunks:
        z = _chunked_rows(lambda b, ix: _couple("lkij,lki->lj", b, xm[ix]),
                          (blocks.Bl, pk.l_pose), pk.l_pose.shape[0], row_chunk)
    else:
        z = _couple("lkij,lki->lj", blocks.Bl, _take(xm, pk.l_pose, pk.l_plan))
    z = _lm_rows_sum(z, pk, blocks.Hll_inv.shape[0])
    if mesh is not None:
        z = mesh.psum(z)
    w = torch.einsum("lij,lj->li", blocks.Hll_inv, z)

    # y_corr = Hpl w (pose-packed: gather w by slot landmark, sum the slots)
    if use_chunks:
        y_corr = _chunked_rows(lambda b, ix: _couple("pkij,pkj->pi", b, w[ix]),
                               (blocks.Bp, pk.p_lm), pk.p_lm.shape[0], row_chunk)
    else:
        y_corr = _couple("pkij,pkj->pi", blocks.Bp, _take(w, pk.p_lm, pk.p_plan))
    y_partial = _odometry_coupling(blocks, pk, xm, NP_, mesh) - y_corr
    if mesh is not None:
        y_partial = mesh.psum(y_partial)
    y = torch.einsum("pij,pj->pi", blocks.Hpp_diag, xm) + y_partial
    return y * mask + x * (1.0 - mask)


def packed_s_diag(blocks: PackedBlocks, pk: PackedEdges, mesh=None) -> torch.Tensor:
    """Exact diag(S): Hpp_ii - sum_k B Hll_inv[lm] B^T over the pose slots.

    With a windowed plan the Hll_inv blocks are gathered through the kernel
    (and rounded to bf16 under bf16 blocks, as the JAX package's einsum
    does); without one, the three unique Hll_inv components are gathered
    through the transposed [K, NP] indices and combined component by
    component, as the JAX package does.

    The products, the sum over the slots and the difference run in f64 (the
    JAX package: f32) and the result is f32: the difference cancels where a
    pose alone observes its landmarks, and in f32 the order of the sum then
    decided the result, so pose-range's diag(S), the same sum in another
    order, parted from this one by 3e-7 and its two-level preconditioner's
    apply by 9e-2 (PERF.md section 6).  Under a ``mesh`` each rank's sum is
    rounded to f32 before the psum.
    """
    Bp = blocks.Bp.double()
    if pk.p_plan is not None:
        Hinv_g = _take(blocks.Hll_inv, pk.p_lm, pk.p_plan)
        if blocks.Bp.dtype == torch.bfloat16:
            Hinv_g = Hinv_g.to(torch.bfloat16)
        corr = torch.einsum("pkij,pkjl,pkml->pim", Bp, Hinv_g.double(), Bp)
    else:
        idxT = pk.p_lm.T  # [K, NP]
        Hinv = blocks.Hll_inv.double()
        a = Hinv[:, 0, 0][idxT]
        b = Hinv[:, 0, 1][idxT]
        d = Hinv[:, 1, 1][idxT]
        BT = Bp.permute(1, 2, 3, 0)  # [K, 3, 2, NP]
        # u_j = Hll_inv @ B's j-th row per slot; corr_im = sum_k B_i . u_m
        rows = []
        for i in range(3):
            u0 = a * BT[:, i, 0] + b * BT[:, i, 1]
            u1 = b * BT[:, i, 0] + d * BT[:, i, 1]
            rows.append((u0, u1))
        comps = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for m in range(i, 3):
                u0, u1 = rows[m]
                comps[i][m] = torch.sum(BT[:, i, 0] * u0 + BT[:, i, 1] * u1, dim=0)
                comps[m][i] = comps[i][m]
        corr = torch.stack([torch.stack(r, dim=-1) for r in comps], dim=-2)
    if mesh is not None:
        corr = mesh.psum(corr.float())
    return (blocks.Hpp_diag.double() - corr).float()


def _chain_band(blocks: PackedBlocks, pk: PackedEdges, NP_: int, mesh=None) -> torch.Tensor:
    """f32[NP-1, 3, 3] chain band: the chain-prefix couplings, zero past it;
    under a ``mesh``, ``flat_chain_band`` of the rank's edges (the same
    band; other edges are left out)."""
    if mesh is not None:
        return flat_chain_band(blocks.Ho_sd, blocks.o_src, blocks.o_dst, NP_, mesh)
    nc = pk.chain_len
    band = blocks.Ho_sd.new_zeros((NP_ - 1, 3, 3))
    band[:nc] = blocks.Ho_sd[:nc]
    return band


def _packed_which(pk: PackedEdges, cfg: SolverConfig, NP_: int) -> str:
    """The packed path's preconditioner: on a chain prefix, bband its own."""
    return resolve_preconditioner(cfg.preconditioner, NP_, pk.chain_len > 0 and NP_ > 1,
                                  bband=True)


def _packed_preconditioner(blocks: PackedBlocks, pk: PackedEdges, cfg: SolverConfig, mask,
                           mesh=None):
    """The PCG preconditioner of the packed system (``_packed_which``):
    "bband", the block-banded T = band_w(S) over super-nodes of q =
    band_group or band_width poses (``solver/bband.py``), or
    ``preconditioner_apply``'s."""
    NP_ = blocks.Hpp_diag.shape[0]
    which = _packed_which(pk, cfg, NP_)
    if which == "bband":
        from boslam_torch.solver.bband import assemble_sband, bband_factor, bband_solve

        # assembled as wide as the super-node, so that every diagonal
        # super-block is an exact principal submatrix of S; uncompensated,
        # T may be indefinite: the 0.98 clamp and the per-group fallback
        # guard it (the JAX package's choices)
        q = int(cfg.band_group) or max(1, int(cfg.band_width))
        diag, band = assemble_sband(blocks, pk, q, mask, mesh=mesh)
        factor = bband_factor(diag, band, q, clamp_band=0.98)
        return lambda r: bband_solve(factor, r)

    def chain_band():
        band = _chain_band(blocks, pk, NP_, mesh)
        if which == "btridiag" and cfg.btridiag_block and NP_ > cfg.btridiag_block:
            # optional chain cutting into independent sub-chains (legacy knob)
            i = torch.arange(NP_ - 1, device=band.device)
            band = band * (((i + 1) % cfg.btridiag_block) != 0)[:, None, None].to(band.dtype)
        return band

    return preconditioner_apply(which, packed_s_diag(blocks, pk, mesh), chain_band, mask, cfg)


def fused_body_rule(blocks: PackedBlocks, pk: PackedEdges, which: str, row_chunk: int = 0,
                    mesh=None) -> bool:
    """Whether the CG body of this system may be one ``ops/pcg_body.py``
    call: no mesh, block-Jacobi as the resolved preconditioner ``which``,
    f32 coupling blocks, no row chunks, and an odometry that is its chain
    prefix, or a chain prefix and loop closures listed per pose
    (``pk.loops``, which ``pack_edges`` builds).  The solver adds the last
    condition, a CUDA device; every other system keeps the body of
    ``pcg``."""
    return (mesh is None and which == "block_jacobi"
            and blocks.Bp.dtype == blocks.Bl.dtype == torch.float32 and row_chunk == 0
            and (pk.chain_len == blocks.Ho_sd.shape[0] or pk.loops is not None))


def plain_cg_body(blocks: PackedBlocks, pk: PackedEdges, mask, precond, b2, tol2: float,
                  restarts: int, max_iters: int):
    """The fused body's plain twin: ``pcg``'s own body (``schur.cg_step``)
    over ``packed_s_matvec`` under block-Jacobi, on any device; a body
    (s, out=None) -> CGState."""
    cond = cg_cond(b2, tol2, restarts, max_iters)

    def body(s: CGState, out: CGState | None = None) -> CGState:
        return cg_step(s, packed_s_matvec(blocks, pk, s.p, mask),
                       lambda r: torch.einsum("pij,pj->pi", precond, r),
                       lambda u, v: torch.sum(u * v), cond, out)

    return body


def fused_cg_body(blocks: PackedBlocks, pk: PackedEdges, mask, precond, b2, tol2: float,
                  restarts: int, max_iters: int):
    """``plain_cg_body`` as one ``pcg_body`` call on the card, which charges
    the two gathers it makes by route (``gather_counts``).  The loop
    closures' couplings are ``blocks.Ho_sd[pk.chain_len:]`` in place."""
    system = PCGSystem(blocks.Hpp_diag, precond, blocks.Ho_sd, mask, blocks.Hll_inv, blocks.Bp,
                       pk.p_lm, blocks.Bl, pk.l_pose, pk.l_virt, pk.p_plan, pk.l_plan, b2, tol2,
                       restarts, max_iters, loops=pk.loops)
    windowed = (pk.p_plan is not None) + (pk.l_plan is not None)

    def body(s: CGState, out: CGState | None = None) -> CGState:
        _take.windowed += windowed
        _take.plain += 2 - windowed
        return CGState(*pcg_body(system, s, out))

    return body


def schur_packed_build_and_solve(g: FactorGraph, pk: PackedEdges, cfg: SolverConfig, damping,
                                 x0=None, kt=None, mesh=None):
    """Full linear solve on the packed layout: (dp, dl, stats, ok).

    ``x0`` warm-starts CG; ``kt`` overrides the robust threshold (GNC).
    """
    with span("assemble"):
        blocks, stats = build_packed_blocks(g, pk, cfg, damping, kt, mesh)
        mask = _pose_mask(g.n_poses, g.fixed_pose_ix, g.poses.dtype)

        w0 = torch.einsum("lij,lj->li", blocks.Hll_inv, blocks.bl)
        corr = _couple("pkij,pkj->pi", blocks.Bp, _take(w0, pk.p_lm, pk.p_plan))
        if mesh is not None:
            corr = mesh.psum(corr)
        rhs = (-blocks.bp + corr) * mask

        precond = _packed_preconditioner(blocks, pk, cfg, mask, mesh)
        make_body = None
        if g.poses.is_cuda and fused_body_rule(blocks, pk, _packed_which(pk, cfg, g.n_poses),
                                               cfg.matvec_row_chunk, mesh):
            make_body = functools.partial(fused_cg_body, blocks, pk, mask, precond)
        if x0 is not None:
            x0 = x0 * mask
    # bf16 blocks put a ~2^-8 noise floor under the matvec: asking CG for
    # less only runs it to the cap, so the tolerance is clamped to it
    cg_tol = cfg.cg_tol
    if cfg.coupling_dtype == "bfloat16":
        cg_tol = max(cg_tol, BF16_CG_TOL_FLOOR)
    with span("pcg"):
        dp, n_iters, rel_res2, breakdown, info = pcg(
            lambda x: packed_s_matvec(blocks, pk, x, mask, cfg.matvec_row_chunk, mesh), rhs,
            precond, cfg.cg_iters, cg_tol, x0, restarts=cfg.cg_restarts, mesh=mesh,
            make_body=make_body,
        )
    with span("update"):
        dp = dp * mask

        hlp_dp = _couple("lkij,lki->lj", blocks.Bl, _take(dp, pk.l_pose, pk.l_plan))
        hlp_dp = _lm_rows_sum(hlp_dp, pk, blocks.Hll_inv.shape[0])
        if mesh is not None:
            hlp_dp = mesh.psum(hlp_dp)
        dl = torch.einsum("lij,lj->li", blocks.Hll_inv, -blocks.bl - hlp_dp)

        dp, dl, ok = _nan_guard(dp, dl)
        stats.update(cg_stats(n_iters, rel_res2, breakdown, info, g.device,
                              loop_rows=pk.loops is not None))
        stats["cg_tol_effective"] = torch.full((), cg_tol, dtype=torch.float32, device=g.device)
    return dp, dl, stats, ok


def packed_robust_total(g: FactorGraph, pk: PackedEdges, cfg: SolverConfig, kt=None, mesh=None):
    """Total robust cost on the packed layout (no Jacobians): the LM test;
    a psum of the ranks' partials under a ``mesh``."""
    NP_ = g.n_poses
    p_slot = g.poses[:, None, :].expand(NP_, pk.K, 3)
    l_slot = _take(g.landmarks, pk.p_lm, pk.p_plan)
    err = R.bearing_error_from(p_slot, l_slot, pk.p_meas)
    bchi2 = pk.p_omega * err * err
    oe = R.odometry_error_from(g.poses[g.o_src], g.poses[g.o_dst], g.o_meas)
    ochi2 = torch.einsum("ei,eij,ej->e", oe, g.o_omega, oe)
    total = (torch.sum(robust_cost(bchi2, cfg, kt) * (pk.p_omega > 0))
             + torch.sum(robust_cost(ochi2, cfg, kt) * (ochi2 > 0)))
    return total if mesh is None else mesh.psum(total)


def _step_stats(stats, ok, accepted, damping, kt, cfg, dp, dl, dev) -> dict:
    stats = dict(stats)
    stats["spd_ok"] = ok
    stats["accepted"] = accepted
    stats["damping"] = damping
    stats["kt"] = torch.full((), cfg.kernel_threshold if kt is None else kt,
                             dtype=torch.float32, device=dev)
    stats["delta_norm"] = delta_norm(dp, dl)
    return stats


def packed_lm_step(g: FactorGraph, pk: PackedEdges, cfg: SolverConfig, lam, dp_prev=None,
                   kt=None, mesh=None):
    """One LM trial on the packed layout: (g', lam', stats, dp).

    Accept the candidate iff the robust cost decreases and the solve stayed
    finite, then scale lam down (accept) or up (reject).  The returned
    ``dp`` warm-starts the next trial only when this one was accepted.
    """
    x0 = dp_prev if cfg.cg_warm_start else None
    dp, dl, stats, ok = schur_packed_build_and_solve(g, pk, cfg, lam, x0, kt, mesh)
    with span("update"):
        cand = g.with_state(*boxplus_state(g.poses, g.landmarks, dp, dl))
        cost_new = packed_robust_total(cand, pk, cfg, kt, mesh)
        accept = (cost_new < stats["chi2_robust"]) & ok
        poses = torch.where(accept, cand.poses, g.poses)
        landmarks = torch.where(accept, cand.landmarks, g.landmarks)
        new_lam = torch.where(accept, torch.clamp(lam * cfg.lm_down, min=cfg.lm_lambda_min),
                              torch.clamp(lam * cfg.lm_up, max=cfg.lm_lambda_max))
        stats = _step_stats(stats, ok, accept, lam, kt, cfg, dp, dl, g.device)
        dp_next = torch.where(accept, dp, torch.zeros_like(dp))
    return g.with_state(poses, landmarks), new_lam, stats, dp_next


def packed_gn_step(g: FactorGraph, pk: PackedEdges, cfg: SolverConfig, dp_prev=None, kt=None,
                   mesh=None):
    """One GN iteration on the packed layout: (g', stats, dp).  With
    ``cfg.cg_warm_start`` CG starts from ``dp_prev``."""
    x0 = dp_prev if cfg.cg_warm_start else None
    dp, dl, stats, ok = schur_packed_build_and_solve(g, pk, cfg, cfg.damping, x0, kt, mesh)
    with span("update"):
        poses, landmarks = boxplus_state(g.poses, g.landmarks, dp, dl)
        dev = g.device
        stats = _step_stats(stats, ok, torch.ones((), dtype=torch.bool, device=dev),
                            torch.full((), cfg.damping, dtype=g.poses.dtype, device=dev), kt,
                            cfg, dp, dl, dev)
    return g.with_state(poses, landmarks), stats, dp
