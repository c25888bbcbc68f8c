"""Roofline accounting for the port's solver paths and kernels (port of
``boslam/utils/roofline.py``).

The four models count the algorithmic FLOPs and the unavoidable memory
traffic of one step of each solver path, as the JAX module does, with the
same arithmetic, so they give the JAX module's floats exactly: a share read
through them reads the same work whatever implements it.  Dividing by a
measured step time gives achieved FLOP/s and bytes/s, compared with the
card's f32 peak and memory rate; ``roofline_util`` is the utilization of
the binding resource.  When both are tiny the step is latency-bound (many
small launches), which is itself the diagnosis.

The models count the JAX headline's algorithm: ``schur_step_model`` and
``useful_step_flops`` count a dense ``(3 NP)^3 / 3`` factorization of the
reduced system S.  The port's band route factors only S's envelope, whose
count is ``schur_solve_work`` below; the kernels' bounds in
``chip_smoke.py`` are taken from these envelope counts.

The card's peaks: ``chip_spec`` knows NVIDIA's H100 parts only, from the
NVIDIA H100 Tensor Core GPU data sheet (dense rates, without sparsity):

    part                     f32 (CUDA cores)  bf16 (tensor cores)  memory
    H100 SXM (80GB HBM3)     67 TFLOP/s        989.4 TFLOP/s         3.35 TB/s
    H100 PCIe                51.2 TFLOP/s      756 TFLOP/s           2.0 TB/s
    H100 NVL                 60 TFLOP/s        835 TFLOP/s           3.9 TB/s

Those rates assume the part's full power limit; a card set below it runs
slower under load, so a share is stated beside the card's power limit.

Departure from the JAX module: an unknown card raises ``ValueError``
naming it, and so does a call with no CUDA device and no ``device_kind``.
The JAX function falls back to a TPU v5e spec; a port that assumed a card
it did not find would print a false share.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ChipSpec(NamedTuple):
    name: str
    peak_flops_bf16: float  # tensor cores, bf16 multiply / f32 accumulate, dense
    # f32 FMA on the CUDA cores: the port's kernels never use TF32 (f32 end
    # to end, boslam_torch/__init__.py), so this is the peak they can reach
    peak_flops_f32: float
    hbm_bytes_per_s: float


_CARDS = {
    # torch.cuda.get_device_name -> spec (NVIDIA H100 data sheet)
    "NVIDIA H100 80GB HBM3": ChipSpec("NVIDIA H100 SXM", 989.4e12, 67e12, 3.35e12),
    "NVIDIA H100 PCIe": ChipSpec("NVIDIA H100 PCIe", 756e12, 51.2e12, 2.0e12),
    "NVIDIA H100 NVL": ChipSpec("NVIDIA H100 NVL", 835e12, 60e12, 3.9e12),
}


def chip_spec(device_kind: str | None = None) -> ChipSpec:
    """The peaks of the card named ``device_kind`` (default: CUDA device 0,
    by ``torch.cuda.get_device_name``).  Raises ``ValueError`` for a card
    not in the table, and when no name is given and there is no CUDA
    device."""
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            raise ValueError("chip_spec: no CUDA device and no device_kind given; "
                             "there is no card to read peaks for")
        device_kind = torch.cuda.get_device_name(0)
    spec = _CARDS.get(device_kind.strip())
    if spec is None:
        raise ValueError(f"chip_spec: no peak figures for the card {device_kind!r}; "
                         f"known: {', '.join(_CARDS)}")
    return spec


def dense_step_model(NP: int, NL: int, NB: int, NO: int) -> tuple[float, float]:
    """(flops, bytes) of one dense-path GN step with matmul assembly.

    Dominated by H = A^T W A (A is [NB, N] / [3*NO, 3*NP]) and the N^3/3
    Cholesky.
    """
    N = 3 * NP + 2 * NL
    edge_math = NB * 120 + NO * 700  # residuals + jacobian blocks + trig
    ata = 2.0 * NB * N * N + 2.0 * (3 * NO) * (3 * NP) ** 2
    chol = N**3 / 3 + 4.0 * N * N  # factor + two triangular solves
    flops = edge_math + ata + chol

    f4 = 4.0
    a_traffic = 2 * NB * N * f4 + 2 * (3 * NO) * (3 * NP) * f4  # write + read A
    onehots = (NB * (NP + NL) + 2 * NO * NP) * f4
    h_traffic = 3 * N * N * f4  # write H, read for Cholesky, write factor
    bytes_ = a_traffic + onehots + h_traffic
    return flops, bytes_


def packed_outer_model(
    NP: int,
    NL: int,
    K: int,
    K2: int,
    NO: int,
    cg_iters: float,
    lm_rows: "int | None" = None,
    coupling_bytes: float = 4.0,
) -> tuple[float, float]:
    """(flops, bytes) of one packed Schur+PCG outer iteration.

    Build: per-slot residual/Jacobian/outer-product math over both slot
    grids.  Per CG iteration: the two coupling contractions over the
    [NP,K] / [NLV,K2] block grids dominate both FLOPs and traffic (the B
    blocks are re-read every matvec).  ``lm_rows`` (NLV) is the landmark
    grid's row count, > NL under hot-landmark splitting.  ``cg_iters`` is
    the mean over the outers of the run.
    """
    NLV = NL if lm_rows is None else lm_rows
    slots = NP * K + NLV * K2
    build = slots * 110.0 + NO * 700.0 + NL * 30.0  # + 2x2 inversions
    matvec = (
        12.0 * NP * K  # Bp contraction [3x2 block x vec, mul+add]
        + 12.0 * NLV * K2  # Bl contraction
        + 8.0 * NL  # Hll_inv apply
        + 18.0 * NP  # Hpp_diag apply
        + 36.0 * NO  # odometry couplings
        + 70.0 * NP  # preconditioner apply + CG vector ops
    )
    flops = build + cg_iters * matvec

    f4 = 4.0
    # Bp + Bl re-read each CG iteration; 2 bytes/elt when stored bf16
    b_blocks = (6.0 * NP * K + 6.0 * NLV * K2) * coupling_bytes
    gathers = (3.0 * NLV * K2 + 2.0 * NP * K) * f4  # xg / wg rows
    vectors = (9.0 * NP + 4.0 * NL + 8.0 * NP) * f4
    if NLV > NL:
        # hot-landmark splitting: the z payload is produced per virtual row
        # (NLV x 2 partials written), then segment-summed into NL rows
        # (read + write) each matvec
        vectors += (2.0 * NLV + 2.0 * NLV + 2.0 * NL) * f4
    bytes_ = slots * 16.0 * f4 + cg_iters * (b_blocks + gathers + vectors)
    return flops, bytes_


def schur_step_model(NP: int, NL: int, NB: int, NO: int) -> tuple[float, float]:
    """(flops, bytes) of one exact-Schur GN step (linear_solver="schur").

    Block assembly by segment sums, then the reduced system S = Hpp - W U^T
    as one [3NP, 2NL] x [2NL, 3NP] product, factored densely.
    """
    n = 3 * NP
    m = 2 * NL
    edge_math = NB * 150.0 + NO * 700.0
    outer = NB * 2.0 * (9 + 4 + 6 + 5) + NO * 2.0 * (3 * 9 + 6)
    w = n * NL * 8.0  # U @ blockdiag(Hll_inv), batched 1x2 @ 2x2
    s_mm = 2.0 * n * m * n  # W @ U^T
    chol = n**3 / 3 + 4.0 * n * n
    flops = edge_math + outer + w + s_mm + chol

    f4 = 4.0
    u_w = 2.0 * n * m * f4 * 2.0  # U and W written + read for the product
    s_traffic = 3.0 * n * n * f4  # write S, read for Cholesky, write factor
    edges = (NB * 40 + NO * 60) * f4
    return flops, u_w + s_traffic + edges


def useful_step_flops(
    NP: int, NL: int, NB: int, NO: int, cg_iters: float = 0
) -> float:
    """FLOPs the algorithm needs for one GN step, block-sparse-counted.

    Per-edge residual/Jacobian math, the block outer products (Hpp 3x3 +
    Hll 2x2 + B 3x2 + b terms per bearing edge; 3x3 blocks per odometry
    edge), the per-landmark 2x2 eliminations, and the reduced-system work:
    ``cg_iters`` PCG matvecs when given, else a (3*NP)^3/3 dense Cholesky
    of S.
    """
    edge_math = NB * 150.0 + NO * 700.0
    outer = NB * 2.0 * (9 + 4 + 6 + 5) + NO * 2.0 * (3 * 9 + 6)
    elim = NL * 30.0  # 2x2 inverses + rhs
    if cg_iters > 0:
        matvec = 24.0 * NB + 8.0 * NL + 18.0 * NP + 36.0 * NO + 70.0 * NP
        reduce_ = cg_iters * matvec
    else:
        reduce_ = (3.0 * NP) ** 3 / 3
    return edge_math + outer + elim + reduce_


def roofline_report(
    flops: float, bytes_: float, time_s: float, spec: ChipSpec | None = None
) -> dict:
    """Achieved rates vs the card's peaks; utilization of the binding resource."""
    if spec is None:
        spec = chip_spec()
    fps = flops / time_s
    bps = bytes_ / time_s
    flops_util = fps / spec.peak_flops_f32
    bw_util = bps / spec.hbm_bytes_per_s
    util = max(flops_util, bw_util)
    return {
        "chip": spec.name,
        "achieved_gflops": round(fps / 1e9, 2),
        "achieved_gbps": round(bps / 1e9, 2),
        "flops_util_f32": round(flops_util, 4),
        "flops_util_bf16_peak": round(fps / spec.peak_flops_bf16, 4),
        "hbm_bw_util": round(bw_util, 4),
        "roofline_util": round(util, 4),
        "bound": (
            "latency"
            if util < 0.05
            else ("compute" if flops_util >= bw_util else "bandwidth")
        ),
    }


# ---- the kernels' work, for their bounds (chip_smoke.py) ----


def bound_ms(fmas: float, nbytes: float, spec: ChipSpec) -> tuple[float, str]:
    """Least time in ms for ``fmas`` f32 FMAs (2 flops each) and ``nbytes``
    moved, and which of the two binds ("operations" or "bytes")."""
    t_ops = 2.0 * fmas / spec.peak_flops_f32 * 1e3
    t_bytes = nbytes / spec.hbm_bytes_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cholesky_work(n: int) -> tuple[float, float]:
    """(FMAs, bytes) of an SPD solve of order ``n``: the factorization
    n^3/6 FMAs, two triangular solves n^2/2 each; H and b read, x written."""
    return n**3 / 6 + n * n, 4 * (n * n + 2 * n)


def schur_solve_dense_work(Np: int, Ml: int) -> tuple[float, float]:
    """(FMAs, bytes) of the reduced-system solve counted densely, for
    systems without a graph: W, the lower triangle of W U^T, the rhs, the
    factorization (Np^3/6), the two triangular solves (Np^2/2 each), U^T x
    and the 2x2 block apply.  Bytes: the inputs Hpp, U, Hb [Ml/2,2,2], bp,
    bl, mask, lam; the outputs x, dl."""
    fmas = (2 * Np * Ml + Np * (Np + 1) / 2 * Ml + Np * Ml + Np**3 / 6 + Np * Np + Np * Ml
            + 2 * Ml)
    nbytes = 4 * (Np * Np + Np * Ml + 2 * Ml + 3 * Np + 2 * Ml + 1 + Np + Ml)
    return fmas, nbytes


def dense_step_fmas(Np: int, Ml: int) -> float:
    """FMAs of the dense algorithm's share of a whole step, for scale: the
    lower half of W U^T, the Cholesky and the two solves."""
    return Np * (Np + 1) / 2 * Ml + Np**3 / 6 + Np**2


def schur_solve_work(g) -> tuple[float, float]:
    """(FMAs, bytes) that the reduced-system solve of graph ``g`` needs,
    counted on its envelope.

    FMAs: the landmark elimination per landmark with k distinct observing
    poses (W: 3k x 2, the lower triangle of W U^T: 3k(3k+1)/2 entries of
    2 FMAs, its rhs share), the Cholesky of S over its envelope under the
    pose order (row i with w_i entries left of the diagonal: w_i(w_i+1)/2;
    rows are coupled through odometry and shared landmarks, as
    ``graph.data.first_coupled`` finds them), both substitutions, and dl (U^T
    x over the pairs, the 2x2 block apply).  Bytes: the nonzero inputs
    (Hpp's diagonal and odometry blocks, U's pair blocks, Hll^-1's blocks,
    bp, bl, the mask, lam) and x, dl."""
    from boslam_torch.graph.data import first_coupled

    NP_, NL = g.n_poses, g.n_landmarks
    bp, bl = g.b_pose.cpu().numpy(), g.b_lm.cpu().numpy()
    src, dst = g.o_src.cpu().numpy(), g.o_dst.cpu().numpy()
    pairs = np.unique(bp * NL + bl)
    k = np.bincount(pairs % NL, minlength=NL).astype(np.float64)
    schur = np.sum(3 * k * 2 * 2 + 3 * k * (3 * k + 1) + 3 * k * 2)
    first, _ = first_coupled(g)
    w = ((3 * np.arange(NP_)[:, None] + np.arange(3)) - 3 * first[:, None]).astype(np.float64)
    chol = np.sum(w * (w + 1) / 2) + 2 * np.sum(w + 1)
    fmas = schur + chol + 6 * len(pairs) + 4 * NL
    odo_pairs = len(np.unique(np.minimum(src, dst) * NP_ + np.maximum(src, dst)))
    nbytes = 4 * (9 * NP_ + 18 * odo_pairs + 6 * len(pairs) + 4 * NL + 3 * NP_ + 2 * NL + 3 * NP_
                  + 1 + 3 * NP_ + 2 * NL)
    return float(fmas), float(nbytes)


def gn_step_work(g) -> tuple[float, float]:
    """(FMAs, bytes) that one GN step needs on graph ``g``.

    FMAs: the edge terms (~60 per bearing, ~230 per odometry edge), the
    sums, the reduced-system solve on its envelope (``schur_solve_work``)
    and boxplus.  Bytes: the state in and out, the edges and the stats
    row."""
    NP_, NL, NB, NO = g.n_poses, g.n_landmarks, g.n_bearing, g.n_odometry
    solve, _ = schur_solve_work(g)
    edges = 60 * NB + 230 * NO + 9 * (NB + 2 * NO) + 11 * NB + 9 * NO + 10 * NL
    fmas = edges + solve + 8 * NP_ + 2 * NL
    nbytes = 4 * (2 * (3 * NP_ + 2 * NL) + 4 * NB + 14 * NO + 2 + 8)
    return float(fmas), float(nbytes)


def windowed_take_bytes(R: int, K: int, M: int, C: int) -> float:
    """Bytes of ``values[idx]`` over an [R, K] index grid into [M, C] f32
    values: idx, values and the output, each once (no arithmetic to speak
    of)."""
    return 4 * (R * K + M * C + R * K * C)


def pcg_body_work(NP: int, NL: int, NLV: int, K: int, K2: int, NC: int,
                  split: bool, NLC: int = 0) -> tuple[float, float]:
    """(FMAs, bytes) of one fused block-Jacobi CG body on the packed system
    (``ops/pcg_body.py``) of NP poses with K slots each, NLV landmark rows
    of K2 slots over NL landmarks (``split``: rows mapped to landmarks), NC
    chain edges and NLC loop-closure edges.  FMAs: the 3x2 block products
    of both grids (6 a slot), Hll^-1 per gathered pose slot (4), Hpp and the
    chain's two 3x3 products (27 a pose), M^-1 (9), the three dots and the
    two updates (15), a loop closure's two 3x3 products (18).  Bytes: the
    inputs once (coupling blocks and slot indices, Hpp, M^-1, the chain
    blocks, a loop closure's block and its two poses, Hll^-1, the mask, a
    split grid's row maps, the state read: x, r, p, x_best) and the state
    written (x, r, z, p, x_best)."""
    fmas = 6 * NLV * K2 + 10 * NP * K + 51 * NP + 18 * NLC
    nbytes = 4 * (7 * NP * K + 7 * NLV * K2 + 18 * NP + 9 * NC + 11 * NLC + 4 * NL + NP
                  + (NLV + NL + 1 if split else 0) + 27 * NP)
    return float(fmas), float(nbytes)
