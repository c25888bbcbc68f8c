"""One block-Jacobi CG iteration on the packed Schur system as one
hand-written CUDA body (``csrc/pcg_body.cu``).

The iteration is ``solver/schur.py`` ``pcg``'s body (``cg_step``) over the
matvec of ``solver/schur_packed.py`` ``packed_s_matvec``, for the systems
whose odometry is a chain prefix and any number of loop-closure edges past
it (listed per pose, ``graph/packed.LoopRows``), whose coupling blocks are
f32 and whose preconditioner is the block-Jacobi 3x3 inverse array.  That
body is the kernel's plain twin (``schur_packed.plain_cg_body``).  ``pcg`` runs
either body when handed it as ``make_body``; on the card the packed
solver hands it the kernel's (``schur_packed.fused_cg_body``).  It
replaces no TPU kernel: the JAX package leaves the body to XLA inside a
``while_loop``.

``PCGSystem`` binds the packed system and the loop's constants once per
``pcg`` call, on a CUDA device.  ``pcg_body(system, s, out)`` runs one
iteration on the state ``s``, the eleven tensors of ``schur.CGState`` in
that order, committed where ``s``'s ``active`` holds and frozen elsewhere,
and writes the new state into ``out`` (the same buffers as ``s`` under a
CUDA graph) or into new tensors; it returns them.  It is four launches,
counted once in ``pcg_body.launches``.  The kernel sums in a fixed order,
so a body repeats to the bit; its sums run in another order than
PyTorch's, so it agrees with the twin to rounding.  A plan whose tiles or
window the kernel cannot read is refused by the kernel (a RuntimeError).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from boslam_torch.graph.packed import LoopRows
from boslam_torch.ops import _build
from boslam_torch.ops.counters import counter
from boslam_torch.ops.windowed_gather import WindowPlan

ROWS = 32  # grid rows a block of the kernel takes (csrc/pcg_body.cu)


@dataclasses.dataclass
class PCGSystem:
    """The packed system and the loop's constants of one ``pcg`` call.

    ``Ho`` holds the odometry couplings: the chain's first (edge e: pose
    e -> e + 1), then the loop closures, which ``loops`` lists per pose
    (None: every row is the chain's) as ``graph/packed.loop_rows`` builds
    and checks it: the kernel reads the list unchecked.  ``mask`` is the
    gauge mask f32[NP, 1], ``Minv`` the block-Jacobi inverses; ``b2`` the
    device scalar |rhs|^2 (clamped) of the loop condition, with ``tol2``,
    ``restarts`` and ``max_iters`` as ``pcg`` takes them.  Checked and
    bound to the kernel's workspace when made."""

    Hpp: torch.Tensor  # [NP, 3, 3]
    Minv: torch.Tensor  # [NP, 3, 3]
    Ho: torch.Tensor  # [NO, 3, 3]
    mask: torch.Tensor  # [NP, 1]
    Hll_inv: torch.Tensor  # [NL, 2, 2]
    Bp: torch.Tensor  # [NP, K, 3, 2]
    p_lm: torch.Tensor  # i32 [NP, K]
    Bl: torch.Tensor  # [NLV, K2, 3, 2]
    l_pose: torch.Tensor  # i32 [NLV, K2]
    l_virt: "torch.Tensor | None"  # i32 [NLV] grid row -> landmark, None: one row each
    p_plan: "WindowPlan | None"
    l_plan: "WindowPlan | None"
    b2: torch.Tensor
    tol2: float
    restarts: int
    max_iters: int
    loops: "LoopRows | None" = None
    kernel: "_Kernel" = dataclasses.field(init=False)

    def __post_init__(self):
        self.kernel = _Kernel(self)


def pcg_body(system: PCGSystem, s, out=None) -> tuple:
    """One CG iteration of the kernel.  ``out`` (default: new tensors) may
    be ``s`` itself."""
    if out is None:
        out = tuple(torch.empty_like(t) for t in s)
    system.kernel.launch(s, out)
    pcg_body.launches += 1
    return tuple(out)


counter(pcg_body, "launches")


# ---------------------------------------------------------------- kernel

_SYSTEM_PTRS = ("hpp", "minv", "ho", "mask", "hll_inv", "bp", "p_lm", "bl", "l_pose",
                "virt_order", "virt_start", "p_starts", "l_starts", "loop_start", "loop_edge",
                "loop_nbr", "b2")
_STATE = ("x", "r", "z", "p", "rz", "rr", "nbrk", "k", "x_best", "rr_best", "active")  # CGState
_WORK = ("zrow", "ap", "xn", "rn", "zn", "part", "snap")
_INTS = ("np", "nl", "nlv", "kp", "kl", "nc", "no", "p_window", "p_tile_rows", "l_window",
         "l_tile_rows", "restarts", "max_iters")


class _Args(ctypes.Structure):
    """Mirror of ``PCGBodyArgs`` in csrc/pcg_body.cu (same field order)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _SYSTEM_PTRS + _STATE]
                + [(n + "_o", ctypes.c_void_p) for n in _STATE]
                + [(n, ctypes.c_void_p) for n in _WORK]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("tol2", ctypes.c_float), ("tiny", ctypes.c_float)])


def _lib():
    lib = _build.load_library("pcg_body")
    fn = lib.boslam_pcg_body
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _state_kinds(NP: int):
    """(shape, dtype) of each state tensor, in ``_STATE``'s order."""
    vec, f32 = ((NP, 3), torch.float32), ((), torch.float32)
    i32 = ((), torch.int32)
    return (vec, vec, vec, vec, f32, f32, i32, i32, vec, f32, ((), torch.bool))


class _Kernel:
    """The CUDA body bound to one system: its arguments and workspace."""

    def __init__(self, S: PCGSystem):
        NP, NL = S.Hpp.shape[0], S.Hll_inv.shape[0]
        NLV, K2 = S.l_pose.shape
        K = S.p_lm.shape[1]
        NO = S.Ho.shape[0]
        NC = NO if S.loops is None else NO - S.loops.edge.shape[0] // 2  # each listed twice
        f32, i32 = torch.float32, torch.int32
        shapes = dict(Hpp=((NP, 3, 3), f32), Minv=((NP, 3, 3), f32),
                      Ho=((NO, 3, 3), f32), mask=((NP, 1), f32),
                      Hll_inv=((NL, 2, 2), f32), Bp=((NP, K, 3, 2), f32),
                      p_lm=((NP, K), i32), Bl=((NLV, K2, 3, 2), f32), l_pose=((NLV, K2), i32),
                      b2=((), f32))
        dev = S.Hpp.device
        if dev.type != "cuda":
            raise ValueError(f"pcg_body: the kernel runs on a CUDA device, not {dev}")
        for name, (shape, dtype) in shapes.items():
            t = getattr(S, name)
            if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(f"pcg_body: {name} must be contiguous {dtype} {shape} on {dev}, "
                                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not 0 <= NC <= NP - 1 or K < 1 or K2 < 1:
            raise ValueError(f"pcg_body: {NC} chain edges of {NO}, slots {K}, {K2} "
                             f"for {NP} poses")
        if S.loops is not None:
            n = S.loops.edge.shape[0]
            for name, t, shape in (("start", S.loops.start, (NP + 1,)),
                                   ("edge", S.loops.edge, (n,)), ("nbr", S.loops.nbr, (n,))):
                if (tuple(t.shape) != shape or t.dtype != i32 or t.device != dev
                        or not t.is_contiguous()):
                    raise ValueError(f"pcg_body: loop rows' {name} must be contiguous {i32} "
                                     f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} "
                                     f"on {t.device}")
        for plan, rows in ((S.p_plan, NP), (S.l_plan, NLV)):
            if plan is not None and (plan.starts.dtype != i32 or plan.starts.device != dev
                                     or plan.starts.dim() != 1 or plan.tile_rows < 1
                                     or plan.n_tiles != -(-rows // plan.tile_rows)):
                raise ValueError(f"pcg_body: a plan of {tuple(plan.starts.shape)} "
                                 f"{plan.starts.dtype} starts on {plan.starts.device} and "
                                 f"tile_rows {plan.tile_rows} for {rows} rows")
        keep = dict(hpp=S.Hpp, minv=S.Minv, ho=S.Ho, mask=S.mask, hll_inv=S.Hll_inv, bp=S.Bp,
                    p_lm=S.p_lm, bl=S.Bl, l_pose=S.l_pose, b2=S.b2)
        if S.l_virt is not None:
            if tuple(S.l_virt.shape) != (NLV,):
                raise ValueError(f"pcg_body: l_virt of shape {tuple(S.l_virt.shape)}, {NLV} rows")
            # landmark l's rows are virt_order[virt_start[l]:virt_start[l + 1]]
            # (index_add, not bincount: nothing waits for the card)
            lv = S.l_virt.long()
            keep["virt_order"] = torch.argsort(lv, stable=True).to(i32)
            start = torch.zeros(NL + 1, dtype=torch.int64, device=dev)
            start[1:] = torch.cumsum(torch.zeros(NL, dtype=torch.int64, device=dev)
                                     .index_add_(0, lv, torch.ones_like(lv)), 0)
            keep["virt_start"] = start.to(i32)
        elif NLV != NL:
            raise ValueError(f"pcg_body: {NLV} landmark rows for {NL} landmarks and no l_virt")
        for name, plan in (("p_starts", S.p_plan), ("l_starts", S.l_plan)):
            if plan is not None:
                keep[name] = plan.starts
        if S.loops is not None:
            keep.update(loop_start=S.loops.start, loop_edge=S.loops.edge, loop_nbr=S.loops.nbr)
        blocks = -(-NP // ROWS) + 2 * -(-NP // 256)
        keep.update(zrow=torch.empty((NLV, 2), dtype=f32, device=dev),
                    **{n: torch.empty((NP, 3), dtype=f32, device=dev)
                       for n in ("ap", "xn", "rn", "zn")},
                    part=torch.empty(blocks, dtype=f32, device=dev),
                    snap=torch.empty(8, dtype=f32, device=dev))
        self._keep = keep  # the struct holds raw pointers: keep the tensors alive
        self._kinds = _state_kinds(NP)
        self.device = dev
        self._lib = _lib()
        self._args = _Args(
            **{n: t.data_ptr() for n, t in keep.items()},
            np=NP, nl=NL, nlv=NLV, kp=K, kl=K2, nc=NC, no=NO,
            p_window=S.p_plan.window if S.p_plan else 0,
            p_tile_rows=S.p_plan.tile_rows if S.p_plan else 0,
            l_window=S.l_plan.window if S.l_plan else 0,
            l_tile_rows=S.l_plan.tile_rows if S.l_plan else 0,
            restarts=S.restarts, max_iters=S.max_iters, tol2=S.tol2,
            tiny=torch.finfo(f32).tiny)

    def launch(self, s, out) -> None:
        for name, t_in, t_out, (shape, dtype) in zip(_STATE, s, out, self._kinds):
            for t in (t_in, t_out):
                if (tuple(t.shape) != shape or t.dtype != dtype or t.device != self.device
                        or not t.is_contiguous()):
                    raise ValueError(f"pcg_body: state {name} must be contiguous {dtype} {shape} "
                                     f"on {self.device}, got {t.dtype} {tuple(t.shape)} "
                                     f"on {t.device}")
            setattr(self._args, name, t_in.data_ptr())
            setattr(self._args, name + "_o", t_out.data_ptr())
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.boslam_pcg_body(ctypes.byref(self._args), stream)
        _build.check(self._lib, err, "pcg_body")
