"""Windowed gather: the port of ``boslam/ops/windowed_gather.py``.

After landmarks are relabeled by mean observing pose (``graph/reorder.py``)
every tile of ``tile_rows`` consecutive rows of a slot grid indexes a
narrow window of the value array.  ``windowed_take`` gathers
``values[idx]`` through one window per row tile: in-window indices give
their value rows, every other index (padding, -1, out of window) exact
zeros.

``plan_windows`` is the JAX package's host planner, copied: numpy at pack
time, the same ``starts``, ``window`` and ``tile_rows``, or ``None`` when
the windows would be wider than ``max_window`` (the caller then gathers
plainly; that is the JAX package's per-grid design).

``windowed_take`` launches the hand-written CUDA kernel
(``csrc/windowed_gather.cu``, one thread per slot) for a CUDA tensor and
runs the plain PyTorch version, ``windowed_take_plain``, for a CPU tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boslam_torch.ops import _build

CHANNELS = (2, 3, 4)  # value widths the kernel takes


@dataclasses.dataclass
class WindowPlan:
    """Plan for one slot grid, built once at pack time.

    ``starts`` i32[n_tiles]: first value row of each row tile's window, on
    the graph's device.  ``window`` and ``tile_rows`` are host ints.
    """

    starts: torch.Tensor
    window: int
    tile_rows: int

    @property
    def n_tiles(self) -> int:
        return self.starts.shape[0]


def plan_windows(idx, valid, n_values: int, tile_rows: int = 256, max_window: int = 1024,
                 device=None) -> "WindowPlan | None":
    """A WindowPlan for an [R, K] index grid, or None if the windows would
    be too wide (over ``max_window``).

    ``valid`` masks the padding slots, whose indices are ignored.  The
    window is clamped to the 128-padded value count; 128-row tiles are tried
    when ``tile_rows`` fails.  ``starts`` goes to ``device`` (default CPU).
    """
    idx = np.asarray(idx)
    valid = np.asarray(valid)
    full = max(128, ((n_values + 127) // 128) * 128)
    for T in dict.fromkeys((tile_rows, 128)):
        plan = _plan_one(idx, valid, n_values, T, min(max_window, full), device)
        if plan is not None:
            return plan
    return None


def _plan_one(idx, valid, n_values, tile_rows, max_window, device):
    R = idx.shape[0]
    n_tiles = max(1, -(-R // tile_rows))
    starts = np.zeros(n_tiles, np.int32)
    span_max = 1
    for t in range(n_tiles):
        sl = slice(t * tile_rows, min(R, (t + 1) * tile_rows))
        v = valid[sl]
        if not v.any():
            starts[t] = 0
            continue
        ix = idx[sl][v]
        lo, hi = int(ix.min()), int(ix.max())
        starts[t] = lo
        span_max = max(span_max, hi - lo + 1)
    window = min(
        max(128, ((span_max + 127) // 128) * 128),
        max(128, ((n_values + 127) // 128) * 128),
    )
    if window > max_window:
        return None
    # windows stay inside the value array; rows past it read as zero
    starts = np.clip(starts, 0, max(0, n_values - window)).astype(np.int32)
    return WindowPlan(starts=torch.as_tensor(starts, device=device), window=window,
                      tile_rows=tile_rows)


def windowed_take_plain(values: torch.Tensor, idx: torch.Tensor, plan: WindowPlan) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: a window mask,
    a clamped index and ``torch.where``."""
    M = values.shape[0]
    R = idx.shape[0]
    start = plan.starts.to(idx.dtype).repeat_interleave(plan.tile_rows)[:R, None]
    j = idx - start
    inwin = (j >= 0) & (j < plan.window) & (idx < M)
    out = values[torch.where(inwin, idx, torch.zeros_like(idx))]
    return torch.where(inwin[..., None], out, torch.zeros_like(out))


def _check(values, idx, plan) -> None:
    if values.dtype != torch.float32 or values.dim() != 2 or values.shape[1] not in CHANNELS:
        raise ValueError(f"values must be f32 [M, C] with C in {CHANNELS}, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"idx must be i32 [R, K], got {idx.dtype} {tuple(idx.shape)}")
    st = plan.starts
    if st.dtype != torch.int32 or st.dim() != 1:
        raise ValueError(f"plan.starts must be i32 [n_tiles], got {st.dtype} {tuple(st.shape)}")
    if any(t.device != values.device for t in (idx, st)):
        raise ValueError("values, idx and plan.starts must be on one device")
    n_tiles = max(1, -(-idx.shape[0] // plan.tile_rows))
    if st.shape[0] != n_tiles or not 1 <= plan.window <= 1024 or plan.tile_rows < 1:
        raise ValueError(f"plan ({st.shape[0]} tiles, window {plan.window}, tile_rows "
                         f"{plan.tile_rows}) does not fit {idx.shape[0]} rows")
    if not (values.is_contiguous() and idx.is_contiguous() and st.is_contiguous()):
        raise ValueError("values, idx and plan.starts must be contiguous")


def windowed_take(values: torch.Tensor, idx: torch.Tensor, plan: WindowPlan) -> torch.Tensor:
    """values f32[M, C] taken at idx i32[R, K] -> f32[R, K, C].

    ``values[idx]`` for in-window indices, exact zeros for the others.
    """
    _check(values, idx, plan)
    if not values.is_cuda:
        return windowed_take_plain(values, idx, plan)
    (M, C), (R, K) = values.shape, idx.shape
    if C != 3 and values.data_ptr() % (4 * C):
        raise ValueError(f"values must be {4 * C}-byte aligned for C = {C} (one vector load)")
    lib = _lib()
    out = torch.empty((R, K, C), dtype=values.dtype, device=values.device)
    p = _build.ptr
    err = lib.boslam_windowed_take(
        p(values), M, C, p(idx), R, K, p(plan.starts), plan.window, plan.tile_rows, p(out),
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    windowed_take.launches += 1
    _build.check(lib, err, "windowed_take")
    return out


windowed_take.launches = 0


def _lib():
    import ctypes

    lib = _build.load_library("windowed_gather")
    fn = lib.boslam_windowed_take
    if fn.argtypes is None:
        i, v = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [v, i, i, v, i, i, v, i, i, v, v]
        fn.restype = ctypes.c_int
    return lib
