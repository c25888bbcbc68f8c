"""Profiling and timing helpers (port of ``boslam/utils/profiling.py``):
``torch.profiler`` traces, timers bracketed by waits for the card, and a
rough operation count of the dense GN step."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from boslam_torch.device import resolve_device

TRACE_FILE = "boslam_torch_trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace,
    ``log_dir/boslam_torch_trace.json`` (chrome://tracing or Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def timeit(fn: Callable, *args, repeats: int = 5, warmup: int = 1, device=None) -> dict:
    """Wall time of ``fn(*args)``, each call ended by a wait for the card on
    a CUDA ``device`` (the default; pass device="cpu" on the CPU)."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn(*args)
        sync()
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times), "times": times}


def gn_step_flops(n_poses: int, n_landmarks: int, n_bearing: int, n_odom: int) -> int:
    """Rough operation count of one dense-path GN step: the Cholesky
    factorization (N^3/3) dominates at reference size, the edge math at
    large size (the JAX package's formula)."""
    N = 3 * n_poses + 2 * n_landmarks
    edge = n_bearing * 120 + n_odom * 700  # residual + Jacobian + outer products
    chol = N**3 // 3 + 2 * N**2
    return edge + chol
