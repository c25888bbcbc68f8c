"""Device selection for the port's entry points, and the one gate for
waits on the card.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  A
request for CUDA on a machine without it raises: the port never carries on
on the CPU when the card was asked for.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def host_sync(device):
    """Let the host wait for the card inside the block.

    The solve paths run under CUDA sync-debug mode "error" in
    ``chip_smoke.py``, which makes any wait for the card raise.  The few
    waits a path needs by design (the once-per-solve host packing, the CG
    loop's polls) are made inside this block, which lifts the mode and
    restores it after.  On the CPU it does nothing.
    """
    if torch.device(device).type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
