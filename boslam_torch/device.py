"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  A
request for CUDA on a machine without it raises: the port never carries on
on the CPU when the card was asked for.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
