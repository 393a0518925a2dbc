"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Asking for
the card when none is present raises: nothing falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
