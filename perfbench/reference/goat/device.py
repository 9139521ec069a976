"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The torch.device for `device`; raises when it names a CUDA device
    and no card is present, so nothing falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
