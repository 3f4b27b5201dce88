"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device where there is no
    card, so an entry point never drops to the CPU unasked."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return d
