"""Device policy for the port's entry points: the CUDA card unless the
caller names another device. There is no silent CPU fallback — asking
for the card on a machine without one raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. A CUDA device that is not present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly "
            "to run on the CPU")
    return dev
