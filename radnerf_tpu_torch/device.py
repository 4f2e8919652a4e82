"""Device resolution for the port's tensor-creating entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there is
    no usable card. There is no silent fallback to the CPU: a caller who
    wants the CPU says ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
