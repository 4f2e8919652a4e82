"""sRGB <-> linear colour conversion (counterpart of
``radnerf_tpu/utils/color.py``; reference nerf/utils.py:77-84)."""

from __future__ import annotations

import torch


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.0031308, 12.92 * x, 1.055 * x**0.41666 - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
