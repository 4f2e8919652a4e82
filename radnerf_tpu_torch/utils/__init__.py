"""Small helpers of the port."""

from .color import linear_to_srgb, srgb_to_linear

__all__ = ["linear_to_srgb", "srgb_to_linear"]
