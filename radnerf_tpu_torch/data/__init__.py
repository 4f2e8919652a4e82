"""Host-side data helpers of the port (numpy only)."""

from .rays import get_bg_coords, get_rays

__all__ = ["get_bg_coords", "get_rays"]
