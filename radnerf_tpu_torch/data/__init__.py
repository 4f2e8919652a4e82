"""Host-side data helpers of the port (numpy only)."""

from .rays import convert_poses, get_audio_features, get_bg_coords, get_rays

__all__ = ["convert_poses", "get_audio_features", "get_bg_coords", "get_rays"]
