"""Model layer of the port: the audio-conditioned field and the renderer."""

from .network import NeRFNetwork, NetworkConfig
from .renderer import (
    GRID_SIZE,
    RenderConfig,
    RendererState,
    bilinear_sample_2d,
    compute_occ_bbox,
    compute_occ_sphere,
    field_on_lattice,
    make_state,
    march_window,
    render_rays,
    smooth_audio_code,
)

__all__ = [
    "NeRFNetwork",
    "NetworkConfig",
    "GRID_SIZE",
    "RenderConfig",
    "RendererState",
    "bilinear_sample_2d",
    "compute_occ_bbox",
    "compute_occ_sphere",
    "field_on_lattice",
    "make_state",
    "march_window",
    "render_rays",
    "smooth_audio_code",
]
