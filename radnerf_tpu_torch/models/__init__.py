"""Model layer of the port: the audio-conditioned field, the renderer and
the maintenance of the head and torso grids."""

from .frame_graph import graph_stats, reset_graph_stats
from .network import NeRFNetwork, NetworkConfig, param_groups
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
    mark_untrained_grid,
    render_rays,
    reset_extra_state,
    smooth_audio_code,
    update_density_grid,
    update_torso_grid,
)

__all__ = [
    "NeRFNetwork",
    "NetworkConfig",
    "param_groups",
    "GRID_SIZE",
    "RenderConfig",
    "RendererState",
    "bilinear_sample_2d",
    "compute_occ_bbox",
    "compute_occ_sphere",
    "field_on_lattice",
    "graph_stats",
    "make_state",
    "march_window",
    "mark_untrained_grid",
    "render_rays",
    "reset_extra_state",
    "reset_graph_stats",
    "smooth_audio_code",
    "update_density_grid",
    "update_torso_grid",
]
