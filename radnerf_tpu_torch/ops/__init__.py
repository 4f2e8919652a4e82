"""Compute ops of the port: encoders, marcher, compositor, row gather,
rasterizer, Morton codes.

``grid_encode``, ``march_rays``, ``composite_rays``, ``take_rows`` and
``rasterize`` wrap the hand-written CUDA kernels A, B, C, D and E, and
``triplane_encode`` (ER-NeRF's three plane encodes in one launch) kernel
A-tri; the gradients of the first and
third are kernels A' and C' (``grid_encode_backward``,
``composite_rays_backward``); ``pack_table`` wraps A-bf16's packing pass;
``march_rays`` with a bitfield runs B-bitfield, and ``march_rays_grouped``
(the two-level march over ``build_coarse_bytes``) B-grouped. Each has a plain PyTorch version (``*_plain``)
that the wrapper runs for CPU tensors. ``grid_total_variation``,
``sph_from_ray``, ``sample_pdf`` and the factory ``get_encoder`` are plain
PyTorch.
"""

from .activation import trunc_exp
from .encoding import get_encoder
from .freq_encode import freq_encode, freq_output_dim
from .grid_encode import (
    GridSpec,
    grid_encode,
    grid_encode_backward,
    grid_encode_backward_plain,
    grid_encode_plain,
    grid_total_variation,
    pack_table,
    pack_table_plain,
)
from .marching import (
    MarchConfig,
    build_coarse_bytes,
    build_sigma_bytes,
    composite_rays,
    composite_rays_backward,
    composite_rays_backward_plain,
    composite_rays_plain,
    dequant_sigma,
    grouped_march_qualifies,
    march_rays,
    march_rays_grouped,
    march_rays_grouped_plain,
    march_rays_plain,
    occupancy_lookup,
)
from .morton import morton3d, morton3d_invert, morton_dilate, packbits, unpackbits
from .ray_aabb import near_far_from_aabb
from .rasterize import rasterize, rasterize_plain
from .rowgather import bench_gather_study, take_rows, take_rows_plain
from .sampling import sample_pdf, sph_from_ray
from .sh_encode import sh_encode, sh_output_dim
from .triplane_encode import triplane_encode, triplane_encode_plain

__all__ = [
    "trunc_exp",
    "get_encoder",
    "freq_encode",
    "freq_output_dim",
    "GridSpec",
    "grid_encode",
    "grid_encode_backward",
    "grid_encode_backward_plain",
    "grid_encode_plain",
    "grid_total_variation",
    "pack_table",
    "pack_table_plain",
    "MarchConfig",
    "build_coarse_bytes",
    "build_sigma_bytes",
    "composite_rays",
    "composite_rays_backward",
    "composite_rays_backward_plain",
    "composite_rays_plain",
    "dequant_sigma",
    "grouped_march_qualifies",
    "march_rays",
    "march_rays_grouped",
    "march_rays_grouped_plain",
    "march_rays_plain",
    "occupancy_lookup",
    "morton3d",
    "morton3d_invert",
    "morton_dilate",
    "packbits",
    "unpackbits",
    "near_far_from_aabb",
    "rasterize",
    "rasterize_plain",
    "bench_gather_study",
    "take_rows",
    "take_rows_plain",
    "sample_pdf",
    "sph_from_ray",
    "sh_encode",
    "sh_output_dim",
    "triplane_encode",
    "triplane_encode_plain",
]
