"""Compute ops of the port: encoders, marcher, compositor, Morton codes.

``grid_encode``, ``march_rays`` and ``composite_rays`` wrap the hand-written
CUDA kernels A, B and C; each has a plain PyTorch twin (``*_plain``) that
the wrapper runs for CPU tensors.
"""

from .activation import trunc_exp
from .freq_encode import freq_encode, freq_output_dim
from .grid_encode import GridSpec, grid_encode, grid_encode_plain
from .marching import (
    MarchConfig,
    build_sigma_bytes,
    composite_rays,
    composite_rays_plain,
    dequant_sigma,
    march_rays,
    march_rays_plain,
)
from .morton import morton3d, morton3d_invert, packbits
from .ray_aabb import near_far_from_aabb
from .sh_encode import sh_encode, sh_output_dim

__all__ = [
    "trunc_exp",
    "freq_encode",
    "freq_output_dim",
    "GridSpec",
    "grid_encode",
    "grid_encode_plain",
    "MarchConfig",
    "build_sigma_bytes",
    "composite_rays",
    "composite_rays_plain",
    "dequant_sigma",
    "march_rays",
    "march_rays_plain",
    "morton3d",
    "morton3d_invert",
    "packbits",
    "near_far_from_aabb",
    "sh_encode",
    "sh_output_dim",
]
