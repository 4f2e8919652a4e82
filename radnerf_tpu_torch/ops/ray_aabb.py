"""Ray/AABB slab intersection (counterpart of ``radnerf_tpu/ops/ray_aabb.py``).

Per-axis slab test; rays that miss get near = far = FLT_MAX, near is clamped
up to ``min_near``.
"""

from __future__ import annotations

import torch

FLT_MAX = 3.4028234663852886e38  # float32 max


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.05):
    """rays_o, rays_d: [..., 3] float32; aabb: [6] (xmin, ymin, zmin, xmax,
    ymax, zmax). Returns (nears, fars) [...]; FLT_MAX where the ray misses."""
    rd = 1.0 / rays_d  # inf on zero components is fine (IEEE slab test)
    t0 = (aabb[:3] - rays_o) * rd
    t1 = (aabb[3:] - rays_o) * rd
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = near.clamp_min(min_near)
    big = torch.full_like(near, FLT_MAX)
    return torch.where(miss, big, near), torch.where(miss, big, far)
