"""Auxiliary sampling ops: background-sphere coordinates and hierarchical
PDF sampling.

Counterpart of ``radnerf_tpu/ops/sampling.py``: ``sph_from_ray``
(reference raymarching.cu:162-209) and ``sample_pdf`` (reference
nerf/renderer.py:13-47, the classic NeRF hierarchical sampler). Neither is
on a pipeline path; both are plain PyTorch.
"""

from __future__ import annotations

import math

import torch


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """Far intersection of rays [..., 3] with the background sphere of
    ``radius`` -> (theta, phi) [..., 2] in [-1, 1]. Assumes origins inside
    the sphere."""
    # the positive root of |o + t d|^2 = r^2
    b = torch.sum(rays_o * rays_d, dim=-1)
    c = torch.sum(rays_o * rays_o, dim=-1) - radius * radius
    t = -b + torch.sqrt(torch.clamp_min(b * b - c, 0.0))
    p = rays_o + t[..., None] * rays_d
    theta = torch.atan2(torch.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2), p[..., 1]) / math.pi
    phi = torch.atan2(p[..., 0], p[..., 2]) / math.pi
    return torch.stack([2.0 * theta - 1.0, phi], dim=-1)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int, det: bool = False,
               generator: torch.Generator | None = None,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling of new depths from bin weights: bins [B, T],
    weights [B, T-1] -> [B, n_samples].

    ``det`` takes the evenly spaced quantiles; otherwise the quantiles are
    ``u`` [B, n_samples] where given, else drawn U[0, 1) from ``generator``
    (JAX draws them from a PRNG key: the two give different numbers)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, T]

    B, T = cdf.shape
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device).expand(B, n_samples)
    elif u is None:
        u = torch.rand((B, n_samples), generator=generator, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, T - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    last = bins.shape[-1] - 1
    bins_b = torch.gather(bins, 1, torch.clamp_max(below, last))
    bins_a = torch.gather(bins, 1, torch.clamp_max(above, last))

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
