"""The bench scene, built in the port (a copy of ``bench.py:build_scene``),
and the sparse two-blob scene of the two-level march's benchmark
(``build_sparse_scene``).

A converged-head-style occupancy (rough ellipsoid cranium + neck column,
opaque interior at sigma 300) in the density grid, a shoulders-shaped torso
mask, the camera at the reference's working distance (z = -3.3), an audio
window stream, and bench.py's render settings: grid 128, max_steps 16,
dt_gamma 1/256 (an affine orbit, since dt_min == dt_max), cull_T 1e-4.

The model is ``NetworkConfig(torso=True, exp_eye=True)`` at its shipped
widths, in float32. Its weights are drawn from a numpy seed
(``random_weights``): He-uniform U(+-sqrt(6/fan_in)) for every weight
matrix, PyTorch's default uniform for the biases, individual codes
N(0, 0.1), and the three grid tables U(-4, 4) instead of the
trained-from-scratch U(-1e-4, 1e-4). With small tables, or PyTorch's
default U(+-1/sqrt(fan_in)) weights that shrink the signal through each
ReLU layer, the density stays near exp(0) = 1 and the head composites to
weights_sum < 0.1; this draw spreads log-density over about +-3 (1st-99th
percentile) and gives a head with opaque patches (weights_sum up to ~0.99
at 64x64 on the CPU).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .data.rays import get_bg_coords, get_rays
from .device import resolve_device
from .models.network import NeRFNetwork, NetworkConfig
from .models.renderer import RenderConfig, make_state
from .ops.morton import morton3d_invert

GRID_TABLES = ("encoder", "encoder_ambient", "torso_encoder")


@torch.no_grad()
def random_weights(net: NeRFNetwork, seed: int = 0):
    """Redraw every parameter of ``net`` from ``np.random.default_rng(seed)``
    (see the module note for the distributions)."""
    rng = np.random.default_rng(seed)
    for name, p in net.named_parameters():
        if name in GRID_TABLES:
            v = rng.uniform(-4.0, 4.0, p.shape)
        elif name.startswith("individual_codes"):
            v = rng.normal(0.0, 0.1, p.shape)
        elif p.dim() > 1:  # He-uniform: keeps the scale through ReLU layers
            b = math.sqrt(6.0 / math.prod(p.shape[1:]))
            v = rng.uniform(-b, b, p.shape)
        else:  # a bias: PyTorch's default, 1/sqrt(fan_in of its weight)
            w = net.get_parameter(name.rsplit(".", 1)[0] + ".weight")
            b = 1.0 / math.sqrt(math.prod(w.shape[1:]))
            v = rng.uniform(-b, b, p.shape)
        p.copy_(torch.from_numpy(v.astype(np.float32)))


def build_scene(H_img: int = 512, W_img: int = 512, device="cuda", seed: int = 0):
    """Returns (net, render_cfg, state, batch, aud_stream): the batch holds
    rays_o, rays_d, bg_coords [N, 2], poses [1, 6], eye [1, 1], index and
    bg_color [N, 3]; aud_stream is [64, 8, 44, 16] (one window per frame)."""
    dev = resolve_device(device)
    net_cfg = NetworkConfig(torso=True, exp_eye=True)
    rc = RenderConfig(torso=True, max_steps=16, dt_gamma=1.0 / 256,
                      cull_T=1e-4)
    net = NeRFNetwork(net_cfg, device=dev)
    random_weights(net, seed)

    G = rc.grid_size
    coords = morton3d_invert(torch.arange(G**3)).numpy()
    xyz = 2.0 * coords.astype(np.float32) / (G - 1) - 1.0
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rng = np.random.default_rng(7)
    rough = np.zeros_like(x)
    for _ in range(6):  # smooth band-limited boundary noise, ~10% amplitude
        f = rng.uniform(2.0, 6.0, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        rough += np.cos(f[0] * x + ph[0]) * np.cos(f[1] * y + ph[1]) \
            * np.cos(f[2] * z + ph[2])
    rough *= 0.06
    head = ((x / 0.33) ** 2 + ((y - 0.12) / 0.44) ** 2 + (z / 0.37) ** 2 < (1.0 + rough))
    neck = (x**2 + z**2 < (0.16 + 0.3 * rough) ** 2) & (y < -0.15) & (y > -0.75)
    occ = (head | neck).astype(np.float32) * 300.0
    gy, gx = np.meshgrid(np.linspace(-1, 1, G), np.linspace(-1, 1, G), indexing="ij")
    half_w = 0.22 + 0.55 * np.clip(-(gy + 0.05), 0, 1)
    torso_mask = (np.abs(gx) < half_w) & (gy < 0.05)
    state = make_state(
        rc, torch.from_numpy(occ[None]).to(dev),
        torch.from_numpy(torso_mask.astype(np.float32).reshape(-1) * 0.5).to(dev),
        mean_density=float(occ.mean()), mean_density_torso=0.05, thresh=5.0)

    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -3.3]
    focal = 1200.0 * H_img / 450.0
    rays = get_rays(pose, (focal, focal, W_img / 2, H_img / 2), H_img, W_img, -1)
    n = H_img * W_img
    batch = {
        "rays_o": torch.from_numpy(rays["rays_o"]).to(dev),
        "rays_d": torch.from_numpy(rays["rays_d"]).to(dev),
        "bg_coords": torch.from_numpy(get_bg_coords(H_img, W_img)).to(dev),
        "poses": torch.zeros((1, 6), device=dev),
        "eye": torch.full((1, 1), 0.25, device=dev),
        "index": torch.zeros((), dtype=torch.int64, device=dev),
        "bg_color": torch.full((n, 3), 0.5, device=dev),
    }
    aud = np.random.default_rng(0).normal(size=(64, 8, 44, 16)).astype(np.float32)
    return net, rc, state, batch, torch.from_numpy(aud).to(dev)


def build_sparse_scene(H_img: int = 512, W_img: int = 512, device="cuda", seed: int = 0):
    """The scene the JAX package's two-level-march benchmark renders (a copy
    of ``scripts/bench_march_group.py:build_sparse_scene``): two balls of
    density 300 and radius 0.18 at +-(0.7, 0.35, 0.7) on the 128^3 grid
    (occupancy threshold 5), so the occupied box spans nearly the cube and
    ~97% of the marched orbit is empty; the head alone
    (``NetworkConfig(torso=False, exp_eye=True)``, float32, ``random_weights``),
    max_steps 16, dt_gamma 0, the camera at z = -3.3 with focal 700 * H / 450.
    Returns what ``build_scene`` returns."""
    dev = resolve_device(device)
    net = NeRFNetwork(NetworkConfig(torso=False, exp_eye=True), device=dev)
    random_weights(net, seed)
    rc = RenderConfig(torso=False, max_steps=16, dt_gamma=0.0)
    G = rc.grid_size
    coords = morton3d_invert(torch.arange(G**3)).numpy()
    xyz = 2.0 * coords.astype(np.float32) / (G - 1) - 1.0
    occ = np.zeros((G**3,), np.float32)
    for c in ([-0.7, -0.35, -0.7], [0.7, 0.35, 0.7]):
        occ = np.maximum(occ, (np.linalg.norm(xyz - np.asarray(c), axis=-1) < 0.18) * 300.0)
    state = make_state(rc, torch.from_numpy(occ[None]).to(dev),
                       torch.zeros((G * G,), device=dev), mean_density=float(occ.mean()),
                       mean_density_torso=0.0, thresh=5.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -3.3]
    focal = 700.0 * H_img / 450.0
    rays = get_rays(pose, (focal, focal, W_img / 2, H_img / 2), H_img, W_img, -1)
    n = H_img * W_img
    batch = {
        "rays_o": torch.from_numpy(rays["rays_o"]).to(dev),
        "rays_d": torch.from_numpy(rays["rays_d"]).to(dev),
        "bg_coords": torch.from_numpy(get_bg_coords(H_img, W_img)).to(dev),
        "poses": torch.zeros((1, 6), device=dev),
        "eye": torch.full((1, 1), 0.25, device=dev),
        "index": torch.zeros((), dtype=torch.int64, device=dev),
        "bg_color": torch.full((n, 3), 0.5, device=dev),
    }
    aud = np.random.default_rng(0).normal(size=(8, 8, 44, 16)).astype(np.float32)
    return net, rc, state, batch, torch.from_numpy(aud).to(dev)
