"""The inputs the benchmark makes from a seed and hands to both the program
and the reference: the avatar's occupancy and torso grids, a pose track,
procedural training frames, landmarks and audio features.

The avatar is a frozen copy of ``radnerf_tpu_torch/scene.py``
``build_scene``'s recipe at commit 2a619bf24d8171cdad65a8fd4e01bbb8c7f3f0f8:
a rough ellipsoid cranium and a neck column at density 300 on the 128^3
grid (the boundary noise drawn from numpy seed 7, as there), a
shoulders-shaped torso mask at 0.5, the camera at z = -3.3 with focal
1200 * H / 450. It is made on the device in float32 (the original does it
in numpy float64: a cell or two on the boundary can differ, and both
sides get the same grid). It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import data as rdata
from .ops import morton3d_invert

CAMERA_Z = -3.3


def avatar_grids(device, G: int = 128):
    """(density grid [1, G^3] Morton order, torso grid [G*G])."""
    coords = morton3d_invert(torch.arange(G**3, device=device))
    xyz = 2.0 * coords.float() / (G - 1) - 1.0
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rng = np.random.default_rng(7)
    rough = torch.zeros_like(x)
    for _ in range(6):
        f = rng.uniform(2.0, 6.0, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        rough += torch.cos(float(f[0]) * x + float(ph[0])) * torch.cos(float(f[1]) * y + float(ph[1])) \
            * torch.cos(float(f[2]) * z + float(ph[2]))
    rough *= 0.06
    head = (x / 0.33) ** 2 + ((y - 0.12) / 0.44) ** 2 + (z / 0.37) ** 2 < (1.0 + rough)
    neck = (x**2 + z**2 < (0.16 + 0.3 * rough) ** 2) & (y < -0.15) & (y > -0.75)
    occ = (head | neck).float() * 300.0
    lin = torch.linspace(-1, 1, G, device=device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    half_w = 0.22 + 0.55 * torch.clamp(-(gy + 0.05), 0, 1)
    torso = ((gx.abs() < half_w) & (gy < 0.05)).float().reshape(-1) * 0.5
    return occ[None], torso


def _rot(angles):
    """XYZ Euler angles (radians) -> a 3x3 rotation."""
    a, b, c = angles
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    return rx @ ry @ rz


def track(n: int, amp_deg, amp_t, cycles, scale: float):
    """A head's small smooth motion about the bench camera, as ``n``
    transform matrices (the program's own convention, ``nerf_matrix_to_ngp``
    of each is the camera in NGP space): the camera orbits the head by the
    three angles and moves by the translation, each a sine of its own whole
    number of cycles over the track (``cycles``: six numbers), so the track
    closes on itself."""
    out = []
    for i in range(n):
        ph = 2.0 * math.pi * i / n
        ang = [math.radians(amp_deg[k]) * math.sin(cycles[k] * ph) for k in range(3)]
        tr = [amp_t[k] * math.sin(cycles[3 + k] * ph + 0.5) for k in range(3)]
        R = _rot(ang)
        P = np.eye(4)
        P[:3, :3] = R
        P[:3, 3] = R @ np.array([0.0, 0.0, CAMERA_Z]) + np.array(tr)
        out.append(rdata.ngp_to_nerf_matrix(P, scale))
    return out


def procedural_frames(n: int, H: int, W: int, seed: int, device):
    """``n`` frames uint8 [n, H, W, 3] and RGBA torso plates [n, H, W, 4]
    and a background uint8 [H, W, 3]: a face-like ellipse over the
    background with smooth colour waves, each frame its own, from ``seed``
    on the device."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    r = torch.rand((n, 16), generator=gen, device=device)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, H, device=device),
                            torch.linspace(-1, 1, W, device=device), indexing="ij")
    bg = torch.stack([0.4 + 0.2 * torch.sin(3 * xx), 0.45 + 0.2 * torch.cos(2 * yy),
                      0.5 + 0.1 * torch.sin(xx + yy)], -1)
    frames, plates = [], []
    for i in range(n):
        a = r[i]
        cx, cy = 0.1 * (a[0] - 0.5), 0.1 * (a[1] - 0.5)
        face = (((xx - cx) / 0.36) ** 2 + ((yy - cy + 0.05) / 0.5) ** 2 < 1.0).float()[..., None]
        tex = torch.stack([0.7 + 0.15 * torch.sin((4 + 4 * a[2]) * xx + 6 * a[3]),
                           0.55 + 0.15 * torch.sin((4 + 4 * a[4]) * yy + 6 * a[5]),
                           0.45 + 0.1 * torch.cos((3 + 3 * a[6]) * (xx + yy) + 6 * a[7])], -1)
        shoulders = ((xx.abs() < 0.25 + 0.6 * torch.clamp(yy - 0.45, 0, 1)) & (yy > 0.45)).float()
        plate = torch.cat([torch.stack([0.2 + 0.3 * a[8] + 0 * xx, 0.25 + 0.3 * a[9] + 0 * xx,
                                        0.3 + 0.3 * a[10] + 0 * xx], -1), shoulders[..., None]],
                          -1)
        under = plate[..., :3] * plate[..., 3:] + bg * (1 - plate[..., 3:])
        frames.append(face * tex + (1 - face) * under)
        plates.append(plate)

    def u8(v):
        return torch.clamp(torch.round(v * 255.0), 0, 255).to(torch.uint8).cpu().numpy()

    return u8(torch.stack(frames)), u8(torch.stack(plates)), u8(bg)


def landmarks(n: int, H: int, seed: int) -> np.ndarray:
    """68 landmarks a frame in the frame's middle, [n, 68, 2]."""
    return np.random.default_rng(seed).uniform(0.3 * H, 0.7 * H, (n, 68, 2))
