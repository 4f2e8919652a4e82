"""Ray generation (a copy of ``radnerf_tpu/data/rays.py`` get_rays and
get_bg_coords; numpy only, reference nerf/utils.py:239-333)."""

from __future__ import annotations

import numpy as np


def get_bg_coords(H: int, W: int) -> np.ndarray:
    """[H*W, 2] pixel coords in [-1, 1] (utils.py:239-245; row-major, coord0
    follows the row/H axis)."""
    X = np.arange(H, dtype=np.float32) / (H - 1) * 2 - 1
    Y = np.arange(W, dtype=np.float32) / (W - 1) * 2 - 1
    xs, ys = np.meshgrid(X, Y, indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)


def get_rays(
    pose: np.ndarray,
    intrinsics,
    H: int,
    W: int,
    num_rays: int = -1,
    patch_size: int = 1,
    rect=None,
    rng: np.random.Generator | None = None,
):
    """Generate rays for one camera (utils.py:248-333).

    Modes: full frame (num_rays <= 0), random pixels, random patches
    (patch_size > 1), or a fixed rect (finetune_lips).

    Returns dict with rays_o [N,3], rays_d [N,3], inds [N] flat pixel ids,
    i [N], j [N] (pixel centers, +0.5).
    """
    fx, fy, cx, cy = intrinsics
    rng = rng or np.random.default_rng()

    if rect is not None:
        xmin, xmax, ymin, ymax = rect
        num_rays = (xmax - xmin) * (ymax - ymin)

    if num_rays > 0:
        num_rays = min(num_rays, H * W)
        if patch_size > 1:
            num_patch = num_rays // (patch_size**2)
            px = rng.integers(0, H - patch_size, num_patch)
            py = rng.integers(0, W - patch_size, num_patch)
            off_i, off_j = np.meshgrid(
                np.arange(patch_size), np.arange(patch_size), indexing="ij"
            )
            inds = (px[:, None] + off_i.reshape(-1)[None, :]) * W + (
                py[:, None] + off_j.reshape(-1)[None, :]
            )
            inds = inds.reshape(-1)
        elif rect is not None:
            xmin, xmax, ymin, ymax = rect
            gx, gy = np.meshgrid(
                np.arange(xmin, xmax), np.arange(ymin, ymax), indexing="ij"
            )
            inds = (gx * W + gy).reshape(-1)
        else:
            inds = rng.integers(0, H * W, num_rays)  # may duplicate
        i = (inds % W).astype(np.float32) + 0.5
        j = (inds // W).astype(np.float32) + 0.5
    else:
        inds = np.arange(H * W)
        i = (inds % W).astype(np.float32) + 0.5
        j = (inds // W).astype(np.float32) + 0.5

    zs = np.ones_like(i)
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    dirs = np.stack([xs, ys, zs], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape).copy()

    return {
        "rays_o": rays_o.astype(np.float32),
        "rays_d": rays_d.astype(np.float32),
        "inds": inds.astype(np.int64),
        "i": i,
        "j": j,
    }
