"""Ray generation, pose conversion and audio windows (a copy of
``radnerf_tpu/data/rays.py`` get_rays, get_bg_coords, convert_poses and
get_audio_features; numpy only, reference nerf/utils.py:42-333)."""

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


# ------------------------------------------------------------------- poses
def matrix_to_euler_xyz(m: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] -> XYZ Euler angles [..., 3]
    (utils.py:130-169, convention='XYZ')."""
    central = np.arcsin(np.clip(m[..., 0, 2], -1.0, 1.0))
    first = np.arctan2(-m[..., 1, 2], m[..., 2, 2])
    third = np.arctan2(-m[..., 0, 1], m[..., 0, 0])
    return np.stack([first, central, third], axis=-1)


def convert_poses(poses: np.ndarray) -> np.ndarray:
    """[B, 4, 4] -> [B, 6] (3 XYZ-euler rot + 3 trans) (utils.py:230-237)."""
    out = np.empty((poses.shape[0], 6), np.float32)
    out[:, :3] = matrix_to_euler_xyz(poses[:, :3, :3])
    out[:, 3:] = poses[:, :3, 3]
    return out


# -------------------------------------------------------------------- audio
def get_audio_features(features: np.ndarray, att_mode: int, index: int) -> np.ndarray:
    """The audio window of frame ``index`` (utils.py:42-74). att_mode 0: the
    frame alone [1, ...]; 1: the 8 frames before it; 2: the 8 frames
    index-4 .. index+3, zero-padded at the sequence edges."""
    T = features.shape[0]
    if att_mode == 0:
        return features[[index]]
    if att_mode == 1:
        left = index - 8
        window = features[max(0, left):index]
        pad_left = max(0, -left)
        if pad_left > 0:
            pad = np.zeros((pad_left, *features.shape[1:]), features.dtype)
            window = np.concatenate([pad, window], 0)
        return window
    if att_mode == 2:
        left, right = index - 4, index + 4
        pad_left, pad_right = max(0, -left), max(0, right - T)
        window = features[max(0, left):min(T, right)]
        if pad_left > 0:
            window = np.concatenate(
                [np.zeros((pad_left, *features.shape[1:]), features.dtype), window], 0)
        if pad_right > 0:
            window = np.concatenate(
                [window, np.zeros((pad_right, *features.shape[1:]), features.dtype)], 0)
        return window
    raise NotImplementedError(f"wrong att_mode: {att_mode}")
