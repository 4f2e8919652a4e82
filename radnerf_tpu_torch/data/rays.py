"""Ray generation, pose conversion and audio windows (a copy of
``radnerf_tpu/data/rays.py``; reference nerf/utils.py:42-333 and
nerf/provider.py:19-52), in numpy, and the rays of pixels already drawn in
torch on their device (``rays_from_pixels``)."""

from __future__ import annotations

import numpy as np
import torch


# -------------------------------------------------------------------- rays
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
    inds = draw_pixels(H, W, num_rays, patch_size, rect, rng or np.random.default_rng())
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


def draw_pixels(H: int, W: int, num_rays: int = -1, patch_size: int = 1, rect=None,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """The flat pixel indices ``get_rays`` takes, drawn from ``rng`` as it
    draws them (the same generator calls): every pixel (num_rays <= 0),
    random pixels (may repeat), random patches (patch_size > 1) or a fixed
    rect. int64 [N]."""
    if rect is not None:
        xmin, xmax, ymin, ymax = rect
        num_rays = (xmax - xmin) * (ymax - ymin)
    if num_rays <= 0:
        return np.arange(H * W, dtype=np.int64)
    num_rays = min(num_rays, H * W)
    if patch_size > 1:
        num_patch = num_rays // (patch_size**2)
        px = rng.integers(0, H - patch_size, num_patch)
        py = rng.integers(0, W - patch_size, num_patch)
        off_i, off_j = np.meshgrid(np.arange(patch_size), np.arange(patch_size), indexing="ij")
        inds = (px[:, None] + off_i.reshape(-1)[None, :]) * W \
            + (py[:, None] + off_j.reshape(-1)[None, :])
        return inds.reshape(-1).astype(np.int64)
    if rect is not None:
        gx, gy = np.meshgrid(np.arange(xmin, xmax), np.arange(ymin, ymax), indexing="ij")
        return (gx * W + gy).reshape(-1).astype(np.int64)
    return rng.integers(0, H * W, num_rays).astype(np.int64)


def pixel_centres(inds: torch.Tensor, W: int):
    """(i, j) float32 pixel centres (+0.5) of flat indices, column and row,
    as ``get_rays`` returns them."""
    return (inds % W).float() + 0.5, (inds // W).float() + 0.5


def rays_from_pixels(pose: torch.Tensor, intrinsics, inds: torch.Tensor, W: int):
    """``get_rays`` for pixels already drawn, on their device: (rays_o,
    rays_d) [N, 3] float32. pose: [4, 4] float32 tensor; intrinsics: (fx, fy,
    cx, cy), float64 as the datasets keep them.

    The directions are computed in float64 and rounded to float32 once, as
    numpy does with float64 intrinsics; each operation is its own kernel
    (no fused multiply-add) and the divisors are tensors (a CUDA division by
    a Python scalar multiplies by its reciprocal). Only the 3x3 rotation's
    summation may differ from numpy's BLAS: within one float32 ulp."""
    dev = inds.device
    fx, fy, cx, cy = (torch.full((), float(v), dtype=torch.float64, device=dev)
                      for v in intrinsics)
    i, j = pixel_centres(inds, W)
    xs = (i.double() - cx) / fx
    ys = (j.double() - cy) / fy
    norm = torch.sqrt(xs * xs + ys * ys + 1.0)
    xs, ys, zs = xs / norm, ys / norm, 1.0 / norm
    R = pose[:3, :3].double()
    rays_d = torch.stack([xs * R[k, 0] + ys * R[k, 1] + zs * R[k, 2] for k in range(3)], dim=-1)
    rays_o = pose[:3, 3].expand(inds.shape[0], 3).contiguous()
    return rays_o, rays_d.float()


# ------------------------------------------------------------------- poses
def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """Axis permutation + scale into the NGP convention (provider.py:19-26)."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def smooth_camera_path(poses: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    """Window-mean smoothing of translation + rotation (provider.py:29-45)."""
    from scipy.spatial.transform import Rotation

    N = poses.shape[0]
    K = kernel_size // 2
    trans = poses[:, :3, 3].copy()
    rots = poses[:, :3, :3].copy()
    out = poses.copy()
    for i in range(N):
        start = max(0, i - K)
        end = min(N, i + K + 1)
        out[i, :3, 3] = trans[start:end].mean(0)
        out[i, :3, :3] = Rotation.from_matrix(rots[start:end]).mean().as_matrix()
    return out


def euler_xyz_to_matrix(angles: np.ndarray) -> np.ndarray:
    """XYZ Euler angles [..., 3] -> rotation matrices [..., 3, 3]
    (utils.py:171-227): R = Rx(a) @ Ry(b) @ Rz(c)."""
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    zero = np.zeros_like(a)
    one = np.ones_like(a)
    rx = np.stack([one, zero, zero, zero, ca, -sa, zero, sa, ca], -1).reshape(*a.shape, 3, 3)
    ry = np.stack([cb, zero, sb, zero, one, zero, -sb, zero, cb], -1).reshape(*a.shape, 3, 3)
    rz = np.stack([cc, -sc, zero, sc, cc, zero, zero, zero, one], -1).reshape(*a.shape, 3, 3)
    return rx @ ry @ rz


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


def polygon_area(x: np.ndarray, y: np.ndarray) -> float:
    """Shoelace area (provider.py:47-52), used for the eye-openness scalar."""
    x_ = x - x.mean()
    y_ = y - y.mean()
    correction = x_[-1] * y_[0] - y_[-1] * x_[0]
    main_area = np.dot(x_[:-1], y_[1:]) - np.dot(y_[:-1], x_[1:])
    return 0.5 * np.abs(main_area + correction)


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
