"""What the program's datasets derive from the files, worked out again in
plain numpy and PyTorch: poses, rays, eye values, face rectangles, audio
windows, the training pixels.

Frozen copies at commit 2a619bf24d8171cdad65a8fd4e01bbb8c7f3f0f8 of
``radnerf_tpu_torch/data/rays.py`` (``get_bg_coords``, ``draw_pixels`` for
random pixels, ``pixel_centres``, ``rays_from_pixels``,
``nerf_matrix_to_ngp``, ``smooth_camera_path``, ``matrix_to_euler_xyz``,
``convert_poses``, ``polygon_area``) and of ``data/provider.py``
(``_smooth_1d``, the eye area and face rectangle from the landmarks, the
att-2 audio window, the mirror index, the training draw order). It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def get_bg_coords(H: int, W: int) -> np.ndarray:
    X = np.arange(H, dtype=np.float32) / (H - 1) * 2 - 1
    Y = np.arange(W, dtype=np.float32) / (W - 1) * 2 - 1
    xs, ys = np.meshgrid(X, Y, indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)


def draw_pixels(H: int, W: int, num_rays: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, H * W, min(num_rays, H * W)).astype(np.int64)


def pixel_centres(inds: torch.Tensor, W: int):
    return (inds % W).float() + 0.5, (inds // W).float() + 0.5


def rays_from_pixels(pose: torch.Tensor, intrinsics, inds: torch.Tensor, W: int):
    """(rays_o, rays_d) [N, 3]: directions in float64, rounded once."""
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
    return pose[:3, 3].expand(inds.shape[0], 3).contiguous(), rays_d.float()


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    return np.array([
        [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
        [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
        [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
        [0, 0, 0, 1]], dtype=np.float32)


def ngp_to_nerf_matrix(P: np.ndarray, scale: float) -> np.ndarray:
    """The transform_matrix whose ``nerf_matrix_to_ngp`` is the NGP pose P
    (the benchmark writes its cameras through it)."""
    M = np.zeros((4, 4), np.float64)
    M[1] = [P[0, 0], -P[0, 1], -P[0, 2], P[0, 3] / scale]
    M[2] = [P[1, 0], -P[1, 1], -P[1, 2], P[1, 3] / scale]
    M[0] = [P[2, 0], -P[2, 1], -P[2, 2], P[2, 3] / scale]
    M[3, 3] = 1.0
    return M


def smooth_camera_path(poses: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    N, K = poses.shape[0], kernel_size // 2
    trans, rots, out = poses[:, :3, 3].copy(), poses[:, :3, :3].copy(), poses.copy()
    for i in range(N):
        start, end = max(0, i - K), min(N, i + K + 1)
        out[i, :3, 3] = trans[start:end].mean(0)
        out[i, :3, :3] = Rotation.from_matrix(rots[start:end]).mean().as_matrix()
    return out


def smooth_1d(x: np.ndarray) -> np.ndarray:
    out = x.copy()
    for i in range(x.shape[0]):
        out[i] = x[max(0, i - 1): min(x.shape[0], i + 2)].mean()
    return out


def convert_poses(poses: np.ndarray) -> np.ndarray:
    m = poses[:, :3, :3]
    out = np.empty((poses.shape[0], 6), np.float32)
    out[:, 0] = np.arctan2(-m[..., 1, 2], m[..., 2, 2])
    out[:, 1] = np.arcsin(np.clip(m[..., 0, 2], -1.0, 1.0))
    out[:, 2] = np.arctan2(-m[..., 0, 1], m[..., 0, 0])
    out[:, 3:] = poses[:, :3, 3]
    return out


def polygon_area(x: np.ndarray, y: np.ndarray) -> float:
    x_, y_ = x - x.mean(), y - y.mean()
    correction = x_[-1] * y_[0] - y_[-1] * x_[0]
    main_area = np.dot(x_[:-1], y_[1:]) - np.dot(y_[:-1], x_[1:])
    return 0.5 * np.abs(main_area + correction)


def eye_area(lms: np.ndarray, H: int, W: int) -> float:
    area_l = polygon_area(lms[36:42, 0], lms[36:42, 1])
    area_r = polygon_area(lms[42:48, 0], lms[42:48, 1])
    return (area_l + area_r) / (H * W) * 100


def face_rect(lms: np.ndarray) -> list:
    return [int(lms[31:36, 1].min()), int(lms[:, 1].max()),
            int(lms[:, 0].min()), int(lms[:, 0].max())]


def audio_window(auds: torch.Tensor, index: int) -> torch.Tensor:
    """The att-2 window: frames index-4 .. index+3 of [T, K, 16], zeros
    outside."""
    T = auds.shape[0]
    pad = auds.new_zeros((8, *auds.shape[1:]))
    padded = torch.cat([pad, auds, pad])
    if not 0 <= index < T + 4:
        raise IndexError(index)
    return padded[8 + index - 4:8 + index + 4]


def mirror_index(index: int, size: int) -> int:
    turn, res = divmod(index, size)
    return res if turn % 2 == 0 else size - res - 1
