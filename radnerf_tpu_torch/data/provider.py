"""Datasets over the reference's on-disk format, with each batch built on
the device (counterpart of ``radnerf_tpu/data/provider.py``; reference
nerf/provider.py NeRFDataset :311-735 and NeRFDataset_Test :84-308).

Disk layout (what the preprocessing pipeline writes):
  <root>/transforms_{train,val}.json   poses + per-frame img_id/aud_id
  <root>/gt_imgs/<id>.jpg              ground-truth frames
  <root>/torso_imgs/<id>.png           RGBA torso plates
  <root>/ori_imgs/<id>.lms             68 landmarks (face/lips rects, eye area)
  <root>/bc.jpg                        background plate
  <root>/aud_eo.npy | aud_ds.npy | aud.npy   audio features [T, 16, K]

The numpy attributes the trainer and its upkeep read are the JAX dataset's
(``poses``, ``intrinsics``, ``auds``, ``eye_area``, ``face_rect``,
``lips_rect``, ``bg_img``, ``H``, ``W``, ``radius``), and so are ``collate``'s
keys and shapes, ``mirror_index``, ``epoch_indices`` and ``has_gt``. The
frames stay uint8 as ``opt.preload`` says (2: on the device, 1: on the host,
0: decoded from disk at each batch); the background, the audio table and the
pixel coordinates live on the device. ``collate`` draws the pixel indices
with the dataset's numpy generator exactly as the JAX ``get_rays`` does (so
the same seed selects the same pixels and the same epoch orders), uploads
only those, and on the device gathers the pixels and the background, forms
the rays, the face mask and the audio window, and composites the torso plate
over the background at the drawn pixels alone (the JAX collate composites
the whole frame; the per-pixel float32 operations are the same, so the
values are bit for bit the same).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.image import U8_TO_UNIT, imread, imread_u8
from .rays import (
    convert_poses,
    draw_pixels,
    get_bg_coords,
    nerf_matrix_to_ngp,
    pixel_centres,
    polygon_area,
    rays_from_pixels,
    smooth_camera_path,
)

# rows of zeros around the device audio table: the widest window reaches 8
# frames before its index (att 1) and 4 after it (att 2)
_AUD_PAD = 8


def _smooth_1d(x: np.ndarray) -> np.ndarray:
    """Naive 3-window average (provider.py:208-214)."""
    out = x.copy()
    for i in range(x.shape[0]):
        out[i] = x[max(0, i - 1): min(x.shape[0], i + 2)].mean()
    return out


def load_audio_features(path: str, emb: bool = False) -> np.ndarray:
    """[T, 16, K] logits -> [T, K, 16]; or [T, 16] labels when emb
    (provider.py:400-414)."""
    feats = np.load(path)
    if feats.ndim == 3:
        feats = feats.astype(np.float32).transpose(0, 2, 1)
        if emb:
            feats = feats.argmax(1).astype(np.int64)
    else:
        if not emb:
            raise ValueError(f"{path} holds audio labels only; they need --emb")
        feats = feats.astype(np.int64)
    return feats


def load_background(bg_img: str, H: int, W: int, default: str) -> np.ndarray:
    """The background plate float32 [H, W, 3]: "white", "black", else the
    image at ``bg_img`` (``default`` when empty) resized to the frame. cv2's
    area resize where cv2 is present; without it only a whole-number shrink,
    where the area mean of each k x k block is ``avg_pool2d``'s."""
    if bg_img == "white":
        return np.ones((H, W, 3), np.float32)
    if bg_img == "black":
        return np.zeros((H, W, 3), np.float32)
    path = bg_img or default
    bg = imread(path)[..., :3]
    if bg.shape[:2] == (H, W):
        return bg
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.resize(bg, (W, H), interpolation=cv2.INTER_AREA)
    k = bg.shape[0] // H
    if k < 2 or bg.shape[:2] != (k * H, k * W):
        raise ValueError(f"{path} is {bg.shape[1]}x{bg.shape[0]}, the frames {W}x{H}: without "
                         "cv2 only a whole-number shrink of the background is taken")
    x = torch.from_numpy(np.ascontiguousarray(bg.transpose(2, 0, 1)))[None]
    return F.avg_pool2d(x, k).squeeze(0).permute(1, 2, 0).numpy().copy()


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on the device; on a card through pinned memory without
    waiting for the stream (the caching host allocator keeps the staging
    buffer until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


class _DeviceFrames:
    """What both datasets keep on the device and how a batch is put
    together from it: the background, the pixel coordinates, the audio
    table padded with zero rows, the uint8 -> float32 table."""

    def _init_device(self, device):
        dev = self.device = resolve_device(device)
        self._bg = _upload(self.bg_img.reshape(-1, 3), dev)
        self._bg_coords = _upload(get_bg_coords(self.H, self.W), dev)
        self._unit = _upload(U8_TO_UNIT, dev)
        self._auds = None
        if self.auds is not None:
            pad = np.zeros((_AUD_PAD, *self.auds.shape[1:]), self.auds.dtype)
            self._auds = _upload(np.concatenate([pad, self.auds, pad]), dev)

    def mirror_index(self, index: int) -> int:
        """Replay --> <-- --> <-- (provider.py:615-622)."""
        size = self.poses.shape[0]
        turn, res = divmod(index, size)
        return res if turn % 2 == 0 else size - res - 1

    def audio_window(self, index: int) -> torch.Tensor:
        """``get_audio_features(self.auds, opt.att, index)`` sliced from the
        device table (utils.py:42-74): att 0 the frame alone, 1 the 8 frames
        before it, 2 the frames index-4 .. index+3, zero-padded."""
        T, att = self.auds.shape[0], self.opt.att
        # where the JAX window is well formed: up to 4 frames past the end
        # (att 2), the end itself (att 1)
        if not 0 <= index < T + {0: 0, 1: 1, 2: 4}.get(att, 0):
            raise IndexError(f"audio index {index} outside the {T} frames of features")
        if att == 0:
            return self._auds[_AUD_PAD + index:_AUD_PAD + index + 1]
        if att in (1, 2):
            start = _AUD_PAD + index - (8 if att == 1 else 4)
            return self._auds[start:start + 8]
        raise NotImplementedError(f"wrong att_mode: {att}")

    def _pose_keys(self, pose: np.ndarray) -> dict:
        return {"poses": _upload(convert_poses(pose[None]), self.device),
                "poses_matrix": _upload(pose[None], self.device)}

    def _eye(self, midx: int) -> Optional[torch.Tensor]:
        if self.eye_area is None:
            return None
        return _upload(self.eye_area[midx].reshape(1, 1), self.device)


class TalkingHeadDataset(_DeviceFrames):
    """Train/val/test dataset over a processed video directory
    (NeRFDataset, provider.py:311-735), its batches on ``device``."""

    def __init__(self, opt, split: str = "train", downscale: int = 1, device="cuda"):
        self.opt = opt
        self.split = split
        self.training = split in ("train", "all", "trainval")
        self.num_rays = opt.num_rays if self.training else -1
        self.root = opt.path
        self.rng = np.random.default_rng(opt.seed)

        transform = self._load_transform(split)
        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // downscale
            self.W = int(transform["w"]) // downscale
        else:
            self.H = int(transform["cy"]) * 2 // downscale
            self.W = int(transform["cx"]) * 2 // downscale

        frames = transform["frames"]
        start, end = opt.data_range
        if end == -1:
            end = len(frames)
        frames = frames[start:end]
        if split == "train":
            if opt.part:
                frames = frames[::10]
            elif opt.part2:
                frames = frames[:375]
        elif split == "val":
            frames = frames[:100]

        if opt.asr:
            aud_features = None
        elif opt.aud == "":
            name = ("aud_eo.npy" if "esperanto" in opt.asr_model
                    else "aud_ds.npy" if "deepspeech" in opt.asr_model else "aud.npy")
            aud_features = load_audio_features(os.path.join(self.root, name), opt.emb)
        else:
            aud_features = load_audio_features(opt.aud, opt.emb)

        poses, auds, images, torso_imgs = [], [], [], []
        face_rect, lips_rect, eye_area = [], [], []
        for f in frames:
            img_path = os.path.join(self.root, "gt_imgs", str(f["img_id"]) + ".jpg")
            if not os.path.exists(img_path):
                continue
            pose = np.array(f["transform_matrix"], dtype=np.float32)
            poses.append(nerf_matrix_to_ngp(pose, scale=opt.scale, offset=opt.offset))
            torso_path = os.path.join(self.root, "torso_imgs", str(f["img_id"]) + ".png")
            if opt.preload > 0:
                images.append(imread_u8(img_path))
                torso_imgs.append(imread_u8(torso_path))
            else:
                images.append(img_path)
                torso_imgs.append(torso_path)
            if aud_features is not None and opt.aud == "":
                auds.append(aud_features[min(f["aud_id"], len(aud_features) - 1)])

            lms = np.loadtxt(os.path.join(self.root, "ori_imgs", str(f["img_id"]) + ".lms"))
            xmin, xmax = int(lms[31:36, 1].min()), int(lms[:, 1].max())
            ymin, ymax = int(lms[:, 0].min()), int(lms[:, 0].max())
            face_rect.append([xmin, xmax, ymin, ymax])

            if opt.exp_eye:
                area_l = polygon_area(lms[36:42, 0], lms[36:42, 1])
                area_r = polygon_area(lms[42:48, 0], lms[42:48, 1])
                eye_area.append((area_l + area_r) / (self.H * self.W) * 100)

            if opt.finetune_lips:
                lips = slice(48, 60)
                lxmin, lxmax = int(lms[lips, 1].min()), int(lms[lips, 1].max())
                lymin, lymax = int(lms[lips, 0].min()), int(lms[lips, 0].max())
                cx_ = (lxmin + lxmax) // 2
                cy_ = (lymin + lymax) // 2
                # the JAX package's bucketed square: half-size a multiple of
                # 16, shifted (not clipped) to stay in the frame
                half = ((max(lxmax - lxmin, lymax - lymin) // 2 + 15) // 16) * 16
                x0 = min(max(0, cx_ - half), self.H - 2 * half)
                y0 = min(max(0, cy_ - half), self.W - 2 * half)
                lips_rect.append([x0, x0 + 2 * half, y0, y0 + 2 * half])

        self.poses = np.stack(poses, 0)
        if opt.smooth_path:
            self.poses = smooth_camera_path(self.poses, opt.smooth_path_window)
        self.face_rect = face_rect
        self.lips_rect = lips_rect
        self.preload = opt.preload
        if opt.asr:
            self.auds = None
        elif opt.aud == "":
            self.auds = np.stack(auds, 0)
        else:
            self.auds = aud_features
        self.bg_img = load_background(opt.bg_img, self.H, self.W,
                                      os.path.join(self.root, "bc.jpg"))
        if opt.exp_eye:
            ea = np.array(eye_area, np.float32)
            if opt.smooth_eye:
                ea = _smooth_1d(ea)
            self.eye_area = ea.reshape(-1, 1)
        else:
            self.eye_area = None

        if "focal_len" in transform:
            fl_x = fl_y = transform["focal_len"]
        elif "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = (self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
                    if "camera_angle_x" in transform else None)
            fl_y = (self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
                    if "camera_angle_y" in transform else None)
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("Failed to load focal length from transforms json")
        cx = transform.get("cx", self.W / 2) / downscale
        cy = transform.get("cy", self.H / 2) / downscale
        self.intrinsics = np.array([fl_x, fl_y, cx, cy], np.float64)
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())

        self._init_device(device)
        # uint8 frames [B, H, W, C]: a numpy stack (preload 1), a stack on
        # the device (preload 2), or the files' paths (preload 0)
        self.images, self.torso_imgs = images, torso_imgs
        if opt.preload > 0:
            self.images, self.torso_imgs = np.stack(images, 0), np.stack(torso_imgs, 0)
        if opt.preload > 1:
            self.images = _upload(self.images, self.device)
            self.torso_imgs = _upload(self.torso_imgs, self.device)

    def _load_transform(self, split):
        if split == "all":
            transform = None
            for p in glob.glob(os.path.join(self.root, "*.json")):
                with open(p) as f:
                    t = json.load(f)
                if transform is None:
                    transform = t
                else:
                    transform["frames"].extend(t["frames"])
            return transform
        if split == "trainval":
            with open(os.path.join(self.root, "transforms_train.json")) as f:
                transform = json.load(f)
            with open(os.path.join(self.root, "transforms_val.json")) as f:
                transform["frames"].extend(json.load(f)["frames"])
            return transform
        name = "val" if split == "test" else split
        with open(os.path.join(self.root, f"transforms_{name}.json")) as f:
            return json.load(f)

    def __len__(self):
        if self.training:
            return self.poses.shape[0]
        if self.auds is not None:
            return self.auds.shape[0]
        return 2 * self.poses.shape[0]

    def _frame_u8(self, index: int):
        """(frame, torso plate) of frame ``index`` as uint8 tensors [H, W, C]
        on the device."""
        if self.preload > 1:
            return self.images[index], self.torso_imgs[index]
        if self.preload == 1:
            image, torso = self.images[index], self.torso_imgs[index]
        else:
            image, torso = imread_u8(self.images[index]), imread_u8(self.torso_imgs[index])
        return _upload(image, self.device), _upload(torso, self.device)

    def collate(self, index: int) -> dict:
        """One batch on the device (provider.py:625-714): the loader index
        picks the audio window, its mirrored index the pose and the images.
        Training draws ``num_rays`` pixels (or the lips rect, or patches);
        otherwise every pixel, with ``images`` the whole frame [1, H, W, C]."""
        results = {}
        if self.auds is not None:
            results["auds"] = self.audio_window(index)
        midx = self.mirror_index(index)
        pose = self.poses[midx]
        full = not self.training
        if full:
            pix = torch.arange(self.H * self.W, device=self.device)
        elif self.opt.finetune_lips:
            rect = self.lips_rect[midx]
            results["rect"] = rect
            pix = _upload(draw_pixels(self.H, self.W, -1, rect=rect, rng=self.rng), self.device)
        else:
            pix = _upload(draw_pixels(self.H, self.W, self.num_rays, self.opt.patch_size,
                                      rng=self.rng), self.device)
        rays_o, rays_d = rays_from_pixels(_upload(pose, self.device), self.intrinsics, pix,
                                          self.W)
        results.update(index=midx, H=self.H, W=self.W, rays_o=rays_o, rays_d=rays_d)
        if self.training:
            xmin, xmax, ymin, ymax = self.face_rect[midx]
            i, j = pixel_centres(pix, self.W)
            results["face_mask"] = (j >= xmin) & (j < xmax) & (i >= ymin) & (i < ymax)
        results["eye"] = self._eye(midx)

        image, torso = self._frame_u8(midx)
        if full:
            image, torso, bg = image.reshape(-1, image.shape[-1]), torso.reshape(-1, 4), self._bg
        else:
            image, torso, bg = image.reshape(-1, image.shape[-1])[pix], \
                torso.reshape(-1, 4)[pix], self._bg[pix]
        image, torso = self._unit[image.long()], self._unit[torso.long()]
        # the torso plate over the background (provider.py:673)
        alpha = torso[:, 3:]
        bg_torso = torso[:, :3] * alpha + bg * (1 - alpha)
        # head stage: the torso plate is the background
        results["bg_color"] = bg if self.opt.torso else bg_torso
        if self.opt.torso and self.training:
            results["bg_torso_color"] = bg_torso
        results["images"] = image.reshape(1, self.H, self.W, -1) if full else image
        results["bg_coords"] = self._bg_coords if full else self._bg_coords[pix]
        results.update(self._pose_keys(pose))
        return results

    def epoch_indices(self, shuffle: Optional[bool] = None) -> np.ndarray:
        shuffle = self.training if shuffle is None else shuffle
        idx = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(idx)
        return idx

    @property
    def has_gt(self) -> bool:
        return self.opt.aud == ""


class PoseAudioDataset(_DeviceFrames):
    """Inference-only dataset: a pose json and novel audio, no images
    (NeRFDataset_Test, provider.py:84-308); every batch is a whole frame on
    ``device``."""

    def __init__(self, opt, downscale: int = 1, device="cuda"):
        self.opt = opt
        self.training = False
        self.num_rays = -1

        with open(opt.pose) as f:
            transform = json.load(f)
        self.H = int(transform["cy"]) * 2 // downscale
        self.W = int(transform["cx"]) * 2 // downscale
        frames = transform["frames"]
        start, end = opt.data_range
        if end == -1:
            end = len(frames)
        frames = frames[start:end]

        self.auds = None if opt.asr else load_audio_features(opt.aud, opt.emb)
        poses, eye_area = [], []
        for f in frames:
            pose = np.array(f["transform_matrix"], dtype=np.float32)
            poses.append(nerf_matrix_to_ngp(pose, scale=opt.scale, offset=opt.offset))
            if opt.exp_eye:
                eye_area.append(f.get("eye_ratio", 0.25))
        self.poses = np.stack(poses, 0)
        if opt.smooth_path:
            self.poses = smooth_camera_path(self.poses, opt.smooth_path_window)
        # no plate by default: white
        self.bg_img = load_background(opt.bg_img or "white", self.H, self.W, "")
        if opt.exp_eye:
            ea = np.array(eye_area, np.float32)
            if opt.smooth_eye:
                ea = _smooth_1d(ea)
            self.eye_area = ea.reshape(-1, 1)
        else:
            self.eye_area = None
        fl = transform["focal_len"]
        self.intrinsics = np.array(
            [fl, fl, transform["cx"] / downscale, transform["cy"] / downscale], np.float64)
        self._init_device(device)

    def __len__(self):
        if self.auds is not None:
            return self.auds.shape[0]
        return 2 * self.poses.shape[0]

    def collate(self, index: int) -> dict:
        results = {}
        if self.auds is not None:
            results["auds"] = self.audio_window(index)
        midx = self.mirror_index(index)
        pose = self.poses[midx]
        pix = torch.arange(self.H * self.W, device=self.device)
        rays_o, rays_d = rays_from_pixels(_upload(pose, self.device), self.intrinsics, pix,
                                          self.W)
        results.update(index=midx, H=self.H, W=self.W, rays_o=rays_o, rays_d=rays_d,
                       eye=self._eye(midx), bg_color=self._bg, bg_coords=self._bg_coords)
        results.update(self._pose_keys(pose))
        return results

    @property
    def has_gt(self) -> bool:
        return False
