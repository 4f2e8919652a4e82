"""Offline preprocessing: talking-head video -> on-disk training dataset
(counterpart of ``radnerf_tpu/preprocess/pipeline.py``; reference
data_utils/process.py, its 9 tasks at :367-401):

 1 extract the 16 kHz wav (ffmpeg)
 2 audio features (the streaming ASR's save_feats path, or DeepSpeech)
 3 extract 25 fps frames (ffmpeg)
 4 BiSeNet face parsing -> head/neck/torso/bg masks (on the card)
 5 background plate: per-pixel farthest-from-foreground frame + nearest
   inpaint (process.py:63-117)
 6 gt/torso image synthesis with vertical torso+neck inpainting
   (process.py:120-239)
 7 68-point landmarks (face_alignment)
 8 3DMM face tracking -> per-frame pose/expression (on the card)
 9 transforms_{train,val}.json with a 10/11 : 1/11 split (process.py:303)

The models of tasks 2, 4, 7 and 8 are pluggable callables, as in JAX; tasks
4 and 8 build the port's own from weight files (the BiSeNet checkpoint, the
BFM files) on ``device``. Tasks 5, 6 and 9 are host work in numpy, cv2 and
scipy. Task 5 needs no sklearn: its nearest-foreground and nearest-recovered
distances are exact Euclidean distances on the pixel lattice from
``scipy.ndimage.distance_transform_edt`` (equal to sklearn's
``kneighbors``; where several recovered pixels are nearest to a hole, each
picks one of them).
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..device import resolve_device


def _run(cmd: list):
    print(f"[preprocess] $ {' '.join(cmd)}")
    subprocess.run(cmd, check=True)


# ---------------------------------------------------------------- task 1 & 3
def extract_audio(video_path: str, out_wav: str, sample_rate: int = 16000):
    _run(["ffmpeg", "-y", "-i", video_path, "-f", "wav", "-ar", str(sample_rate), out_wav])


def extract_frames(video_path: str, out_dir: str, fps: int = 25):
    _run([
        "ffmpeg", "-y", "-i", video_path, "-vf", f"fps={fps}",
        "-qmin", "1", "-q:v", "1", "-start_number", "0",
        os.path.join(out_dir, "%d.jpg"),
    ])


# -------------------------------------------------------------------- task 2
def extract_audio_features(wav_path: str, asr: str, asr_model: str,
                           logits_fn: Optional[Callable] = None,
                           deepspeech_pb: Optional[str] = None, device="cuda"):
    """Per-frame audio features beside the wav. DeepSpeech (``asr ==
    "deepspeech"`` or a deepspeech ``asr_model``) writes ``<stem>_ds.npy``
    through ``extract_ds_features`` (``logits_fn`` as its ``net_fn``); else
    the streaming ASR runs over the whole wav on ``device`` and saves the
    unfolded features (``<stem>_eo.npy`` for the esperanto model, else
    ``<stem>.npy``; its default acoustic model is wav2vec2)."""
    if asr == "deepspeech" or "deepspeech" in asr_model:
        from .deepspeech import extract_ds_features

        extract_ds_features(wav_path, pb_path=deepspeech_pb, net_fn=logits_fn)
        return
    from ..apps.asr import StreamingASR
    from ..config import Options

    opt = Options(asr_wav=wav_path, asr_model=asr_model, asr_save_feats=True)
    StreamingASR(opt, logits_fn=logits_fn, device=device).run()


# -------------------------------------------------------------------- task 5
def _seg_path(image_path: str, ori_imgs_dir: str, parsing_dir: str) -> str:
    return (image_path.replace(os.path.basename(ori_imgs_dir), os.path.basename(parsing_dir))
            .replace(".jpg", ".png"))


def extract_background(base_dir: str, ori_imgs_dir: str, parsing_dir: str,
                       every: int = 20, dist_thresh: float = 5.0):
    """Background plate: each pixel takes its colour from the frame where it
    is farthest from any foreground pixel (the first such frame); holes are
    filled from the nearest recovered pixel (process.py:63-117)."""
    import cv2
    from scipy.ndimage import distance_transform_edt

    image_paths = sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg")))[::every]
    dists = []
    for p in image_paths:
        seg = cv2.imread(_seg_path(p, ori_imgs_dir, parsing_dir))
        bg = (seg == 255).all(-1)
        if bg.all():
            raise ValueError(f"{p}: the parsing mask has no foreground pixel")
        # distance of every pixel to the nearest foreground pixel (0 on it)
        dists.append(distance_transform_edt(bg).reshape(-1))
    dists = np.stack(dists)  # [F, h*w]
    best_frame = np.argmax(dists, 0)
    best_dist = np.max(dists, 0)
    imgs = np.stack([cv2.imread(p) for p in image_paths])
    h, w = imgs.shape[1:3]
    imgs = imgs.reshape(len(image_paths), -1, 3)

    plate = np.zeros((h * w, 3), np.uint8)
    good = best_dist > dist_thresh
    plate[good] = imgs[best_frame[good], np.nonzero(good)[0]]
    plate = plate.reshape(h, w, 3)

    # fill holes from the nearest recovered pixel
    good2 = good.reshape(h, w)
    if good2.any() and not good2.all():
        _, (si, sj) = distance_transform_edt(~good2, return_indices=True)
        holes = ~good2
        plate[holes] = plate[si[holes], sj[holes]]

    cv2.imwrite(os.path.join(base_dir, "bc.jpg"), plate)


# -------------------------------------------------------------------- task 6
def _vertical_inpaint(canvas, gt_image, part_mask, head_mask, length, push_down: int = 0):
    """Columns whose topmost `part` pixel borders the head get painted
    upward with a 0.98-per-pixel darkened copy of that pixel
    (process.py:152-219). Returns the painted mask."""
    coords = np.stack(np.nonzero(part_mask), -1)
    painted = np.zeros(part_mask.shape, bool)
    if len(coords) == 0:
        return painted
    order = np.lexsort((coords[:, 0], coords[:, 1]))
    coords = coords[order]
    _, uid, ucnt = np.unique(coords[:, 1], return_index=True, return_counts=True)
    top = coords[uid]
    up = top - np.array([1, 0])
    ok = head_mask[up[:, 0].clip(0), up[:, 1]]
    if not ok.any():
        return painted
    top = top[ok]
    if push_down:
        down = np.minimum(ucnt[ok] - 1, push_down)
        top = top + np.stack([down, np.zeros_like(down)], -1)
    colors = gt_image[top[:, 0], top[:, 1]].astype(np.float32)
    for step in range(length):
        rows = np.clip(top[:, 0] - step, 0, None)
        canvas[rows, top[:, 1]] = (colors * 0.98**step).astype(canvas.dtype)
        painted[rows, top[:, 1]] = True
    return painted


def extract_torso_and_gt(base_dir: str, ori_imgs_dir: str, parsing_dir: str):
    """Composite gt frames over the background plate and synthesize RGBA
    torso plates with vertical torso/neck inpainting (process.py:120-239)."""
    import cv2
    from scipy.ndimage import binary_dilation

    bg_image = cv2.imread(os.path.join(base_dir, "bc.jpg"))
    for image_path in sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg"))):
        ori = cv2.imread(image_path)
        seg = cv2.imread(_seg_path(image_path, ori_imgs_dir, parsing_dir))
        head = (seg[..., 0] == 255) & (seg[..., 1] == 0) & (seg[..., 2] == 0)
        neck = (seg[..., 0] == 0) & (seg[..., 1] == 255) & (seg[..., 2] == 0)
        torso = (seg[..., 0] == 0) & (seg[..., 1] == 0) & (seg[..., 2] == 255)
        bg = (seg == 255).all(-1)

        gt = ori.copy()
        gt[bg] = bg_image[bg]
        cv2.imwrite(image_path.replace(os.path.basename(ori_imgs_dir), "gt_imgs"), gt)

        torso_img = gt.copy()
        torso_img[head] = bg_image[head]
        alpha = np.full(gt.shape[:2], 255, np.uint8)

        painted_t = _vertical_inpaint(torso_img, gt, torso, head, length=9)
        neck_d = binary_dilation(
            neck, structure=np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], bool),
            iterations=3,
        )
        painted_n = _vertical_inpaint(
            torso_img, gt, neck_d, head, length=53, push_down=4
        )
        # blur the inpainted neck region against vertical-line artifacts
        blur = cv2.GaussianBlur(torso_img, (5, 5), cv2.BORDER_DEFAULT)
        torso_img[painted_n] = blur[painted_n]

        mask = neck_d | torso | painted_n | painted_t
        torso_img[~mask] = 0
        alpha[~mask] = 0
        out = np.concatenate([torso_img, alpha[..., None]], -1)
        cv2.imwrite(
            image_path.replace(os.path.basename(ori_imgs_dir), "torso_imgs")
            .replace(".jpg", ".png"),
            out,
        )


# -------------------------------------------------------------------- task 7
def extract_landmarks(ori_imgs_dir: str, landmarks_fn: Optional[Callable] = None):
    """68-point landmarks -> .lms files. landmarks_fn(image_rgb) -> [68, 2];
    defaults to the face_alignment package (imported only then)."""
    import cv2

    if landmarks_fn is None:
        import face_alignment

        fa = face_alignment.FaceAlignment(
            face_alignment.LandmarksType.TWO_D, flip_input=False
        )
        landmarks_fn = lambda img: fa.get_landmarks(img)[0][:, :2]  # noqa: E731

    for image_path in sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg"))):
        img = cv2.cvtColor(cv2.imread(image_path), cv2.COLOR_BGR2RGB)
        lms = landmarks_fn(img)
        if lms is not None:
            np.savetxt(image_path.replace("jpg", "lms"), np.asarray(lms), "%f")


# -------------------------------------------------------------------- task 9
def euler_zyx_rot(euler: np.ndarray) -> np.ndarray:
    """Rotation used by the 3DMM tracker: Rx(theta) @ Ry(phi) @ Rz(psi) with
    the tracker's sign convention (process.py:276-298)."""
    th, ph, ps = euler[:, 0], euler[:, 1], euler[:, 2]
    one, zero = np.ones_like(th), np.zeros_like(th)
    rx = np.stack([one, zero, zero,
                   zero, np.cos(th), np.sin(th),
                   zero, -np.sin(th), np.cos(th)], -1).reshape(-1, 3, 3)
    ry = np.stack([np.cos(ph), zero, -np.sin(ph),
                   zero, one, zero,
                   np.sin(ph), zero, np.cos(ph)], -1).reshape(-1, 3, 3)
    rz = np.stack([np.cos(ps), -np.sin(ps), zero,
                   np.sin(ps), np.cos(ps), zero,
                   zero, zero, one], -1).reshape(-1, 3, 3)
    return rx @ ry @ rz


def save_transforms(base_dir: str, track_params: dict, h: int, w: int):
    """track_params: {'focal': [..], 'euler': [N,3], 'trans': [N,3]} ->
    transforms_{train,val}.json, 10/11 : 1/11 split (process.py:259-342)."""
    focal = float(np.asarray(track_params["focal"]).reshape(-1)[0])
    euler = np.asarray(track_params["euler"], np.float32)
    trans = np.asarray(track_params["trans"], np.float32) / 10.0
    n = euler.shape[0]

    rot = euler_zyx_rot(euler)
    rot_inv = rot.transpose(0, 2, 1)
    trans_inv = -(rot_inv @ trans[..., None])[..., 0]

    split = int(n * 10 / 11)
    for name, ids in (("train", range(0, split)), ("val", range(split, n))):
        frames = []
        for i in ids:
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = rot_inv[i]
            pose[:3, 3] = trans_inv[i]
            frames.append({
                "img_id": int(i),
                "aud_id": int(i),
                "transform_matrix": pose.tolist(),
            })
        out = {"focal_len": focal, "cx": w / 2.0, "cy": h / 2.0, "frames": frames}
        with open(os.path.join(base_dir, f"transforms_{name}.json"), "w") as f:
            json.dump(out, f, indent=2)


# ------------------------------------------------------------------ pipeline
@dataclass
class PreprocessPipeline:
    """The 9-task pipeline with pluggable model steps, its networks and fits
    on ``device`` ("cuda" by default; raises without a card unless "cpu").

    Pluggable callables (None -> the port's default, built from the weight
    paths below, or the gated package):
      parsing_fn(ori_imgs_dir, parsing_dir): semantic masks (task 4;
        default the BiSeNet of ``parsing_weights``).
      landmarks_fn(image_rgb) -> [68, 2] (task 7; default face_alignment).
      tracker_fn(ori_imgs_dir, h, w, n_frames) -> track_params dict (task 8;
        default the 3DMM tracker of ``basis_path``).
      asr_logits_fn(waveform) -> [T, audio_dim] (task 2; default wav2vec2,
        or the DeepSpeech graph of ``deepspeech_pb``).
    """

    video_path: str
    asr: str = "wav2vec"
    asr_model: str = "cpierse/wav2vec2-large-xlsr-53-esperanto"
    parsing_fn: Optional[Callable] = None
    landmarks_fn: Optional[Callable] = None
    tracker_fn: Optional[Callable] = None
    asr_logits_fn: Optional[Callable] = None
    parsing_weights: str = ""  # BiSeNet checkpoint (the reference's 79999_iter.pth)
    basis_path: str = ""  # LandmarkBasis npz or the reference's 3DMM_info.npy
    keys_path: str = ""  # keys_info.npy (only for the 3DMM_info format)
    topology_path: str = ""  # topology_info.npy: enables the photometric
    # refinement stage of task 8 (full-mesh render; needs the 3DMM_info format)
    deepspeech_pb: str = ""  # the DeepSpeech-0.1.0 frozen graph (task 2, deepspeech)
    device: str = "cuda"
    dirs: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        base = os.path.dirname(self.video_path)
        self.dirs = {
            "base": base,
            "wav": os.path.join(base, "aud.wav"),
            "ori": os.path.join(base, "ori_imgs"),
            "parsing": os.path.join(base, "parsing"),
            "gt": os.path.join(base, "gt_imgs"),
            "torso": os.path.join(base, "torso_imgs"),
        }
        for k in ("ori", "parsing", "gt", "torso"):
            os.makedirs(self.dirs[k], exist_ok=True)

    def run(self, task: int = -1):
        d = self.dirs
        if task in (-1, 1):
            extract_audio(self.video_path, d["wav"])
        if task in (-1, 2):
            extract_audio_features(d["wav"], self.asr, self.asr_model, self.asr_logits_fn,
                                   self.deepspeech_pb or None, self.device)
        if task in (-1, 3):
            extract_frames(self.video_path, d["ori"])
        if task in (-1, 4):
            if self.parsing_fn is None and self.parsing_weights:
                from .face_parsing import make_parsing_fn

                self.parsing_fn = make_parsing_fn(self.parsing_weights, self.device)
            if self.parsing_fn is None:
                raise RuntimeError(
                    "task 4 (face parsing) needs a parsing_fn or "
                    "parsing_weights= (BiSeNet checkpoint, the reference's "
                    "79999_iter.pth)"
                )
            self.parsing_fn(d["ori"], d["parsing"])
        if task in (-1, 5):
            extract_background(d["base"], d["ori"], d["parsing"])
        if task in (-1, 6):
            extract_torso_and_gt(d["base"], d["ori"], d["parsing"])
        if task in (-1, 7):
            extract_landmarks(d["ori"], self.landmarks_fn)
        if task in (-1, 8, 9):
            import cv2

            paths = sorted(glob.glob(os.path.join(d["ori"], "*.jpg")))
            h, w = cv2.imread(paths[0]).shape[:2]
            if task in (-1, 8):
                if self.tracker_fn is None and self.basis_path:
                    from .face_tracker import (
                        basis_from_file, make_photometric_fn, make_tracker_fn,
                    )

                    basis = basis_from_file(self.basis_path, self.keys_path or None)
                    kw = {}
                    if self.topology_path:
                        from .render_3dmm import mesh_basis_from_file

                        mesh = mesh_basis_from_file(
                            self.basis_path, self.topology_path, self.keys_path or None)
                        kw["photometric_fn"] = make_photometric_fn(
                            mesh, basis, d["ori"], h, w, device=self.device)
                    self.tracker_fn = make_tracker_fn(basis, device=self.device, **kw)
                if self.tracker_fn is None:
                    raise RuntimeError(
                        "task 8 (face tracking) needs a tracker_fn or "
                        "basis_path= (LandmarkBasis npz, or the reference's "
                        "3DMM_info.npy with keys_path=keys_info.npy)"
                    )
                params = self.tracker_fn(d["ori"], h, w, len(paths))
                np.savez(os.path.join(d["base"], "track_params.npz"), **params)
            if task in (-1, 9):
                params = dict(np.load(os.path.join(d["base"], "track_params.npz")))
                save_transforms(d["base"], params, h, w)


def run_pipeline(video_path: str, task: int = -1, **kwargs):
    PreprocessPipeline(video_path, **kwargs).run(task)
