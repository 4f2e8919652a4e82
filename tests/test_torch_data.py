"""The port's datasets and image input/output against the JAX package's, on
the CPU, on tests/test_train.py's 64x64 on-disk dataset: the numpy
attributes equal; for the same seed the same pixels and epoch orders; the
batches' images, colours, masks, pixel coordinates, audio windows and poses
bit for bit, the rays within one float32 ulp (the port computes them in
float64 on the device and sums the rotation in its own order); the ray
helpers exactly; ``imread`` bit for bit with cv2."""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.data import PoseAudioDataset as JPoseAudioDataset
from radnerf_tpu.data import TalkingHeadDataset as JTalkingHeadDataset
from radnerf_tpu.data import rays as jrays

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.data import PoseAudioDataset, TalkingHeadDataset, rays
from radnerf_tpu_torch.utils.image import imread, imread_u8, write_png, write_video

from test_train import _make_pose, data_dir  # noqa: F401  (the on-disk dataset fixture)

EXACT = ("images", "bg_color", "bg_torso_color", "face_mask", "bg_coords", "auds", "eye",
         "poses", "poses_matrix")
ATTRS = ("poses", "intrinsics", "auds", "eye_area", "face_rect", "lips_rect", "bg_img", "radius")


def _same_batch(got: dict, want: dict):
    assert set(got) == {k for k, v in want.items() if v is not None} | \
        {k for k, v in got.items() if v is None}, (sorted(got), sorted(want))
    for k in ("index", "H", "W", "rect"):
        assert got.get(k) == want.get(k), k
    for k in EXACT:
        if want.get(k) is None:
            assert got.get(k) is None, k
            continue
        g, w = got[k], np.asarray(want[k])
        assert tuple(g.shape) == w.shape, k
        if w.dtype.kind == "f":
            assert g.dtype == torch.float32, k
            w = w.astype(np.float32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    for k in ("rays_o", "rays_d"):
        g, w = got[k].numpy(), want[k]
        assert g.dtype == w.dtype == np.float32, k
        np.testing.assert_array_max_ulp(g, w, maxulp=1)


def _compare(port, jax_ds, steps=3):
    for k in ATTRS:
        g, w = getattr(port, k), getattr(jax_ds, k)
        if w is None:
            assert g is None, k
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)
    assert (port.H, port.W, len(port), port.has_gt) == \
        (jax_ds.H, jax_ds.W, len(jax_ds), jax_ds.has_gt)
    for i in range(min(steps, len(port))):
        _same_batch(port.collate(i), jax_ds.collate(i))
    np.testing.assert_array_equal(port.epoch_indices(), jax_ds.epoch_indices())
    order = jax_ds.epoch_indices()
    np.testing.assert_array_equal(port.epoch_indices(), order)
    _same_batch(port.collate(int(order[-1])), jax_ds.collate(int(order[-1])))


@pytest.fixture(scope="module")
def files(data_dir, tmp_path_factory):  # noqa: F811
    """A background plate of the frame's size and one of twice its size,
    and an audio table beside the dataset."""
    root = tmp_path_factory.mktemp("bg")
    rng = np.random.default_rng(5)
    bg = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    cv2.imwrite(str(root / "bg.jpg"), bg)
    big = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
    cv2.imwrite(str(root / "bg2x.png"), big)
    cv2.imwrite(str(root / "bg96.png"), big[:96, :96])
    np.save(str(root / "aud.npy"), rng.normal(size=(7, 16, 44)).astype(np.float32))
    return root


CASES = {
    "train": ("train", {}),
    "val": ("val", {}),
    "test": ("test", {}),
    "trainval": ("trainval", {}),
    "data_range": ("train", dict(data_range=(1, 3))),
    "part": ("train", dict(part=True)),
    "smooth_path_eye": ("train", dict(smooth_path=True, smooth_path_window=3, smooth_eye=True)),
    "torso": ("train", dict(torso=True)),
    "torso_test": ("test", dict(torso=True)),
    "emb_att0": ("train", dict(emb=True, att=0)),
    "att1_no_eye": ("train", dict(att=1, exp_eye=False)),
    "aud_file": ("test", dict(aud="aud.npy")),
    "lips": ("train", dict(finetune_lips=True)),
    "patch": ("train", dict(patch_size=4)),
    "bg_white": ("train", dict(bg_img="white")),
    "bg_black": ("test", dict(bg_img="black")),
    "bg_file": ("train", dict(bg_img="bg.jpg")),
    "bg_2x": ("train", dict(bg_img="bg2x.png")),
    "preload1": ("train", dict(preload=1)),
    "preload2": ("test", dict(preload=2, torso=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_matches_jax(case, data_dir, files):  # noqa: F811
    split, kw = CASES[case]
    kw = {k: str(files / v) if k in ("bg_img", "aud") and v.endswith(("g", "y")) else v
          for k, v in kw.items()}
    kw = {"exp_eye": True, **kw}
    common = dict(path=data_dir, num_rays=300, seed=3, **kw)
    port = TalkingHeadDataset(Options(**common), split=split, device="cpu")
    want = JTalkingHeadDataset(JOptions(**common), split=split)
    _compare(port, want)


def test_background_resize_without_cv2(data_dir, files, monkeypatch):  # noqa: F811
    """Without cv2 the 2x background shrinks by avg_pool2d, bit for bit with
    cv2's area resize; a size that is no whole multiple raises."""
    want = JTalkingHeadDataset(JOptions(path=data_dir, bg_img=str(files / "bg2x.png")),
                               split="val").bg_img
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = TalkingHeadDataset(Options(path=data_dir, bg_img=str(files / "bg2x.png")),
                             split="val", device="cpu").bg_img
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="whole-number"):
        TalkingHeadDataset(Options(path=data_dir, bg_img=str(files / "bg96.png")),
                           split="val", device="cpu")


def test_pose_audio_dataset_matches_jax(files, tmp_path):
    """PoseAudioDataset in test mode (smoothed path and eye): the attributes
    equal and every frame's batch, the audio windows at both ends included."""
    rng = np.random.default_rng(6)
    frames = []
    for i in range(5):
        pose = _make_pose(3.3 + 0.1 * i)
        pose[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.05
        frames.append({"transform_matrix": pose.tolist(), "eye_ratio": 0.2 + 0.02 * i})
    path = str(tmp_path / "pose.json")
    with open(path, "w") as f:
        json.dump({"focal_len": 90.0, "cx": 24.0, "cy": 20.0, "frames": frames}, f)
    common = dict(pose=path, aud=str(files / "aud.npy"), exp_eye=True, seed=2)
    opt, jopt = Options(**common).apply_test_mode(), JOptions(**common).apply_test_mode()
    port, want = PoseAudioDataset(opt, device="cpu"), JPoseAudioDataset(jopt)
    for k in ("poses", "intrinsics", "auds", "eye_area", "bg_img"):
        np.testing.assert_array_equal(getattr(port, k), getattr(want, k), err_msg=k)
    assert len(port) == len(want) == 7 and (port.H, port.W) == (40, 48)
    for i in range(len(port)):
        _same_batch(port.collate(i), want.collate(i))


def test_ray_helpers_exact():
    """nerf_matrix_to_ngp, smooth_camera_path, euler_xyz_to_matrix and
    polygon_area equal JAX's; draw_pixels takes the pixels JAX's get_rays
    takes and leaves the generator where it leaves it, in every mode."""
    rng = np.random.default_rng(7)
    pose = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_array_equal(rays.nerf_matrix_to_ngp(pose, 4.0, (0.1, 0.2, 0.3)),
                                  jrays.nerf_matrix_to_ngp(pose, 4.0, (0.1, 0.2, 0.3)))
    angles = rng.normal(size=(6, 3))
    mats = rays.euler_xyz_to_matrix(angles)
    np.testing.assert_array_equal(mats, jrays.euler_xyz_to_matrix(angles))
    poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    poses[:, :3, :3], poses[:, :3, 3] = mats, rng.normal(size=(6, 3))
    np.testing.assert_array_equal(rays.smooth_camera_path(poses, 5),
                                  jrays.smooth_camera_path(poses, 5))
    x, y = rng.normal(size=6), rng.normal(size=6)
    assert rays.polygon_area(x, y) == jrays.polygon_area(x, y)
    for kw in (dict(num_rays=500), dict(num_rays=512, patch_size=8),
               dict(num_rays=-1, rect=[3, 11, 5, 9]), dict(num_rays=-1)):
        r1, r2 = np.random.default_rng(8), np.random.default_rng(8)
        inds = rays.draw_pixels(40, 48, rng=r1, **kw)
        want = jrays.get_rays(pose, (50.0, 50.0, 24.0, 20.0), 40, 48, rng=r2, **kw)["inds"]
        np.testing.assert_array_equal(inds, want)
        assert r1.integers(1 << 30) == r2.integers(1 << 30)


def test_rays_from_pixels_within_one_ulp():
    """Rays of drawn pixels for rotated cameras and float64 intrinsics:
    origins exact, directions within one float32 ulp of numpy's."""
    rng = np.random.default_rng(9)
    for _ in range(4):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rays.euler_xyz_to_matrix(rng.normal(size=3))
        pose[:3, 3] = rng.normal(size=3)
        intr = np.array([rng.uniform(50, 200), rng.uniform(50, 200), 31.5, 24.25])
        want = jrays.get_rays(pose, intr, 48, 64, 2000, rng=np.random.default_rng(1))
        got = rays.rays_from_pixels(torch.from_numpy(pose), intr, torch.from_numpy(want["inds"]),
                                    64)
        np.testing.assert_array_equal(got[0].numpy(), want["rays_o"])
        np.testing.assert_array_max_ulp(got[1].numpy(), want["rays_d"], maxulp=1)


def _cv2_rgb(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 2:
        return cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
    return cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4 else cv2.COLOR_BGR2RGB)


def _each_decoder(monkeypatch):
    """Yield the decoder's name with imread's choices narrowed to it: cv2,
    PIL (cv2 hidden), the port's own PNG reader (both hidden)."""
    for name, hidden in (("cv2", ()), ("pil", ("cv2",)), ("own", ("cv2", "PIL"))):
        with monkeypatch.context() as m:
            for mod in hidden:
                m.setitem(sys.modules, mod, None)
            yield name


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["grey", "grey_alpha", "rgb", "rgba"])
def test_imread_png_matches_cv2(channels, tmp_path, monkeypatch):
    """PNGs written by cv2 (its adaptive row filters: Sub, Up, Average,
    Paeth) and by PIL decode bit for bit as cv2 decodes them through each of
    imread's decoders (cv2, PIL, the port's own reader), also under a .jpg
    name; ``imread`` is the bytes / 255 as the JAX provider's float32
    division gives them."""
    from PIL import Image

    rng = np.random.default_rng(channels)
    # smooth gradients plus noise, so the encoders pick every filter
    yy, xx = np.mgrid[0:37, 0:53]
    base = (xx * 3 + yy * 5)[..., None] + rng.integers(0, 40, (37, 53, channels))
    img = (base % 256).astype(np.uint8)
    paths = []
    if channels != 2:
        paths.append(str(tmp_path / "cv2.png"))
        cv2.imwrite(paths[-1], img[..., ::-1] if channels >= 3 else img[..., 0])
    paths.append(str(tmp_path / "pil.png"))
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(paths[-1], optimize=True)
    for p in paths:
        want = _cv2_rgb(p)
        disguised = str(tmp_path / "frame.jpg")
        with open(p, "rb") as src, open(disguised, "wb") as dst:
            dst.write(src.read())
        for decoder in _each_decoder(monkeypatch):
            np.testing.assert_array_equal(imread_u8(p), want, err_msg=f"{p} {decoder}")
            np.testing.assert_array_equal(imread_u8(disguised), want, err_msg=decoder)
            np.testing.assert_array_equal(imread(p), want.astype(np.float32) / 255.0)


def test_imread_needs_a_library_for_jpeg(tmp_path, monkeypatch):
    """JPEG content goes through cv2, through PIL without cv2 (close to
    cv2's decode), and raises ImportError naming the file without either."""
    rng = np.random.default_rng(11)
    img = cv2.GaussianBlur(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8), (7, 7), 2)
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, img)
    want = _cv2_rgb(path)
    np.testing.assert_array_equal(imread_u8(path), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    via_pil = imread_u8(path)
    assert via_pil.shape == want.shape and np.abs(via_pil.astype(int) - want).mean() < 2.0
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="a.jpg"):
        imread_u8(path)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_round_trip(channels, tmp_path, monkeypatch):
    """write_png's files decode to the same bytes through each of imread's
    decoders (cv2, PIL, the port's own reader)."""
    img = np.random.default_rng(12).integers(0, 256, (21, 34, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img[..., 0] if channels == 1 else img)
    want = np.repeat(img, 3, axis=-1) if channels == 1 else img
    np.testing.assert_array_equal(_cv2_rgb(path), want)
    for decoder in _each_decoder(monkeypatch):
        np.testing.assert_array_equal(imread_u8(path), want, err_msg=decoder)


def test_write_video_falls_back_to_pngs(tmp_path, monkeypatch):
    """Without imageio (or its mp4 writer) the frames go to numbered PNGs
    beside the video's name."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    frames = np.random.default_rng(13).integers(0, 256, (3, 8, 10, 3), dtype=np.uint8)
    paths = write_video(str(tmp_path / "clip.mp4"), frames)
    assert [os.path.basename(p) for p in paths] == [f"clip_{i:04d}.png" for i in range(3)]
    for p, f in zip(paths, frames):
        np.testing.assert_array_equal(imread_u8(p), f)
