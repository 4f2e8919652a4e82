"""The live path of the port against the JAX package's, on the CPU: the
streaming speech features (``StreamingASR`` in file mode on a seeded wav,
with a seeded stand-in acoustic model), the orbit camera, the trainer's
free-viewpoint frame (``test_gui``) at downscale 1 and 0.5, and the
interactive app over a port trainer (playing with the ASR, progressive
supersampling, the depth mode, training bursts, the MJPEG server); then the
CLIs' ``--gui`` branches with the server replaced by a few frames."""

import json
import os
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.apps.asr import StreamingASR as JStreamingASR
from radnerf_tpu.apps.asr import unfold_features as j_unfold_features
from radnerf_tpu.apps.frame_server import OrbitCamera as JOrbitCamera
from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.train import Trainer as JTrainer

from radnerf_tpu_torch import infer
from radnerf_tpu_torch.apps import InteractiveApp, OrbitCamera, StreamingASR, unfold_features
from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import load_jax_params, state_from_numpy
from radnerf_tpu_torch.data import TalkingHeadDataset, get_audio_features
from radnerf_tpu_torch.main import main
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig
from radnerf_tpu_torch.train import Trainer

from test_torch_main import _args, small  # noqa: F401  (the narrowing fixture)
from test_torch_train import GRID, SMALL, _blob_state_j, head_params  # noqa: F401
from test_train import _blob_grid, _make_pose, data_dir  # noqa: F401  (fixture)

RC = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0)
RC_J = dict(RC, exp_eye=True, sample_capacity_mult=16.0, ray_capacity_frac=1.0)
ASR = dict(m=10, l=2, r=2)


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((np.float64(a) - b) ** 2)), 1e-20))


def stand_in_logits(audio_dim=44, seed=5):
    """A seeded linear map of each 320-sample chunk to ``audio_dim`` logits:
    the acoustic model's stand-in (no weights ship with the repository)."""
    w = np.random.default_rng(seed).normal(size=(320, audio_dim)).astype(np.float32) * 0.1

    def fn(frame):
        n = len(frame) // 320
        return frame[: n * 320].reshape(n, 320) @ w

    return fn


def write_wav(path, seconds=3.0, seed=4):
    """A seeded 16 kHz int16 wav: a 220 Hz tone under noise."""
    from scipy.io import wavfile

    t = np.arange(int(16000 * seconds)) / 16000
    rng = np.random.default_rng(seed)
    wave = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=t.shape)
    wavfile.write(path, 16000, (np.clip(wave, -1, 1) * 32767).astype(np.int16))
    return path


# ------------------------------------------------------------------- ASR
def test_streaming_asr_matches_jax(tmp_path):
    """File mode, the same wav and stand-in: every attention window from the
    first frame after the warm-up to the end of the stream, bit for bit, as
    a float32 tensor of [8, 44, 16] on the requested device."""
    wav = write_wav(str(tmp_path / "a.wav"))
    port = StreamingASR(Options(asr_wav=wav, **ASR), logits_fn=stand_in_logits(), device="cpu")
    want = JStreamingASR(JOptions(asr_wav=wav, **ASR), logits_fn=stand_in_logits())
    assert port.warm_up_steps == want.warm_up_steps
    port.warm_up()
    want.warm_up()
    n = 0
    while not want.terminated:
        for asr in (port, want):
            asr.run_step()
            asr.run_step()
        got = port.get_next_feat()
        assert got.dtype == torch.float32 and got.shape == (8, 44, 16)
        np.testing.assert_array_equal(got.numpy(), want.get_next_feat())
        n += 1
    assert port.terminated and n > 60
    assert float(np.abs(got.numpy()).max()) > 0.01


def test_asr_saved_features_match_jax(tmp_path):
    """--asr_save_feats: the whole logit track unfolded into [N, 16, 44]
    windows and saved beside the wav, bit for bit; unfold_features alone."""
    saved = []
    for d, asr_cls, opt_cls, kw in (("port", StreamingASR, Options, {"device": "cpu"}),
                                    ("jax", JStreamingASR, JOptions, {})):
        os.makedirs(tmp_path / d)
        wav = write_wav(str(tmp_path / d / "a.wav"))
        asr = asr_cls(opt_cls(asr_wav=wav, asr_save_feats=True, **ASR),
                      logits_fn=stand_in_logits(), **kw)
        asr.run()
        saved.append(np.load(wav.replace(".wav", "_eo.npy")))
    assert saved[0].shape[1:] == (16, 44) and saved[0].shape[0] > 70
    np.testing.assert_array_equal(*saved)
    feats = np.random.default_rng(6).normal(size=(37, 5)).astype(np.float32)
    np.testing.assert_array_equal(unfold_features(feats), j_unfold_features(feats))


def test_asr_backends_raise_without_their_packages(tmp_path, monkeypatch):
    """Without ``transformers`` the default acoustic model raises
    ImportError, and without ``pyaudio`` the microphone and the playback
    echo do: nothing falls back to a stand-in."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "pyaudio", None)
    wav = write_wav(str(tmp_path / "a.wav"), seconds=0.5)
    with pytest.raises(ImportError):
        StreamingASR(Options(asr_wav=wav, **ASR), device="cpu")
    with pytest.raises(ImportError):
        StreamingASR(Options(asr_wav="", **ASR), logits_fn=stand_in_logits(), device="cpu")
    with pytest.raises(ImportError):
        StreamingASR(Options(asr_wav=wav, asr_play=True, **ASR), logits_fn=stand_in_logits(),
                     device="cpu")


# ---------------------------------------------------------------- camera
def test_orbit_camera_matches_jax():
    """Pose, intrinsics, orbit, scale, pan and the pose / intrinsics round
    trips equal JAX's."""
    cams = [cls(450, 450, r=3.35, fovy=21.24) for cls in (OrbitCamera, JOrbitCamera)]
    for cam in cams:
        cam.update_intrinsics(np.array([500.0, 500.0, 256.0, 256.0]))
        cam.update_pose(np.asarray(_make_pose_ngp(3.3)))
    steps = [("orbit", (100, 50)), ("scale", (1,)), ("pan", (10, -5)), ("orbit", (-30, 7)),
             ("pan", (0, 2, 3)), ("scale", (-2,))]
    for name, args in steps:
        for cam in cams:
            getattr(cam, name)(*args)
        np.testing.assert_array_equal(cams[0].pose, cams[1].pose)
        np.testing.assert_array_equal(cams[0].intrinsics, cams[1].intrinsics)
    assert not np.allclose(cams[0].pose, _make_pose_ngp(3.3))


def _make_pose_ngp(dist):
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -dist
    return pose


# ------------------------------------------------------ the free viewpoint
@pytest.fixture(scope="module")
def gui_trainers(head_params, data_dir, tmp_path_factory):  # noqa: F811
    """A port trainer and a JAX trainer holding the same narrow model and the
    blob grid; the sigma head's output weights made positive and 6x as
    large, so that the head is dense enough for a depth (the depth is the
    unnormalised composite of t)."""
    head_params = dict(head_params, sigma_net={"layers": [
        dict(layer) for layer in head_params["sigma_net"]["layers"]]})
    w = head_params["sigma_net"]["layers"][-1]["w"].copy()
    w[:, 0] = np.abs(w[:, 0]) * 6.0
    head_params["sigma_net"]["layers"][-1]["w"] = w
    opt = dict(exp_eye=True, iters=100, dt_gamma=0.0)
    ws = str(tmp_path_factory.mktemp("gui_ws"))
    jt = JTrainer("ngp", JOptions(path=data_dir, workspace=ws, auto_capacity=False, **opt),
                  net_cfg=JNetworkConfig(**SMALL), render_cfg=JRenderConfig(**RC_J),
                  params=jax.tree_util.tree_map(jnp.asarray, head_params),
                  use_checkpoint="scratch", use_tensorboard=False, mute=True)
    jt.state = _blob_state_j(JRenderConfig(**RC_J), _blob_grid(GRID), 1.0)
    tr = Trainer(Options(path=data_dir, auto_capacity=False, **opt), NetworkConfig(**SMALL),
                 RenderConfig(**RC), device="cpu")
    load_jax_params(tr.net, head_params)
    tr.state = state_from_numpy(tr.render_cfg, _blob_grid(GRID), np.zeros(GRID * GRID),
                                1.0, 0.0, thresh=1.0, device="cpu")
    return tr, jt


@pytest.mark.parametrize("downscale", [1, 0.5])
def test_test_gui_matches_jax(gui_trainers, downscale):
    """A free-viewpoint 48x48 frame of an orbit pose with an audio window,
    spp 1: image and depth within 60 dB of JAX's ``test_gui``, returned at
    48x48; a head is in the frame."""
    tr, jt = gui_trainers
    cam = OrbitCamera(48, 48, r=3.3, fovy=21.24)
    cam.update_pose(_make_pose_ngp(3.3))
    cam.orbit(40, -20)
    auds = np.random.default_rng(8).normal(size=(8, 44, 16)).astype(np.float32)
    kw = dict(auds=auds, eye=0.3, spp=1, downscale=downscale)
    got = tr.test_gui(cam.pose, cam.intrinsics, 48, 48, **kw)
    want = jt.test_gui(cam.pose, cam.intrinsics, 48, 48, **kw)
    for k in ("image", "depth"):
        assert got[k].shape == np.asarray(want[k]).shape == ((48, 48, 3) if k == "image"
                                                            else (48, 48))
    assert _psnr(got["image"], np.asarray(want["image"])) >= 60.0
    assert _psnr(got["depth"], np.asarray(want["depth"])) >= 60.0
    assert float((got["depth"] > 0.1).mean()) > 0.1  # the head is in the frame


# ------------------------------------------------------------ the app
@pytest.fixture
def app_parts(gui_trainers, data_dir, tmp_path):  # noqa: F811
    tr, _ = gui_trainers
    ds = TalkingHeadDataset(tr.opt, split="val", device="cpu")
    ds.training, ds.num_rays = False, -1
    wav = write_wav(str(tmp_path / "a.wav"), seconds=2.0)
    asr = StreamingASR(Options(asr_wav=wav, **ASR), logits_fn=stand_in_logits(), device="cpu")
    return tr, ds, asr


def test_interactive_app_plays_accumulates_and_shows_depth(app_parts):
    """Playing with the ASR: a fresh frame each step, two ASR steps each;
    a static view averages perturbed frames (the buffer is their mean) up
    to max_spp, then stays; the depth mode shows a normalised depth; a
    downscaled frame comes back at the view's size."""
    tr, ds, asr = app_parts
    opt = Options(exp_eye=True, max_spp=3, **ASR)
    frames = []
    app = InteractiveApp(opt, tr, ds, frame_callback=frames.append, asr=asr)
    asr.warm_up()
    app.run(max_frames=3)
    assert app.playing and len(frames) == 3 and asr.idx == (asr.warm_up_steps + 6) * 320
    assert all(f.shape == (64, 64, 3) and np.isfinite(f).all() for f in frames)

    app.playing, app.need_update = False, True
    perturbed = []
    for spp in (1, 1, 2):  # a fresh frame, then the seeds 1 and 2
        perturbed.append(tr.test_gui(app.cam.pose, app.cam.intrinsics, 64, 64,
                                     auds=get_audio_features(ds.auds, 2, 0),
                                     eye=app.eye_area, bg_color=app.bg_color,
                                     spp=spp)["image"])
    outs = [app.render_frame() for _ in range(4)]
    assert app.spp == 3
    np.testing.assert_allclose(app.render_buffer, np.mean(perturbed, 0), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(outs[3], outs[2])  # full: no further render
    assert not np.array_equal(perturbed[0], perturbed[2])

    app.mode = "depth"
    depth = app.render_frame()
    assert app.spp == 1 and depth.shape == (64, 64, 3)
    assert float(depth.min()) == 0.0 and float(depth.max()) == 1.0
    app.mode, app.downscale = "image", 0.5
    half = app.render_frame()
    assert half.shape == (64, 64, 3) and np.isfinite(half).all()


def test_train_gui_runs_steps(gui_trainers, data_dir):  # noqa: F811
    """A training burst over the dataset's epoch order: the untrained cells
    marked at step 0, the upkeep when due, ``step`` steps and a finite mean
    loss."""
    _, jt = gui_trainers
    opt = Options(path=data_dir, exp_eye=True, iters=100, dt_gamma=0.0, num_rays=256,
                  update_extra_interval=4)
    tr = Trainer(opt, NetworkConfig(**SMALL), RenderConfig(**RC), device="cpu")
    ds = TalkingHeadDataset(opt, split="train", device="cpu")
    out = tr.train_gui(ds, step=6)
    assert tr.global_step == 6 and np.isfinite(out["loss"])
    assert len(tr.stats["mean_density"]) == 2  # the upkeeps at steps 0 and 4
    assert bool((tr.state.density_grid == -1).any())  # cells no camera sees


def test_serve_streams_jpeg_frames(app_parts):
    """``serve`` on a free port from a thread: the page, then two JPEG parts
    of /stream; ``stop`` ends the server and its thread."""
    from PIL import Image
    import io

    tr, ds, _ = app_parts
    app = InteractiveApp(Options(exp_eye=True), tr, ds)
    thread = threading.Thread(target=app.serve, kwargs={"port": 0})
    thread.start()
    try:
        assert app.serving.wait(30)
        url = f"http://127.0.0.1:{app.server.server_address[1]}"
        with urllib.request.urlopen(url + "/", timeout=30) as r:
            assert b'<img src="/stream">' in r.read()
        parts = []
        with urllib.request.urlopen(url + "/stream", timeout=60) as r:
            assert r.headers["Content-Type"].startswith("multipart/x-mixed-replace")
            while len(parts) < 2:
                assert r.readline() == b"--frame\r\n"
                assert r.readline() == b"Content-Type: image/jpeg\r\n"
                n = int(r.readline().split(b":")[1])
                assert r.readline() == b"\r\n"
                parts.append(r.read(n))
                assert r.readline() == b"\r\n"
    finally:
        app.stop()
        thread.join(30)
    assert not thread.is_alive()
    for data in parts:
        assert Image.open(io.BytesIO(data)).size == (64, 64)


# ------------------------------------------------------------- the CLIs
def test_cli_gui_branches(small, data_dir, tmp_path, monkeypatch):  # noqa: F811
    """``--test --gui --asr`` serves the test split driven by the ASR (the
    acoustic model given as ``logits_fn``), ``infer --gui --asr`` the pose
    json without --aud, and training with ``--gui`` trains while it
    renders; the server is replaced by a viewer that sets the app's
    training steps a frame (a control the GUI has) to 2 and runs 2 frames."""
    apps = []

    def serve(self, host="127.0.0.1", port=8965):
        apps.append(self)
        self.train_steps = 2
        self.run(max_frames=2)

    monkeypatch.setattr(InteractiveApp, "serve", serve)
    ws = str(tmp_path / "ws")
    wav = write_wav(str(tmp_path / "a.wav"), seconds=1.0)
    asr = ["--asr", "--asr_wav", wav, "-m", "10", "-l", "2", "-r", "2"]
    tr = main(_args(data_dir, ws, "--test", "--gui", "--ckpt", "scratch", *asr), device="cpu",
              logits_fn=stand_in_logits())
    app = apps[-1]
    assert not tr.metrics and not app.training
    assert app.asr is not None and app.playing and app.asr.idx > 0
    assert app.render_buffer.shape == (64, 64, 3)

    pose_path = str(tmp_path / "pose.json")
    with open(pose_path, "w") as f:
        json.dump({"focal_len": 100.0, "cx": 32.0, "cy": 32.0,
                   "frames": [{"transform_matrix": _make_pose().tolist()}] * 3}, f)
    fps = infer.main(["--pose", pose_path, "--workspace", ws, "--exp_eye", "--gui", *asr,
                      "--ckpt", "scratch"], device="cpu", logits_fn=stand_in_logits())
    assert fps > 0 and apps[-1].asr is not None and apps[-1].audio_features is None

    tt = main(_args(data_dir, str(tmp_path / "ws2"), "--gui", "--ckpt", "scratch"),
              device="cpu")
    assert apps[-1].training and tt.global_step == 2 * 2
