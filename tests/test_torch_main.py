"""The port's entry points on the CPU (``device="cpu"``), on
tests/test_train.py's 64x64 on-disk dataset: ``main`` trains (train ->
evaluate -> best checkpoint -> test split evaluated and rendered), then runs
``--test``; ``infer`` renders a pose json with audio features from the best
checkpoint, one frame per audio row; what the entry points still refuse.

The narrow test model goes in through ``NetworkConfig.from_options`` and
``RenderConfig.from_options``, wrapped to take tests/test_torch_train.py's
widths and a 32^3 grid: the CLI has no flag for either (the reference's
widths are fixed, its grid is 128^3)."""

import dataclasses
import json
import os

import numpy as np
import pytest

from radnerf_tpu_torch import infer
from radnerf_tpu_torch.main import main
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig

from test_torch_train import GRID, SMALL
from test_train import _make_pose, data_dir  # noqa: F401  (the on-disk dataset fixture)


@pytest.fixture
def small(monkeypatch):
    net_from, rc_from = NetworkConfig.from_options, RenderConfig.from_options
    narrow = {k: v for k, v in SMALL.items() if k not in ("exp_eye", "ind_num")}
    monkeypatch.setattr(NetworkConfig, "from_options",
                        staticmethod(lambda opt: dataclasses.replace(net_from(opt), **narrow)))
    monkeypatch.setattr(RenderConfig, "from_options", staticmethod(
        lambda opt: dataclasses.replace(rc_from(opt), grid_size=GRID, max_steps=8)))


def _args(data_dir, ws, *extra):  # noqa: F811
    return [data_dir, "--workspace", ws, "--exp_eye", "--num_rays", "256", "--dt_gamma", "0",
            "--update_extra_interval", "2", "--ema_update_interval", "2", *extra]


def test_main_trains_evaluates_and_tests(small, data_dir, tmp_path):  # noqa: F811
    """Training mode at --iters 8 over the 4 frames: 2 epochs, evaluation at
    the last (eval_interval = min(5000 / 4, 2)), the epoch and best
    checkpoints, the validation PNGs, the test split evaluated and its
    frames written; then --test from the latest checkpoint, and infer."""
    ws = str(tmp_path / "ws")
    tr = main(_args(data_dir, ws, "--iters", "8", "--preload", "2", "--ckpt", "scratch"),
              device="cpu")
    assert tr.global_step == 8 and tr.epoch == 2 and tr.eval_interval == 2
    assert np.all(np.isfinite(tr.stats["step_loss"]))
    # the eval at epoch 2, then the test split's
    assert len(tr.stats["results"]) == 2 and np.all(np.isfinite(tr.stats["results"]))
    assert [type(m).__name__ for m in tr.metrics] == ["PSNRMeter", "LPIPSMeter"]
    assert sorted(os.listdir(tr.ckpt_path)) == ["ngp.npz", "ngp_ep0001.npz", "ngp_ep0002.npz"]
    assert len(os.listdir(os.path.join(ws, "validation"))) == 2 * 4  # rgb + depth, 4 frames
    assert sorted(os.listdir(os.path.join(ws, "results"))) == \
        [f"ngp_ep0002_{i:04d}.png" for i in range(4)]

    tt = main(_args(data_dir, ws, "--test"), device="cpu")
    assert tt.epoch == 2 and tt.opt.smooth_path and tt.opt.smooth_lips
    assert len(tt.stats["results"]) == 1 and np.isfinite(tt.stats["valid_loss"][0])

    rng = np.random.default_rng(21)
    pose_path, aud_path = str(tmp_path / "pose.json"), str(tmp_path / "aud.npy")
    with open(pose_path, "w") as f:
        json.dump({"focal_len": 100.0, "cx": 32.0, "cy": 32.0,
                   "frames": [{"transform_matrix": _make_pose().tolist()}] * 3}, f)
    np.save(aud_path, rng.normal(size=(5, 16, 44)).astype(np.float32))
    out = str(tmp_path / "infer")
    fps = infer.main(["--pose", pose_path, "--aud", aud_path, "--workspace", out, "--exp_eye",
                      "--ckpt", os.path.join(tr.ckpt_path, "ngp.npz")], device="cpu")
    assert fps > 0
    assert sorted(os.listdir(os.path.join(out, "results"))) == \
        [f"ngp_ep0002_{i:04d}.png" for i in range(5)]


def test_entry_points_refuse_what_is_not_ported(small, data_dir, tmp_path):  # noqa: F811
    """Every flag of the JAX CLIs is ported now; what the entry points still
    refuse: infer needs --pose, and --aud unless --asr streams the audio
    (infer --asr without --gui renders the poses with no audio, as JAX's
    does); without ``device`` the entry point asks for the card, and raises
    here."""
    with pytest.raises(SystemExit):
        infer.main(["--pose", "p.json"], device="cpu")  # no --aud
    with pytest.raises(SystemExit):
        infer.main(["--aud", "a.npy"], device="cpu")  # no --pose
    pose_path, out = str(tmp_path / "pose.json"), str(tmp_path / "asr")
    with open(pose_path, "w") as f:
        json.dump({"focal_len": 100.0, "cx": 32.0, "cy": 32.0,
                   "frames": [{"transform_matrix": _make_pose().tolist()}] * 2}, f)
    fps = infer.main(["--pose", pose_path, "--asr", "--workspace", out, "--exp_eye",
                      "--ckpt", "scratch"], device="cpu")
    assert fps > 0 and len(os.listdir(os.path.join(out, "results"))) == 4
    ws = str(tmp_path / "ws")
    for flag in ("--train_camera", "--gui"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(_args(data_dir, ws, flag, "--iters", "4"))
