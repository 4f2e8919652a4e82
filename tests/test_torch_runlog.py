"""The port trainer's run log and tensorboard scalars against the JAX
trainer's, on the CPU: tests/test_train.py's 64x64 on-disk dataset,
tests/test_torch_train.py's narrow model (grid 32, both at exhaustive
capacities, no adaptation), 16 steps (4 epochs of 4 frames) and one evaluation, then a
second trainer of each resuming from the first's workspace, then the test
split rendered. A recording ``tensorboardX`` module stands in for the real
one, whether or not it is installed."""

import math
import os
import sys
import types

import jax
import numpy as np
import pytest

from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.data import TalkingHeadDataset as JTalkingHeadDataset
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import init_params
from radnerf_tpu.train import LMDMeter as JLMDMeter
from radnerf_tpu.train import LPIPSMeter as JLPIPSMeter
from radnerf_tpu.train import PSNRMeter as JPSNRMeter
from radnerf_tpu.train import Trainer as JTrainer

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.data import TalkingHeadDataset
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig
from radnerf_tpu_torch.train import LMDMeter, LPIPSMeter, PSNRMeter, Trainer

from test_torch_train import GRID, SMALL
from test_train import data_dir  # noqa: F401  (the on-disk dataset fixture)

# both packages at exhaustive capacities: a checkpoint carries them to the
# other trainer
RC = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=0.0,
          sample_capacity_mult=16.0, ray_capacity_frac=1.0)
RC_J = dict(RC, exp_eye=True)
OPT = dict(num_rays=512, exp_eye=True, iters=100, dt_gamma=0.0, cull_T=0.0)
EPOCHS = 4  # 16 steps: the scalars of step 16


class RecordingWriter:
    """``tensorboardX.SummaryWriter``'s calls, kept in ``calls``."""

    calls = []

    def __init__(self, logdir):
        self.calls.append(("open", logdir))

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))

    def close(self):
        self.calls.append(("close",))


def _words(line: str) -> list:
    """A log line's words: no numbers, key=value figures, time stamps or
    paths."""
    return [w for w in line.split()
            if not any(c.isdigit() for c in w) and "/" not in w and "=" not in w]


def _run(make_trainer, datasets, ws):
    """Train EPOCHS epochs with one evaluation, render the test split,
    resume a second trainer from the workspace; returns (the log's lines,
    the writer's calls with the workspace taken out of the log
    directory)."""
    RecordingWriter.calls = []
    train, val, test = datasets
    tr = make_trainer(ws, "latest")
    tr.train(train, val, EPOCHS)
    tr.test(test, write_image=False)
    make_trainer(ws, "latest")
    with open(os.path.join(ws, "log_ngp.txt")) as fh:
        lines = fh.read().splitlines()
    calls = [(c[0], os.path.relpath(c[1], ws)) if c[0] == "open" else c
             for c in RecordingWriter.calls]
    return lines, calls


@pytest.fixture(scope="module")
def runs(data_dir, tmp_path_factory):  # noqa: F811
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "tensorboardX",
               types.SimpleNamespace(SummaryWriter=RecordingWriter))
    root = tmp_path_factory.mktemp("runlog")
    # JAX's trainer draws its parameters op by op (~14 s of compiles): it
    # takes a jitted draw, and restores as its constructor would without one
    params = jax.jit(lambda k: init_params(k, JNetworkConfig(**SMALL)))(jax.random.PRNGKey(0))
    try:
        def jax_trainer(ws, ckpt):
            jt = JTrainer("ngp", JOptions(path=data_dir, workspace=ws, auto_capacity=False,
                                          **OPT),
                          net_cfg=JNetworkConfig(**SMALL), render_cfg=JRenderConfig(**RC_J),
                          params=params, metrics=[JPSNRMeter()], workspace=ws,
                          eval_interval=EPOCHS, use_checkpoint=ckpt, mute=True)
            jt._restore(ckpt)
            return jt

        def port_trainer(ws, ckpt):
            return Trainer(Options(path=data_dir, auto_capacity=False, **OPT),
                           NetworkConfig(**SMALL), RenderConfig(**RC), device="cpu",
                           metrics=[PSNRMeter()],
                           workspace=ws, eval_interval=EPOCHS, use_checkpoint=ckpt, mute=True)

        def datasets(cls, opt, **kw):
            out = [cls(opt(path=data_dir, **OPT), split=s, **kw) for s in ("train", "val",
                                                                            "test")]
            out[1].eval_count = 1
            return out

        want = _run(jax_trainer, datasets(JTalkingHeadDataset, JOptions), str(root / "jax"))
        got = _run(port_trainer, datasets(TalkingHeadDataset, Options, device="cpu"),
                   str(root / "port"))
    finally:
        mp.undo()
    return got, want


def test_log_file_holds_jax_event_lines(runs):
    """Both workspaces' log_ngp.txt hold the same event lines in the same
    order, word for word once numbers, time stamps and paths are taken out:
    the banner and the parameter count, no checkpoint found, each epoch's
    start and end (with the last step's hits and samples), the evaluation,
    the test, the resumed trainer's restored capacities, optimizer state and
    checkpoint."""
    (got, _), (want, _) = runs
    assert [_words(l) for l in got] == [_words(l) for l in want]
    assert got[0].startswith("[INFO] Trainer: ngp | ") and " | cpu | fp32 | " in got[0]
    for event in ("==> Start Training Epoch 4 ...", "++> Evaluate at epoch 4 ...",
                  "[WARN] No checkpoint found, model randomly initialized.",
                  "[INFO] restored optimizer state.", "==> Finished Test."):
        assert event in got and event in want, event
    assert sum(l.startswith("==> Finished Epoch") for l in got) == EPOCHS


def test_tensorboard_scalars_match_jax(runs):
    """With a tensorboardX module, both trainers open a writer at
    <workspace>/run/ngp, write train/loss and train/lr at step 16 (the lr of
    the grid group exactly JAX's, the loss finite), evaluate/PSNR at epoch
    4, and close it; the test writes nothing."""
    (_, got), (_, want) = runs
    assert [c[0] for c in got] == [c[0] for c in want] == [
        "open", "train/loss", "train/lr", "evaluate/PSNR", "close"]
    assert got[0] == want[0] == ("open", os.path.join("run", "ngp"))
    for g, w in zip(got[1:4], want[1:4]):
        assert g[2] == w[2] and math.isfinite(g[1]) and math.isfinite(w[1])
    assert [c[2] for c in got[1:4]] == [16, 16, EPOCHS]
    assert got[2][1] == want[2][1] == Options().lr * 0.1 ** (16 / OPT["iters"])


def test_mute_silences_stdout_only(tmp_path, capsys):
    """mute keeps the log lines off stdout and in the file; unmuted, they go
    to both; without a workspace no file is written."""
    for mute in (True, False):
        ws = str(tmp_path / f"m{int(mute)}")
        tr = Trainer(Options(**OPT), NetworkConfig(**SMALL), RenderConfig(**RC), device="cpu",
                     workspace=ws, mute=mute, use_checkpoint="scratch")
        tr.log("==> a line")
        out = capsys.readouterr().out
        with open(os.path.join(ws, "log_ngp.txt")) as fh:
            lines = fh.read().splitlines()
        assert lines[-2:] == ["[INFO] Training from scratch ...", "==> a line"]
        assert lines[0].startswith("[INFO] Trainer: ngp")
        assert (out == "") if mute else (out.splitlines() == lines)
    Trainer(Options(**OPT), NetworkConfig(**SMALL), RenderConfig(**RC), device="cpu")
    assert "[INFO] #parameters" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["m0", "m1"]


def test_meter_tags_match_jax():
    """Each meter writes its measure under JAX's tag: {prefix}/PSNR,
    {prefix}/LPIPS<backend> and {prefix}/LMD (<backend>); the LPIPS backend
    is " (alex)" on calibrated filters and names its own uncalibrated ones
    (uncalibrated-torch against uncalibrated-jax). JAX's LPIPS meter holds a
    stand-in for its network: its write reads only the measure and the
    calibration."""

    class Predictor:
        def get_landmarks(self, img):
            return [np.zeros((68, 2), np.float32)]

    def jax_lpips(calibrated):
        m = JLPIPSMeter.__new__(JLPIPSMeter)
        m.lpips = types.SimpleNamespace(calibrated=calibrated)
        m.clear()
        return m

    port_lpips = LPIPSMeter(device="cpu"), LPIPSMeter(device="cpu")
    port_lpips[1].lpips.calibrated = True
    writer = RecordingWriter("")
    RecordingWriter.calls = []
    for meter in (PSNRMeter(), *port_lpips, LMDMeter(predictor=Predictor())):
        meter.write(writer, 7, prefix="evaluate")
    port, RecordingWriter.calls = RecordingWriter.calls, []
    for meter in (JPSNRMeter(), jax_lpips(False), jax_lpips(True),
                  JLMDMeter(predictor=Predictor())):
        meter.write(writer, 7, prefix="evaluate")
    jax = RecordingWriter.calls
    assert [c[0] for c in port] == ["evaluate/PSNR", "evaluate/LPIPS (uncalibrated-torch)",
                                    "evaluate/LPIPS (alex)", "evaluate/LMD (fan)"]
    assert [c[0].replace("-jax", "-torch") for c in jax] == [c[0] for c in port]
    assert [c[1:] for c in port] == [c[1:] for c in jax] == [(0.0, 7)] * 4
