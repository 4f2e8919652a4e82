"""The comparison that decides ``correct`` has to fail: a run with the timed
path broken underneath (the card check skipped, everything else as a run)
and the control (the reference in the precision below the configuration's)
come out not correct.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import pytest
import torch

import radnerf_tpu_torch.models.renderer as renderer
import radnerf_tpu_torch.train.trainer as trainer_mod
from portbench import run as prun
from portbench.harness import common
from portbench.tests.test_portbench_harness import card, measure, on_the_cpu, tiny  # noqa: F401


def test_an_altered_frame_is_caught(monkeypatch):
    """A frame altered where it is produced: the compositor's image off by
    a little in one channel."""
    composite = renderer.composite_rays

    def altered(*args, **kw):
        out = composite(*args, **kw)
        return dict(out, image=out["image"] * torch.tensor([1.0, 1.0, 0.98]))

    monkeypatch.setattr(renderer, "composite_rays", altered)
    out = measure("render512_fp32")
    assert not out["correct"], out["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = measure("train_head_fp32")
    assert not out["correct"], out["checks"]


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    """The loss's mean taken over the first half of the rays."""
    loss = trainer_mod.head_loss

    def half(results, gt, mask, *args, **kw):
        h = gt.shape[0] // 2
        cut = {k: (v[:h] if torch.is_tensor(v) and v.dim() and v.shape[0] == gt.shape[0] else v)
               for k, v in results.items()}
        return loss(cut, gt[:h], mask[:h], *args, **kw)

    monkeypatch.setattr(trainer_mod, "head_loss", half)
    out = measure("train_head_fp32")
    assert not out["correct"], out["checks"]


def test_an_upkeep_skipped_in_the_window_is_caught(monkeypatch):
    """The window's upkeep left out: the density grid stays as the warm-up
    left it."""
    update = trainer_mod.Trainer.update_extra_state
    warm = tiny("train_head_fp32")["traffic"]["warmup_steps"]

    def skipped(self, dataset):
        if self.global_step < warm:
            update(self, dataset)

    monkeypatch.setattr(trainer_mod.Trainer, "update_extra_state", skipped)
    out = measure("train_head_fp32")
    limit = prun.load_limits("train_head_fp32")["window.grid_gap"]
    assert out["res"]["checks"]["window.grid_gap"] > limit
    assert not out["correct"], out["checks"]


def _control_fails(cell, on_cpu, seed=2**31 + 21):
    ctx = tiny(cell)
    generator = common.generator(ctx["traffic"]["kind"])
    with pytest.MonkeyPatch.context() as mp:
        if on_cpu:
            on_the_cpu(mp)
        else:
            common.prepare_program()
        res = generator.run(ctx, seed, 0.5, False)
        got = generator.controls(ctx, res)
    limits = prun.load_limits(cell)
    failed = [n for n, lim in limits.items() if got[f"control.{n}"] > lim]
    assert failed, (got, limits)


@pytest.mark.parametrize("cell", ["render512_O", "train_head_O"])
def test_the_fp8_control_fails(cell):
    _control_fails(cell, True)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["render512_fp32", "train_head_fp32"])
def test_the_tf32_control_fails(card, cell):  # noqa: F811
    _control_fails(cell, False)
