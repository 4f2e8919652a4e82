"""Head-stage trainer (counterpart of ``radnerf_tpu/train/trainer.py``;
reference nerf/utils.py:570-1427 and main.py:142-219).

A train step renders a batch of rays with ``render_rays(training=True)``
(the perturbation noises from a ``torch.Generator`` on the device), takes
``head_loss``, runs autograd back through the compositor (kernel C'), the
MLPs and the grid encodes (kernel A'), and steps a per-group Adam (betas
0.9/0.99, eps 1e-15) whose learning rates decay as ``base_lr * 0.1 **
(step / iters)``. Every ``update_extra_interval`` steps, before the step,
the head density grid is refreshed (``update_density_grid``) with a random
audio window and eye value; ``train`` first marks the cells no training
camera sees (``mark_untrained_grid``). An optional EMA of the parameters
follows the JAX trainer.

The dataset is any object with ``collate(i)``, ``epoch_indices()``,
``poses`` [B, 4, 4], ``intrinsics`` (fx, fy, cx, cy), ``auds`` (per-frame
features or None) and ``eye_area`` ([B, 1] or None), all numpy, as the JAX
``TalkingHeadDataset`` gives them. The torso stage, LPIPS, lips finetune,
patch training, checkpoints and the eval/test loops are not ported and
raise or are absent. There is no capacity adaptation: the port never drops
work, so it has no static capacity to size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..data.rays import get_audio_features
from ..device import resolve_device
from ..models import (
    NeRFNetwork,
    NetworkConfig,
    RenderConfig,
    RendererState,
    mark_untrained_grid,
    param_groups,
    render_rays,
    update_density_grid,
)
from ..utils.color import srgb_to_linear
from .losses import head_loss

TELEMETRY = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span")


def build_optimizer(net: NeRFNetwork, opt: Options):
    """Per-group Adam with exponential LR decay (main.py:204, 216-219).

    Returns (optimizer, scheduler). Step the scheduler after each optimizer
    step: the first update runs at the base rate, as optax's schedule
    (count 0 at the first update) does."""
    group_lr = {"grid": opt.lr, "net": opt.lr_net, "att": opt.lr_net * 5, "camera": 1e-5}
    groups = param_groups(net.cfg)
    params = {}
    for name, p in net.named_parameters():
        group = groups.get(name.split(".")[0], "net")
        if group == "frozen":
            p.requires_grad_(False)
        else:
            params.setdefault(group, []).append(p)
    optimizer = torch.optim.Adam(
        [{"params": ps, "lr": group_lr[g], "name": g} for g, ps in params.items()],
        betas=(0.9, 0.99), eps=1e-15)
    iters = opt.iters
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: 0.1 ** (step / iters))
    return optimizer, scheduler


class Trainer:
    """Head-stage training on one device.

    Args:
      opt: the options (``Options``); ``opt.seed`` seeds the network's
        initial draw, the march noises and the grid jitter.
      net_cfg, render_cfg: default from ``opt``.
      device: "cuda" by default, which raises without a card.
      ema_decay: keep an EMA of the parameters, updated every
        ``opt.ema_update_interval`` steps.
    """

    def __init__(self, opt: Options, net_cfg: Optional[NetworkConfig] = None,
                 render_cfg: Optional[RenderConfig] = None, device="cuda",
                 ema_decay: Optional[float] = None):
        if opt.torso:
            raise NotImplementedError("the torso stage is not ported")
        if opt.finetune_lips or opt.patch_size > 1:
            raise NotImplementedError("the LPIPS term (lips finetune, patch training) "
                                      "is not ported")
        self.opt = opt
        self.device = resolve_device(device)
        self.net_cfg = net_cfg or NetworkConfig.from_options(opt)
        self.render_cfg = render_cfg or RenderConfig.from_options(opt)
        self.net = NeRFNetwork(self.net_cfg, device=self.device,
                               generator=torch.Generator().manual_seed(opt.seed))
        self.state = RendererState.create(self.render_cfg, self.net_cfg.audio_dim,
                                          self.device)
        self.optimizer, self.scheduler = build_optimizer(self.net, opt)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(opt.seed)
        self.grid_gen = torch.Generator(device=self.device).manual_seed(opt.seed + 1)
        self.ema_decay = ema_decay
        self.ema_params = ({k: v.detach().clone() for k, v in self.net.named_parameters()}
                           if ema_decay else None)
        self.epoch = 0
        self.global_step = 0
        # per-epoch mean losses, every step's loss, the mean density after
        # each grid upkeep
        self.stats = {"loss": [], "step_loss": [], "mean_density": []}
        self.telemetry = {}

    # ----------------------------------------------------------- batches
    def to_device(self, batch: dict) -> dict:
        """numpy batch -> tensors on the trainer's device (float32, the face
        mask bool); ``index`` becomes an int, None stays None."""
        out = {}
        for k, v in batch.items():
            if k in ("H", "W", "rect") or v is None:
                out[k] = v
            elif k == "index":
                out[k] = int(v)
            elif k == "face_mask":
                out[k] = torch.as_tensor(np.asarray(v, bool)).to(self.device)
            else:
                out[k] = torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
        return out

    def render(self, batch: dict, noises: Optional[torch.Tensor],
               state: Optional[RendererState] = None):
        """``render_rays(training=True)`` on a device batch, with the
        trainer's state unless another is given."""
        state = self.state if state is None else state
        return render_rays(self.net, self.render_cfg, state, batch["rays_o"],
                           batch["rays_d"], batch.get("auds"), batch["bg_coords"],
                           batch["poses"], batch.get("eye"), batch["index"],
                           batch["bg_color"], noises=noises, training=True)[0]

    def loss(self, batch: dict, noises: Optional[torch.Tensor], global_step: int,
             state: Optional[RendererState] = None):
        """(loss, results) of the head stage on a device batch."""
        results = self.render(batch, noises, state)
        gt = batch["images"]
        if self.opt.color_space == "linear":
            gt = srgb_to_linear(gt)
        loss = head_loss(results, gt, batch["face_mask"], global_step, self.opt.iters,
                         self.opt.lambda_amb)
        return loss, results

    def draw_noises(self, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self.noise_gen, device=self.device)

    # -------------------------------------------------------------- step
    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimisation step on a device batch at ``self.global_step``
        (already counted); returns the loss (a device scalar, no sync) and
        keeps the step's telemetry in ``self.telemetry``."""
        noises = self.draw_noises(batch["rays_o"].shape[0])
        loss, results = self.loss(batch, noises, self.global_step)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.telemetry = {k: results[k] for k in TELEMETRY}
        if self.ema_params is not None and \
                self.global_step % self.opt.ema_update_interval == 0:
            d = self.ema_decay
            with torch.no_grad():
                for k, p in self.net.named_parameters():
                    self.ema_params[k].mul_(d).add_(p.detach(), alpha=1.0 - d)
        return loss.detach()

    # ------------------------------------------------------ grid upkeep
    def update_extra_state(self, dataset):
        """The head grid's upkeep (update_extra_state, renderer.py:383-501):
        a random audio window and that frame's eye value condition the
        density queries."""
        rng = np.random.default_rng(int(self.global_step) + self.opt.seed)
        auds, ridx = None, 0
        if dataset.auds is not None:
            ridx = int(rng.integers(0, dataset.auds.shape[0]))
            auds = torch.as_tensor(get_audio_features(dataset.auds, self.opt.att, ridx),
                                   dtype=torch.float32).to(self.device)
        eye = None
        if self.opt.exp_eye and dataset.eye_area is not None:
            eye = torch.as_tensor(np.asarray(dataset.eye_area[ridx], np.float32)
                                  .reshape(1, 1)).to(self.device)
        with torch.no_grad():
            enc_a = self.net.encode_audio(auds)
        self.state = update_density_grid(self.net, self.render_cfg, self.state, enc_a, eye,
                                         generator=self.grid_gen)
        self.stats["mean_density"].append(float(self.state.mean_density))

    # ------------------------------------------------------------ loops
    def train(self, train_ds, max_epochs: int):
        """Mark the untrained cells from the dataset's cameras, then run
        epochs up to ``max_epochs``."""
        self.state = mark_untrained_grid(self.render_cfg, self.state, train_ds.poses,
                                         tuple(train_ds.intrinsics))
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(train_ds)

    def next_batch(self, dataset, idx) -> dict:
        """The dataset's batch ``idx`` on the trainer's device."""
        return self.to_device(dataset.collate(int(idx)))

    def step(self, dataset, idx) -> torch.Tensor:
        """One step of the loop: the grid upkeep when it is due, then a
        train step on the dataset's batch ``idx``; returns the loss (a
        device scalar, no sync)."""
        if self.global_step % self.opt.update_extra_interval == 0:
            self.update_extra_state(dataset)
        self.global_step += 1
        return self.train_step(self.next_batch(dataset, idx))

    def train_one_epoch(self, dataset) -> list:
        """One pass over ``dataset.epoch_indices()``; returns the step
        losses as floats."""
        losses = [self.step(dataset, idx) for idx in dataset.epoch_indices()]
        losses = torch.stack(losses).tolist() if losses else []
        self.stats["loss"].append(float(np.mean(losses)) if losses else 0.0)
        self.stats["step_loss"].extend(losses)
        return losses
