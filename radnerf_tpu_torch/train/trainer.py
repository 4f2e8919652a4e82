"""Trainer of the head and torso stages (counterpart of
``radnerf_tpu/train/trainer.py``; reference nerf/utils.py:570-1427 and
main.py:142-219).

A train step renders a batch of rays with ``render_rays(training=True)``
(the perturbation noises from a ``torch.Generator`` on the device), takes
the stage's loss, runs autograd back and steps a per-group Adam (betas
0.9/0.99, eps 1e-15) whose learning rates decay as ``base_lr * 0.1 **
(step / iters)``. The head stage's loss is ``head_loss``: autograd runs
through the compositor (kernel C'), the MLPs and the grid encodes (kernel
A'). The torso stage (``opt.torso``) starts from a head checkpoint
(``freeze_loaded_head``), freezes every head parameter and fits the torso
layer to the torso plate with ``torso_loss``: autograd runs through the
torso MLPs and its grid encode (A', table and x). Every
``update_extra_interval`` steps, before the step, the stage's grid is
refreshed: the head density grid (``update_density_grid``, with a random
audio window and eye value) or the torso alpha grid (``update_torso_grid``,
with a random pose and its torso code); ``train`` first marks the cells no
training camera sees (``mark_untrained_grid``). An optional EMA of the
parameters follows the JAX trainer.

Checkpoints are the JAX package's flat ``.npz`` (``checkpoint.py``): with a
workspace, ``train`` writes a full one after every epoch into
``<workspace>/checkpoints`` (a rolling window of ``max_keep_ckpt``), and the
constructor restores one as ``use_checkpoint`` selects. A checkpoint of
either package, or a reference ``.pth``, loads with ``load_checkpoint``.

The dataset is any object with ``collate(i)``, ``epoch_indices()``,
``poses`` [B, 4, 4], ``intrinsics`` (fx, fy, cx, cy), ``auds`` (per-frame
features or None) and ``eye_area`` ([B, 1] or None), all numpy, as the JAX
``TalkingHeadDataset`` gives them; in the torso stage its batches carry
``bg_torso_color``. LPIPS, lips finetune, patch training and the eval/test
loops are not ported and raise or are absent. There is no capacity
adaptation: the port never drops work, so it has no static capacity to size.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..convert import jax_from_state_dict, load_jax_params, network_to_jax, _state_dict_from_jax
from ..data.rays import convert_poses, get_audio_features
from ..device import resolve_device
from ..models import (
    NeRFNetwork,
    NetworkConfig,
    RenderConfig,
    RendererState,
    compute_occ_bbox,
    compute_occ_sphere,
    mark_untrained_grid,
    param_groups,
    render_rays,
    update_density_grid,
    update_torso_grid,
)
from ..ops import build_sigma_bytes, packbits, unpackbits
from ..utils.color import srgb_to_linear
from . import checkpoint as ckpt_lib
from .losses import head_loss, torso_loss


def build_optimizer(net: NeRFNetwork, opt: Options, step: int = 0):
    """Per-group Adam with exponential LR decay (main.py:204, 216-219);
    parameters of the 'frozen' group get ``requires_grad_(False)`` and no
    place in it.

    Returns (optimizer, scheduler), the schedule at ``step`` (a resumed
    run's count of updates). Step the scheduler after each optimizer step:
    the first update runs at the base rate, as optax's schedule (count 0 at
    the first update) does."""
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
        [{"params": ps, "lr": group_lr[g], "initial_lr": group_lr[g], "name": g}
         for g, ps in params.items()],
        betas=(0.9, 0.99), eps=1e-15)
    iters = opt.iters
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda s: 0.1 ** (s / iters), last_epoch=step - 1)
    return optimizer, scheduler


def _to_tensor(v, device) -> torch.Tensor:
    """A numpy value on the device as ``jnp.asarray`` keeps it with 64-bit
    types off: floating -> float32, integer -> int64 (the index type torch
    needs), bool -> bool."""
    a = np.asarray(v)
    if a.dtype.kind == "b":
        dtype = torch.bool
    elif a.dtype.kind in "iu":
        dtype = torch.int64
    else:
        dtype = torch.float32
    return torch.as_tensor(a).to(device=device, dtype=dtype)


class Trainer:
    """Training of the head or the torso stage on one device.

    Args:
      opt: the options (``Options``); ``opt.seed`` seeds the network's
        initial draw, the march noises and the grid jitter; ``opt.torso``
        selects the torso stage.
      net_cfg, render_cfg: default from ``opt``.
      device: "cuda" by default, which raises without a card.
      ema_decay: keep an EMA of the parameters, updated every
        ``opt.ema_update_interval`` steps.
      name: the checkpoints' file-name stem.
      workspace: the directory of the checkpoints; None (the default)
        writes and reads none (main.py passes ``opt.workspace``).
      max_keep_ckpt: how many epoch checkpoints the rolling window keeps.
      use_checkpoint: with a workspace, what the constructor restores:
        "scratch" nothing, "latest" the newest epoch checkpoint, "latest_model"
        its model only, "best" the best checkpoint (else the latest), or a
        path (utils.py:682-700).
    """

    def __init__(self, opt: Options, net_cfg: Optional[NetworkConfig] = None,
                 render_cfg: Optional[RenderConfig] = None, device="cuda",
                 ema_decay: Optional[float] = None, name: str = "ngp",
                 workspace: Optional[str] = None, max_keep_ckpt: int = 2,
                 use_checkpoint: str = "latest"):
        if opt.finetune_lips or opt.patch_size > 1:
            raise NotImplementedError("the LPIPS term (lips finetune, patch training) "
                                      "is not ported")
        self.opt = opt
        self.name = name
        self.workspace = workspace
        self.max_keep_ckpt = max_keep_ckpt
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
        # per-epoch mean losses, every step's loss, the grids' means after
        # each upkeep, the checkpoints of the rolling window
        self.stats = {"loss": [], "step_loss": [], "mean_density": [],
                      "mean_density_torso": [], "checkpoints": []}
        self.telemetry = {}
        self._cap_restored = False
        if workspace:
            self._restore(use_checkpoint)

    # ----------------------------------------------------------- batches
    def to_device(self, batch: dict) -> dict:
        """numpy batch -> tensors on the trainer's device (floating arrays
        float32, integer arrays int64, bool arrays bool); ``index`` becomes
        an int, None stays None."""
        out = {}
        for k, v in batch.items():
            if k in ("H", "W", "rect") or v is None:
                out[k] = v
            elif k == "index":
                out[k] = int(v)
            else:
                out[k] = _to_tensor(v, self.device)
        return out

    def render(self, batch: dict, noises: Optional[torch.Tensor],
               state: Optional[RendererState] = None):
        """``render_rays(training=True)`` on a device batch, with the
        trainer's state unless another is given. Returns (results, the state
        the render leaves: its audio-code EMA advanced with
        ``smooth_lips``)."""
        state = self.state if state is None else state
        return render_rays(self.net, self.render_cfg, state, batch["rays_o"],
                           batch["rays_d"], batch.get("auds"), batch["bg_coords"],
                           batch["poses"], batch.get("eye"), batch["index"],
                           batch["bg_color"], noises=noises, training=True)

    def loss(self, batch: dict, noises: Optional[torch.Tensor], global_step: int,
             state: Optional[RendererState] = None):
        """(loss, results, state after the render) of the stage on a device
        batch: the torso stage fits ``bg_torso_color``, the head stage
        ``images`` (both linearised with ``color_space == "linear"``)."""
        results, state = self.render(batch, noises, state)
        gt = batch["bg_torso_color"] if self.opt.torso else batch["images"]
        if self.opt.color_space == "linear":
            gt = srgb_to_linear(gt)
        if self.opt.torso:
            loss = torso_loss(results, gt)
        else:
            loss = head_loss(results, gt, batch["face_mask"], global_step, self.opt.iters,
                             self.opt.lambda_amb)
        return loss, results, state

    def draw_noises(self, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self.noise_gen, device=self.device)

    # -------------------------------------------------------------- step
    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimisation step on a device batch at ``self.global_step``
        (already counted); returns the loss (a device scalar, no sync), keeps
        the state the render leaves and the step's telemetry (the results'
        ``n_*`` counts) in ``self.telemetry``."""
        noises = self.draw_noises(batch["rays_o"].shape[0])
        loss, results, self.state = self.loss(batch, noises, self.global_step)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.telemetry = {k: v for k, v in results.items() if k.startswith("n_")}
        if self.ema_params is not None and \
                self.global_step % self.opt.ema_update_interval == 0:
            d = self.ema_decay
            with torch.no_grad():
                for k, p in self.net.named_parameters():
                    self.ema_params[k].mul_(d).add_(p.detach(), alpha=1.0 - d)
        return loss.detach()

    # ------------------------------------------------------ grid upkeep
    def update_extra_state(self, dataset):
        """The stage's grid upkeep (update_extra_state, renderer.py:383-501).
        The head: a random audio window and that frame's eye value condition
        the density queries. The torso: a random pose and its torso code
        condition the alpha queries; the audio draw still comes first, as it
        decides the pose draw."""
        rng = np.random.default_rng(int(self.global_step) + self.opt.seed)
        auds, ridx = None, 0
        if dataset.auds is not None:
            ridx = int(rng.integers(0, dataset.auds.shape[0]))
            auds = _to_tensor(get_audio_features(dataset.auds, self.opt.att, ridx),
                              self.device)
        if self.opt.torso:
            pidx = int(rng.integers(0, dataset.poses.shape[0]))
            pose6 = _to_tensor(convert_poses(dataset.poses[pidx][None]), self.device)
            codes = self.net.individual_codes_torso
            code = codes[pidx] if codes is not None else None
            self.state = update_torso_grid(self.net, self.render_cfg, self.state, pose6, code,
                                           generator=self.grid_gen)
            self.stats["mean_density_torso"].append(float(self.state.mean_density_torso))
            return
        eye = None
        if self.opt.exp_eye and dataset.eye_area is not None:
            eye = _to_tensor(dataset.eye_area[ridx].reshape(1, 1), self.device)
        with torch.no_grad():
            enc_a = self.net.encode_audio(auds)
        self.state = update_density_grid(self.net, self.render_cfg, self.state, enc_a, eye,
                                         generator=self.grid_gen)
        self.stats["mean_density"].append(float(self.state.mean_density))

    # ------------------------------------------------------------ loops
    def train(self, train_ds, max_epochs: int):
        """Mark the untrained cells from the dataset's cameras, then run
        epochs up to ``max_epochs``, each followed by a full checkpoint when
        the trainer has a workspace (the eval loop is not ported)."""
        self.state = mark_untrained_grid(self.render_cfg, self.state, train_ds.poses,
                                         tuple(train_ds.intrinsics))
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(train_ds)
            if self.workspace:
                self.save_checkpoint(full=True)

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

    # ------------------------------------------------------- checkpoints
    @property
    def ckpt_path(self) -> str:
        return os.path.join(self.workspace, "checkpoints")

    @property
    def best_path(self) -> str:
        return os.path.join(self.ckpt_path, f"{self.name}.npz")

    def _restore(self, use_checkpoint: str):
        """Checkpoint selector semantics (utils.py:682-700)."""
        if use_checkpoint == "scratch":
            return
        if use_checkpoint in ("latest", "latest_model"):
            path = ckpt_lib.latest_checkpoint(self.ckpt_path, self.name)
            if path is not None:
                self.load_checkpoint(path, model_only=use_checkpoint == "latest_model")
            return
        if use_checkpoint == "best":
            path = (self.best_path if os.path.exists(self.best_path)
                    else ckpt_lib.latest_checkpoint(self.ckpt_path, self.name))
            if path:
                self.load_checkpoint(path)
            return
        self.load_checkpoint(use_checkpoint)

    def _grid_shape_id(self, full=False):
        """The grid record: [levels, ch, base], plus the 2-D (ambient and
        torso) shape when it differs (``full=True``: always all six)."""
        c = self.net_cfg
        spatial = [c.grid_levels, c.grid_ch, c.grid_base]
        amb = [c.amb_levels, c.amb_ch, c.amb_base]
        return spatial + amb if (full or amb != spatial) else spatial

    def _opt_state(self) -> dict:
        """Adam's moments and step per parameter name, and the schedule's
        step, as numpy (the checkpoint's ``opt_torch/`` group)."""
        names = {id(p): n for n, p in self.net.named_parameters()}
        flat = {"scheduler_step": np.asarray(self.scheduler.last_epoch)}
        for p, st in self.optimizer.state.items():
            for k, v in st.items():
                flat[f"{names[id(p)]}/{k}"] = v.detach().cpu().numpy()
        return flat

    def _restore_opt_state(self, flat: dict):
        """Adam and its schedule from ``_opt_state``'s arrays; a parameter
        the checkpoint lacks, or holds in another shape, starts afresh (the
        strict=False restore of utils.py:1406-1419)."""
        step = int(flat.get("scheduler_step", 0))
        self.optimizer, self.scheduler = build_optimizer(self.net, self.opt, step)
        for name, p in self.net.named_parameters():
            saved = [flat.get(f"{name}/{k}") for k in ("step", "exp_avg", "exp_avg_sq")]
            if not p.requires_grad or any(v is None for v in saved) \
                    or saved[1].shape != tuple(p.shape):
                continue
            self.optimizer.state[p] = {
                "step": torch.from_numpy(saved[0].copy()),  # a host scalar, as Adam keeps it
                "exp_avg": torch.from_numpy(saved[1].copy()).to(self.device),
                "exp_avg_sq": torch.from_numpy(saved[2].copy()).to(self.device)}

    def save_checkpoint(self, name: Optional[str] = None, full: bool = False,
                        best: bool = False):
        """Write ``<workspace>/checkpoints/<name>.npz`` (default
        ``<name>_epNNNN``) in the rolling window, with Adam and the EMA when
        ``full`` (utils.py:1302-1360). ``best`` needs an eval result, and
        the eval loop is not ported: it warns and writes nothing, as the JAX
        trainer does before its first evaluation."""
        if best:
            warnings.warn("no evaluated results found; the best checkpoint is not saved")
            return
        if not self.workspace:
            raise ValueError("the trainer has no workspace to save a checkpoint in")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        rc = self.render_cfg
        meta = {
            "epoch": self.epoch,
            "global_step": self.global_step,
            "mean_density": float(self.state.mean_density),
            "mean_density_torso": float(self.state.mean_density_torso),
            # the march lattice the field was trained with; the JAX trainer
            # keeps its own TPU capacities for the fields this lacks
            "render_cfg": {"march_iters": rc.march_iters, "sample_slots": rc.sample_slots},
            "grid_shape": self._grid_shape_id(),
        }
        path = os.path.join(self.ckpt_path, f"{name}.npz")
        self.stats["checkpoints"].append(path)
        if len(self.stats["checkpoints"]) > self.max_keep_ckpt:
            old = self.stats["checkpoints"].pop(0)
            if os.path.exists(old):
                os.remove(old)
        ema = (jax_from_state_dict({k: v.cpu().numpy() for k, v in self.ema_params.items()})
               if full and self.ema_params is not None else None)
        ckpt_lib.save_checkpoint(path, network_to_jax(self.net), self.state,
                                 opt_torch=self._opt_state() if full else None,
                                 ema_params=ema, meta=meta)

    def _check_grid_shape(self, path: str, meta: dict, params: Optional[dict]):
        """Raise ValueError when the checkpoint's grid shape is not this
        network's: from its ``grid_shape`` record (shorter historical records
        expanded as JAX does), and from the table shapes as a backstop."""
        saved = meta.get("grid_shape")
        if saved is not None:
            saved = [int(v) for v in saved]
            full = (saved + [None] + saved + [None] if len(saved) == 2
                    else saved + saved if len(saved) == 3 else saved)
            cur = self._grid_shape_id(full=True)
            if any(s is not None and s != c for s, c in zip(full, cur)):
                raise ValueError(
                    f"checkpoint {path} was trained with grid shape "
                    f"{'x'.join(str(v) for v in saved)} but this trainer is configured for "
                    f"{'x'.join(str(v) for v in cur)} (levels x ch x base [x 2-D levels x ch "
                    "x base]); the grid shape is part of the model")
        for key in ("encoder", "encoder_ambient"):
            if params is not None and key in params and \
                    tuple(np.shape(params[key])) != tuple(getattr(self.net, key).shape):
                raise ValueError(f"checkpoint {path} {key} table {np.shape(params[key])} "
                                 f"does not match the configured grid "
                                 f"{tuple(getattr(self.net, key).shape)}")

    def _load_params(self, params: dict):
        unknown = load_jax_params(self.net, params)
        if unknown:
            warnings.warn(f"checkpoint parameters the network does not have: {unknown}")

    def load_checkpoint(self, path: str, model_only: bool = False):
        """Load a checkpoint of either package (``.npz``) or a reference
        ``.pth`` (utils.py:1362-1427): parameters in place (a head checkpoint
        leaves the torso's as they are), the EMA merged, the renderer state
        rebuilt, ``march_iters`` and ``sample_slots`` restored, and unless
        ``model_only`` the epoch and step counts. Adam starts afresh, then
        takes the checkpoint's moments and schedule on a full load."""
        if path.endswith(".pth"):
            params, arrays, meta = ckpt_lib.import_torch_checkpoint(path)
            self._load_params(params)
            self._apply_state_arrays(arrays, meta)
            self.optimizer, self.scheduler = build_optimizer(self.net, self.opt)
            return
        params, state, ema, opt_flat, meta = ckpt_lib.load_checkpoint(path)
        self._check_grid_shape(path, meta, params)
        cap = meta.get("render_cfg")
        # a model-only load (freeze_loaded_head) keeps the lattice a trainer
        # has already restored from its own checkpoint; the JAX record's
        # capacity fields size TPU buffers, and the port has nothing to size
        if cap and not (model_only and self._cap_restored):
            self.render_cfg = dataclasses.replace(
                self.render_cfg, **{k: cap[k] for k in ("march_iters", "sample_slots")
                                    if k in cap})
            self._cap_restored = True
        if params is not None:
            self._load_params(params)
        if state is not None:
            self._apply_state_arrays(state, meta)
        if ema is not None and self.ema_params is not None:
            # merge: a head checkpoint's EMA lacks the torso's parameters
            own = self.ema_params
            self.ema_params, _ = ckpt_lib.merge_imported(own, {
                k: torch.from_numpy(np.array(v, np.float32)).to(self.device)
                for k, v in _state_dict_from_jax(ema).items() if k in own})
        if not model_only:
            self.epoch = int(meta.get("epoch", 0))
            self.global_step = int(meta.get("global_step", 0))
        if opt_flat is not None and not model_only:
            self._restore_opt_state(opt_flat)
        else:
            self.optimizer, self.scheduler = build_optimizer(self.net, self.opt)

    def _apply_state_arrays(self, arrays: dict, meta: dict):
        """The renderer state from a checkpoint's arrays (JAX
        ``_apply_state_arrays``): the density grid rebuilds the occupancy
        exactly; without it, the saved sigma bytes, or occupied cells of the
        bitfield at the least sigma code (byte 129: the cull never drops
        their samples), and the occupied box and sphere as saved or from the
        occupied bits."""
        st, rc, dev = self.state, self.render_cfg, self.device

        def tensor(key, dtype, shape):
            return torch.as_tensor(np.asarray(arrays[key])).to(dev, dtype).reshape(shape)

        if "density_grid" in arrays:
            st = dataclasses.replace(st, density_grid=tensor(
                "density_grid", torch.float32, st.density_grid.shape))
        if "density_bitfield" in arrays:
            st = dataclasses.replace(st, density_bitfield=tensor(
                "density_bitfield", torch.uint8, st.density_bitfield.shape))
        if "density_grid_torso" in arrays:
            st = dataclasses.replace(st, density_grid_torso=tensor(
                "density_grid_torso", torch.float32, st.density_grid_torso.shape))
        mean = torch.tensor(meta.get("mean_density", 0.0), dtype=torch.float32, device=dev)
        st = dataclasses.replace(st, mean_density=mean, mean_density_torso=torch.tensor(
            meta.get("mean_density_torso", 0.0), dtype=torch.float32, device=dev))
        if "density_grid" in arrays:
            thresh = torch.clamp(mean, max=rc.density_thresh)
            st = dataclasses.replace(
                st, sigma_bytes=build_sigma_bytes(st.density_grid, thresh),
                occ_bbox=compute_occ_bbox(rc, st.density_grid, thresh),
                occ_sphere=compute_occ_sphere(rc, st.density_grid, thresh))
            if "density_bitfield" not in arrays:
                st = dataclasses.replace(st, density_bitfield=packbits(st.density_grid,
                                                                       thresh))
        else:
            if "sigma_bytes" in arrays:
                st = dataclasses.replace(st, sigma_bytes=tensor(
                    "sigma_bytes", torch.uint8, st.sigma_bytes.shape))
            elif "density_bitfield" in arrays:
                occ = unpackbits(st.density_bitfield, rc.cascade, rc.grid_size).reshape(-1)
                st = dataclasses.replace(st, sigma_bytes=torch.where(
                    occ > 0, 129, 0).to(torch.uint8))
            if "occ_bbox" in arrays and "occ_sphere" in arrays:
                st = dataclasses.replace(st, occ_bbox=tensor("occ_bbox", torch.float32, (6,)),
                                         occ_sphere=tensor("occ_sphere", torch.float32, (4,)))
            elif "sigma_bytes" in arrays or "density_bitfield" in arrays:
                occ01 = (st.sigma_bytes >= 128).reshape(rc.cascade, -1).float()
                st = dataclasses.replace(st, occ_bbox=compute_occ_bbox(rc, occ01, 0.5),
                                         occ_sphere=compute_occ_sphere(rc, occ01, 0.5))
        self.state = st

    def freeze_loaded_head(self, head_ckpt: Optional[str] = None):
        """Torso-stage warm start (main.py:142-157): load the head
        checkpoint's model (``opt.head_ckpt`` unless given); the head's
        parameters are the 'frozen' group already."""
        head_ckpt = head_ckpt or self.opt.head_ckpt
        if not os.path.exists(head_ckpt):
            raise FileNotFoundError(
                f"--head_ckpt {head_ckpt} not found. Note: the 'best' checkpoint "
                "(ngp.npz) is only written at eval epochs; use the rolling epoch "
                "checkpoint (ngp_epXXXX.npz) otherwise.")
        self.load_checkpoint(head_ckpt, model_only=True)
