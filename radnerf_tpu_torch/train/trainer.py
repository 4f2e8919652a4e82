"""Trainer of the head and torso stages (counterpart of
``radnerf_tpu/train/trainer.py``; reference nerf/utils.py:570-1427 and
main.py:142-219).

A train step renders a batch of rays with ``render_rays(training=True)``
(the perturbation noises from a ``torch.Generator`` on the device), takes
the stage's loss, runs autograd back and steps a per-group Adam (betas
0.9/0.99, eps 1e-15) whose learning rates decay as ``base_lr * 0.1 **
(step / iters)`` (``0.05 **`` for a trainer started in the lips finetune).
The head stage's loss is ``head_loss``: autograd runs
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

Every ``eval_interval`` epochs ``train`` evaluates a validation dataset
(``evaluate_one_epoch``: each frame rendered with the EMA in the network, the
loss and the ``metrics``, the rgb and depth PNGs) and writes the best
checkpoint. ``test`` renders a dataset's frames into a video and returns the
FPS it measured.

Checkpoints are the JAX package's flat ``.npz`` (``checkpoint.py``): with a
workspace, ``train`` writes a full one after every epoch into
``<workspace>/checkpoints`` (a rolling window of ``max_keep_ckpt``) and, after
each evaluation, the best one (``<name>.npz``: the EMA, no density grid); the
constructor restores one as ``use_checkpoint`` selects. A checkpoint of
either package, or a reference ``.pth``, loads with ``load_checkpoint``, a
JAX one with its Adam moments.

The dataset is the port's ``TalkingHeadDataset`` (batches on the device), or
any object with ``collate(i)``, ``epoch_indices()``, ``poses`` [B, 4, 4],
``intrinsics`` (fx, fy, cx, cy), ``auds`` (per-frame features or None) and
``eye_area`` ([B, 1] or None), all numpy, whose batches are numpy or tensors;
in the torso stage its batches carry ``bg_torso_color``.

The lips finetune (``opt.finetune_lips``) and patch training
(``opt.patch_size > 1``, at least 32) add an LPIPS-alex term
(``metrics.LPIPS``, calibrated from ``opt.lpips_weights`` or on its seeded
filters with a warning) to the head loss, per batch as JAX chooses it: a
batch with a lips ``rect`` while ``opt.finetune_lips`` is on is one image of
the rect at weight 0.01; else, with patches, p x p images at 0.001. The
lips finetune flips ``opt.finetune_lips`` after every step, and the dataset
that shares the same ``Options`` object alternates rect and full batches
with it.

With ``opt.auto_capacity`` (the default), every upkeep inside an epoch
first adapts the render capacities to the telemetry of the epoch's last
step (``capacity.py``, JAX trainer.py:332-398 and :541-547): K, S and the
group slots change the lattice the next steps march, the other four are
JAX's buffer sizes, which the port carries but drops no work at. The
telemetry is read back once per upkeep; ``train_step`` adds no sync. The
epoch's last line gives the last step's hits and samples beside JAX's
capacities, marked ``[DROPPING]`` where JAX would drop work (the port
does not). Checkpoints record all seven capacities; a load restores them
but for those the user set (``opt.cap_overrides`` or ``cap_overrides``),
which it keeps with a warning, as JAX does.

With a workspace the trainer keeps JAX's run log: every ``log`` line goes to
``<workspace>/log_<name>.txt`` (appended) and, unless ``mute``, to stdout;
``train`` writes tensorboard scalars to ``<workspace>/run/<name>`` where
``tensorboardX`` imports (``train/loss`` and ``train/lr`` every 16 steps, the
meters after each evaluation), else none.

With ``opt.data_parallel`` inside a ``torch.distributed`` group of more than
one rank (``parallel/mesh.py``; the caller starts the group), the network,
its EMA and the renderer state are broadcast from rank 0 at construction;
every rank draws the same global batch and noises and keeps its shard of
the rays, the gradients and the loss are averaged over the ranks before
Adam steps, and the telemetry is reduced. A batch with an LPIPS term (a lips
rect or patches) spans several ranks' rays, so it runs whole on every rank.
Grid upkeep and EMA run on every rank from the same parameters and seeds,
so the ranks stay bit for bit alike. Frames with no noises and an audio
window whose ray count divides the world render sharded
(``render_frame_dp``). Only rank 0 writes files: the log, the scalars,
checkpoints, validation images, test results and meshes; the other ranks
are muted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Options
from ..convert import jax_from_state_dict, load_jax_params, network_to_jax, _state_dict_from_jax
from ..data.rays import convert_poses, get_audio_features, get_bg_coords, rays_from_pixels
from ..device import resolve_device
from ..models.network_triplane import TRAINING_REFUSED
from ..models import (
    NeRFNetwork,
    NetworkConfig,
    build_network,
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
from ..parallel import (
    all_reduce_mean,
    create_mesh,
    local_device,
    reduce_telemetry,
    render_frame_dp,
    replicate,
    shard_batch,
    shard_rays,
)
from ..utils.color import linear_to_srgb, srgb_to_linear
from ..utils.image import write_png, write_video
from ..utils.mesh import extract_geometry, save_mesh_ply
from ..utils.tracing import span, sync
from . import checkpoint as ckpt_lib
from .capacity import CAPACITY_FIELDS, adapt_render_config, ray_capacity, sample_capacity
from .losses import head_loss, torso_loss


def build_optimizer(net: NeRFNetwork, opt: Options, step: int = 0,
                    decay_base: Optional[float] = None):
    """Per-group Adam with exponential LR decay (main.py:204, 216-219):
    ``base_lr * decay_base ** (step / iters)``, decay_base 0.05 in the lips
    finetune and 0.1 otherwise unless given; parameters of the 'frozen'
    group get ``requires_grad_(False)`` and no place in it.

    Returns (optimizer, scheduler), the schedule at ``step`` (a resumed
    run's count of updates). Step the scheduler after each optimizer step:
    the first update runs at the base rate, as optax's schedule (count 0 at
    the first update) does."""
    if decay_base is None:
        decay_base = 0.05 if opt.finetune_lips else 0.1
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
        optimizer, lambda s: decay_base ** (s / iters), last_epoch=step - 1)
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
    """Training of the head or the torso stage on one device, or data
    parallel over the ranks of a process group (``opt.data_parallel``).

    Args:
      opt: the options (``Options``); ``opt.seed`` seeds the network's
        initial draw, the march noises and the grid jitter; ``opt.torso``
        selects the torso stage.
      net_cfg, render_cfg: default from ``opt``.
      device: "cuda" by default, which raises without a card; under data
        parallelism a bare "cuda" is ``cuda:<LOCAL_RANK>``.
      ema_decay: keep an EMA of the parameters, updated every
        ``opt.ema_update_interval`` steps.
      name: the checkpoints' file-name stem.
      workspace: the directory of the checkpoints, the log file
        ``log_<name>.txt`` and the tensorboard scalars; None (the default)
        writes and reads none (main.py passes ``opt.workspace``).
      max_keep_ckpt: how many epoch checkpoints the rolling window keeps.
      use_checkpoint: with a workspace, what the constructor restores:
        "scratch" nothing, "latest" the newest epoch checkpoint, "latest_model"
        its model only, "best" the best checkpoint (else the latest), or a
        path (utils.py:682-700).
      metrics: meters (``metrics.py``) the evaluation updates; the first
        one's measure is the epoch's result.
      eval_interval: ``train`` evaluates every this many epochs.
      use_tensorboard: with a workspace, ``train`` writes tensorboard
        scalars where ``tensorboardX`` imports.
      mute: ``log`` writes to the log file only, not to stdout.
      cap_overrides: capacity fields (``capacity.CAPACITY_FIELDS``) the user
        set, beside ``opt.cap_overrides``: a checkpoint's record does not
        replace them. A given ``render_cfg`` is a starting point, not an
        override.
    """

    def __init__(self, opt: Options, net_cfg: Optional[NetworkConfig] = None,
                 render_cfg: Optional[RenderConfig] = None, device="cuda",
                 ema_decay: Optional[float] = None, name: str = "ngp",
                 workspace: Optional[str] = None, max_keep_ckpt: int = 2,
                 use_checkpoint: str = "latest", metrics=(), eval_interval: int = 1,
                 use_tensorboard: bool = True, mute: bool = False, cap_overrides=None):
        if 1 < opt.patch_size < 32:
            # alex-LPIPS needs >= 32 px: smaller inputs leave empty feature
            # maps mid-stack
            raise ValueError(f"patch_size={opt.patch_size}: patch-based perceptual training "
                             "requires patch_size >= 32 (alex-LPIPS receptive field)")
        self.opt = opt
        self.name = name
        self.workspace = workspace
        self.max_keep_ckpt = max_keep_ckpt
        self.metrics = list(metrics)
        self.eval_interval = eval_interval
        self.use_tensorboard = use_tensorboard
        self.writer = None
        # data parallelism: the world of the caller's process group, or None
        # (JAX's mesh); only rank 0 writes files, the other ranks are muted
        self.world = create_mesh() if opt.data_parallel else None
        self.is_main = self.world is None or self.world[0] == 0
        self.mute = mute or not self.is_main
        if self.world is not None:
            device = local_device(device)
        self.device = resolve_device(device)
        if self.world is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.time_stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
        self.log_path = None
        if workspace and self.is_main:
            os.makedirs(workspace, exist_ok=True)
            self.log_path = os.path.join(workspace, f"log_{name}.txt")
        self.net_cfg = net_cfg or NetworkConfig.from_options(opt)
        self.render_cfg = render_cfg or RenderConfig.from_options(opt)
        # the capacity fields the user set, by provenance (JAX
        # trainer.py:111-135): they beat a checkpoint's record
        self._user_cap_fields = set(opt.cap_overrides) | set(cap_overrides or ())
        unknown = self._user_cap_fields - set(CAPACITY_FIELDS)
        if unknown:
            raise ValueError(f"cap_overrides names unknown capacity fields {sorted(unknown)}; "
                             f"valid: {sorted(CAPACITY_FIELDS)}")
        self.net = build_network(self.net_cfg, device=self.device,
                                 generator=torch.Generator().manual_seed(opt.seed))
        self.state = RendererState.create(self.render_cfg, self.net_cfg.audio_dim,
                                          self.device)
        self.log(f"[INFO] Trainer: {name} | {self.time_stamp} | {self.device} | "
                 f"{'bf16' if opt.fp16 else 'fp32'} | {workspace}")
        self.log(f"[INFO] #parameters: {sum(p.numel() for p in self.net.parameters())}")
        if opt.data_parallel:
            self.log(f"[INFO] data parallel over {self.world[1]} ranks "
                     f"({dist.get_backend()}), this rank {self.world[0]} on {self.device}"
                     if self.world is not None else
                     "[INFO] data parallel asked, but no process group of more than one "
                     "rank is up: training on one device")
        # the lips finetune's schedule and flip follow the options as given,
        # whatever opt.finetune_lips reads after the flips
        self.flip_finetune_lips = opt.finetune_lips
        self.decay_base = 0.05 if opt.finetune_lips else 0.1
        self.optimizer, self.scheduler = self._optimizer()
        self.lpips = None
        if opt.finetune_lips or opt.patch_size > 1:
            from .metrics import LPIPS

            self.lpips = LPIPS(device=self.device)
            if opt.lpips_weights:
                self.lpips.load_weights_file(opt.lpips_weights)
                self.log(f"[INFO] LPIPS calibrated from {opt.lpips_weights}")
            else:
                self.log("[WARN] perceptual loss is active (finetune_lips/patch) but no "
                         "--lpips_weights given: LPIPS runs on UNCALIBRATED random filters "
                         "and is NOT the reference's pretrained alex-LPIPS term.")
        self.noise_gen = torch.Generator(device=self.device).manual_seed(opt.seed)
        self.grid_gen = torch.Generator(device=self.device).manual_seed(opt.seed + 1)
        self.ema_decay = ema_decay
        self.ema_params = ({k: v.detach().clone() for k, v in self.net.named_parameters()}
                           if ema_decay else None)
        self.epoch = 0
        self.global_step = 0
        # per-epoch mean losses, every step's loss, the grids' means after
        # each upkeep, the checkpoints of the rolling window, each
        # evaluation's mean loss and result, and with the LPIPS term each
        # step's loss mode and (step, term)
        self.stats = {"loss": [], "step_loss": [], "mean_density": [],
                      "mean_density_torso": [], "checkpoints": [], "valid_loss": [],
                      "results": [], "loss_mode": [], "lpips_term": []}
        self._lpips_terms = []  # device scalars of the epoch running
        self.telemetry = {}
        self._last_n_rays = 0  # the last train step's (global) ray count
        # adaptations made, and their cap (JAX's bound on its recompiles; the
        # port keeps it so that both take the same sequence of capacities)
        self._adapt_count, self._adapt_cap = 0, 6
        self._bg_coords = {}  # (H, W) -> the frame's bg_coords on the device
        self._cap_restored = False
        if workspace:
            self._restore(use_checkpoint)
        if self.world is not None:
            # every rank starts from rank 0's draw (or checkpoint)
            replicate([self.net, self.ema_params, self.state])

    def log(self, *args):
        """A line to stdout (unless muted) and appended to the workspace's
        log file."""
        if not self.mute:
            print(*args, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as fh:
                print(*args, file=fh)

    def _optimizer(self, step: int = 0):
        return build_optimizer(self.net, self.opt, step, self.decay_base)

    # ----------------------------------------------------------- batches
    def to_device(self, batch: dict) -> dict:
        """A batch on the trainer's device: tensors as they are (moved if on
        another device), numpy arrays as tensors (floating arrays float32,
        integer arrays int64, bool arrays bool); ``index`` becomes an int,
        None stays None."""
        out = {}
        for k, v in batch.items():
            if k in ("H", "W", "rect") or v is None:
                out[k] = v
            elif k == "index":
                out[k] = int(v)
            elif torch.is_tensor(v):
                out[k] = v.to(self.device)
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

    def loss_mode(self, batch: dict) -> str:
        """The head loss's LPIPS mode for a batch (JAX trainer.py:553-563):
        "rect" when the lips finetune is on and the batch is a lips rect,
        else "patch" with patches, else "none"."""
        if self.opt.torso or self.lpips is None:
            return "none"
        if self.opt.finetune_lips and batch.get("rect") is not None:
            return "rect"
        return "patch" if self.opt.patch_size > 1 else "none"

    def loss(self, batch: dict, noises: Optional[torch.Tensor], global_step: int,
             state: Optional[RendererState] = None, parts: Optional[dict] = None):
        """(loss, results, state after the render) of the stage on a device
        batch: the torso stage fits ``bg_torso_color``, the head stage
        ``images`` (both linearised with ``color_space == "linear"``), with
        the LPIPS term of ``loss_mode``; ``parts`` receives the mode as
        "mode" and that term as "lpips"."""
        results, state = self.render(batch, noises, state)
        gt = batch["bg_torso_color"] if self.opt.torso else batch["images"]
        if self.opt.color_space == "linear":
            gt = srgb_to_linear(gt)
        if self.opt.torso:
            return torso_loss(results, gt), results, state
        mode = self.loss_mode(batch)
        if parts is not None:
            parts["mode"] = mode
        shape = None
        if mode == "rect":
            xmin, xmax, ymin, ymax = batch["rect"]
            shape = (xmax - xmin, ymax - ymin)
        elif mode == "patch":
            shape = (self.opt.patch_size, self.opt.patch_size)
        loss = head_loss(results, gt, batch["face_mask"], global_step, self.opt.iters,
                         self.opt.lambda_amb, lpips=self.lpips if shape else None,
                         lpips_shape=shape, lpips_weight=0.01 if mode == "rect" else 0.001,
                         parts=parts)
        return loss, results, state

    def draw_noises(self, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self.noise_gen, device=self.device)

    # -------------------------------------------------------------- step
    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimisation step on a device batch at ``self.global_step``
        (already counted); returns the loss (a device scalar, no sync), keeps
        the state the render leaves and the step's telemetry (the results'
        ``n_*`` counts) in ``self.telemetry``. In the lips finetune it then
        flips ``opt.finetune_lips`` (utils.py:769-770).

        Under data parallelism every rank holds the same global batch and
        draws the same global noises, keeps its shard of both unless the
        batch carries an LPIPS term (whose images span the ranks' rays: it
        runs whole on every rank), and averages the gradients and the loss
        over the ranks before Adam steps; the telemetry of a sharded batch
        is reduced over the ranks. ER-NeRF's field (``--arch ernerf``) is
        refused: its losses are not written yet."""
        self._refuse_training()
        self._last_n_rays = batch["rays_o"].shape[0]
        noises = self.draw_noises(self._last_n_rays)
        sharded = (self.world is not None and self.loss_mode(batch) == "none"
                   and batch["rays_o"].shape[0] % self.world[1] == 0)
        if sharded:
            batch = shard_batch(batch, self.world)
            noises = shard_rays(noises, self.world)
        parts = {}
        with span("forward"):
            loss, results, self.state = self.loss(batch, noises, self.global_step, parts=parts)
        self.optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            loss.backward()
        telemetry = {k: v for k, v in results.items() if k.startswith("n_")}
        with span("optimizer"):
            if self.world is not None:
                loss = loss.detach()
                all_reduce_mean([p.grad for p in self.net.parameters()] + [loss], self.world)
                if sharded:
                    telemetry = reduce_telemetry(telemetry)
            self.optimizer.step()
            self.scheduler.step()
            self.telemetry = telemetry
            if self.lpips is not None:
                self.stats["loss_mode"].append(parts.get("mode", "none"))
                if "lpips" in parts:
                    self._lpips_terms.append((self.global_step, parts["lpips"].detach()))
            if self.flip_finetune_lips:
                self.opt.finetune_lips = not self.opt.finetune_lips
            if self.ema_params is not None and \
                    self.global_step % self.opt.ema_update_interval == 0:
                d = self.ema_decay
                with torch.no_grad():
                    for k, p in self.net.named_parameters():
                        self.ema_params[k].mul_(d).add_(p.detach(), alpha=1.0 - d)
        return loss.detach()

    def _refuse_training(self):
        if self.net_cfg.arch == "ernerf":
            raise NotImplementedError(TRAINING_REFUSED)

    # ----------------------------------------------- adaptive capacities
    def _adapt_capacities(self, telemetry: dict, n_rays: int):
        """Resize the render capacities to a step's telemetry (JAX
        ``_adapt_capacities``; ``capacity.adapt_render_config``), at most
        ``_adapt_cap`` times; once the cap binds, warn where the telemetry
        exceeds JAX's capacities (JAX would drop work there)."""
        with span("upkeep.adapt"):
            keys = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span", "n_groups_needed",
                    "n_group_max")
            # the one read-back of the telemetry
            with sync("telemetry"):
                stats = torch.stack([telemetry[k].to(torch.int64).reshape(())
                                     for k in keys]).tolist()
            n_hit, n_needed, n_max, n_k_span = stats[:4]
            rc = self.render_cfg
            if self._adapt_count >= self._adapt_cap:
                R_now = ray_capacity(n_rays, rc.ray_capacity_frac)
                S_now = sample_capacity(R_now, rc.sample_capacity_mult)
                K_now = rc.march_config().n_march_iters
                groups_over = rc.march_group and (
                    stats[4] > sample_capacity(R_now, rc.march_group_mult)
                    or (rc.march_group_slots is not None and stats[5] > rc.march_group_slots))
                if n_hit > R_now or n_needed > S_now or n_k_span > K_now or groups_over:
                    self.log(
                        f"[WARN] adaptive-capacity cap ({self._adapt_cap} recompiles) "
                        f"reached while capacities are undersized: hits {n_hit} vs "
                        f"ray capacity {R_now}, samples {n_needed} vs capacity "
                        f"{S_now}, window span {n_k_span} vs orbit {K_now} — work "
                        f"beyond capacity is being DROPPED. Raise "
                        f"--ray_capacity_frac/--sample_capacity_mult/--march_iters "
                        f"or the cap (Trainer._adapt_cap).")
                return
            n_groups = n_group_max = None
            if rc.march_group:
                n_groups, n_group_max = stats[4] or None, stats[5] or None
            with sync("occ_radius"):
                radius = float(self.state.occ_sphere[3])
            rc2 = adapt_render_config(rc, n_hit, n_needed, n_max, n_rays, radius,
                                      n_k_span=n_k_span, n_groups=n_groups,
                                      n_group_max=n_group_max)
            if rc2 is not None:
                self.render_cfg = rc2
                self._adapt_count += 1
                self.log(
                    f"[INFO] adapt capacities: ray_frac={rc2.ray_capacity_frac:.3f} "
                    f"sample_mult={rc2.sample_capacity_mult} "
                    f"march_iters={rc2.march_iters} "
                    f"sample_slots={rc2.sample_slots} "
                    f"(hits={n_hit}, samples={n_needed}, max_count={n_max}, "
                    f"occ_r={radius:.3f})")

    # ------------------------------------------------------ grid upkeep
    def update_extra_state(self, dataset):
        """The stage's grid upkeep (update_extra_state, renderer.py:383-501).
        The head: a random audio window and that frame's eye value condition
        the density queries. The torso: a random pose and its torso code
        condition the alpha queries; the audio draw still comes first, as it
        decides the pose draw."""
        with span("upkeep.grid"):
            rng = np.random.default_rng(int(self.global_step) + self.opt.seed)
            auds, ridx = None, 0
            if dataset.auds is not None:
                ridx = int(rng.integers(0, dataset.auds.shape[0]))
                with sync("upload_audio"):
                    auds = _to_tensor(get_audio_features(dataset.auds, self.opt.att, ridx),
                                      self.device)
            if self.opt.torso:
                pidx = int(rng.integers(0, dataset.poses.shape[0]))
                with sync("upload_pose"):
                    pose6 = _to_tensor(convert_poses(dataset.poses[pidx][None]), self.device)
                codes = self.net.individual_codes_torso
                code = codes[pidx] if codes is not None else None
                self.state = update_torso_grid(self.net, self.render_cfg, self.state, pose6, code,
                                               generator=self.grid_gen)
                with sync("mean_density_torso"):
                    self.stats["mean_density_torso"].append(float(self.state.mean_density_torso))
                return
            eye = None
            if self.opt.exp_eye and dataset.eye_area is not None:
                with sync("upload_eye"):
                    eye = _to_tensor(dataset.eye_area[ridx].reshape(1, 1), self.device)
            with torch.no_grad():
                enc_a = self.net.encode_audio(auds)
            self.state = update_density_grid(self.net, self.render_cfg, self.state, enc_a, eye,
                                             generator=self.grid_gen)
            with sync("mean_density"):
                self.stats["mean_density"].append(float(self.state.mean_density))

    # ------------------------------------------------------------ loops
    def train(self, train_ds, valid_ds=None, max_epochs: int = 1):
        """Mark the untrained cells from the dataset's cameras, then run
        epochs up to ``max_epochs`` (utils.py:899-921): each followed by a
        full checkpoint when the trainer has a workspace, and every
        ``eval_interval`` epochs by an evaluation of ``valid_ds`` (when given)
        and the best checkpoint. With a workspace and ``use_tensorboard``,
        the tensorboard scalars go to ``<workspace>/run/<name>`` while it
        runs, where ``tensorboardX`` imports."""
        if self.use_tensorboard and self.workspace and self.is_main:
            try:
                import tensorboardX

                self.writer = tensorboardX.SummaryWriter(
                    os.path.join(self.workspace, "run", self.name))
            except ImportError:
                self.writer = None
        self.state = mark_untrained_grid(self.render_cfg, self.state, train_ds.poses,
                                         tuple(train_ds.intrinsics))
        try:
            for epoch in range(self.epoch + 1, max_epochs + 1):
                self.epoch = epoch
                self.train_one_epoch(train_ds)
                if self.workspace:
                    self.save_checkpoint(full=True)
                if valid_ds is not None and self.epoch % self.eval_interval == 0:
                    self.evaluate_one_epoch(valid_ds)
                    if self.workspace:
                        self.save_checkpoint(best=True)
        finally:
            if self.writer is not None:
                self.writer.close()
                self.writer = None

    def next_batch(self, dataset, idx) -> dict:
        """The dataset's batch ``idx`` on the trainer's device."""
        with span("batch"):
            return self.to_device(dataset.collate(int(idx)))

    def step(self, dataset, idx, telemetry: Optional[dict] = None) -> torch.Tensor:
        """One step of the loop: the grid upkeep when it is due, then a
        train step on the dataset's batch ``idx``; returns the loss (a
        device scalar, no sync). With ``telemetry`` (the last step's of the
        same epoch, as ``train_one_epoch`` passes it) and
        ``opt.auto_capacity``, a due upkeep first adapts the render
        capacities to it."""
        self._refuse_training()
        with span("step"):
            if self.global_step % self.opt.update_extra_interval == 0:
                with span("upkeep"):
                    if self.opt.auto_capacity and telemetry is not None:
                        self._adapt_capacities(telemetry, self._last_n_rays)
                    self.update_extra_state(dataset)
            self.global_step += 1
            return self.train_step(self.next_batch(dataset, idx))

    def train_one_epoch(self, dataset) -> list:
        """One pass over ``dataset.epoch_indices()``; returns the step
        losses as floats. The loss is read back once an epoch, and every
        16th step when a tensorboard writer is open (JAX trainer.py:595-601:
        ``train/loss`` and the grid group's ``train/lr``). Upkeeps after the
        epoch's first step adapt the capacities (``step``)."""
        self.log(f"==> Start Training Epoch {self.epoch} ...")
        t0 = time.perf_counter()
        losses = []
        for idx in dataset.epoch_indices():
            losses.append(self.step(dataset, idx, self.telemetry if losses else None))
            if self.writer is not None and self.global_step % 16 == 0:
                with sync("scalar_loss"):
                    loss = float(losses[-1])
                self.writer.add_scalar("train/loss", loss, self.global_step)
                lr = self.opt.lr * self.decay_base ** (self.global_step / self.opt.iters)
                self.writer.add_scalar("train/lr", lr, self.global_step)
        with sync("epoch_losses"):
            losses = torch.stack(losses).tolist() if losses else []
        if self._lpips_terms:
            steps, terms = zip(*self._lpips_terms)
            with sync("lpips_terms"):
                terms = torch.stack(terms).tolist()
            self.stats["lpips_term"].extend(zip(steps, terms))
            self._lpips_terms = []
        self.stats["loss"].append(float(np.mean(losses)) if losses else 0.0)
        self.stats["step_loss"].extend(losses)
        cap_note = ""
        if losses:
            # the last step's rays hit and samples marched beside JAX's
            # capacities: [DROPPING] where JAX would drop work (the port
            # renders them all)
            rc = self.render_cfg
            with sync("epoch_telemetry"):
                n_hit = int(self.telemetry["n_hit"])
                n_needed = int(self.telemetry["n_samples_needed"])
            R = ray_capacity(self._last_n_rays, rc.ray_capacity_frac)
            S = sample_capacity(R, rc.sample_capacity_mult)
            cap_note = (f", hits {n_hit}/{R} rays, samples {n_needed}/{S}"
                        + (" [DROPPING]" if n_hit > R or n_needed > S else ""))
        self.log(f"==> Finished Epoch {self.epoch}: loss={self.stats['loss'][-1]:.6f}, "
                 f"{len(losses) / max(time.perf_counter() - t0, 1e-9):.2f} steps/s{cap_note}")
        return losses

    # ------------------------------------------------------- eval and test
    @contextlib.contextmanager
    def _eval_params(self):
        """The EMA in the network while the block runs, the live parameters
        back afterwards, bit for bit (JAX ``_eval_params``: evaluation
        renders with the EMA); the live parameters without an EMA."""
        if self.ema_params is None:
            yield
            return
        params = dict(self.net.named_parameters())
        with torch.no_grad():
            live = {k: p.detach().clone() for k, p in params.items()}
            for k, p in params.items():
                p.copy_(self.ema_params[k])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(live[k])

    def _render_frame(self, batch: dict, noises: Optional[torch.Tensor] = None):
        """``render_rays(training=False)`` of a whole-frame device batch with
        the evaluation parameters: ((pred [H, W, 3], depth [H, W]) as numpy,
        the state the render leaves). Under data parallelism a frame with no
        noises and an audio window whose ray count divides the world renders
        sharded (JAX trainer.py:736-738); any other renders whole on every
        rank."""
        H, W = batch["H"], batch["W"]
        with span("frame"):
            with self._eval_params():
                if (self.world is not None and noises is None and batch.get("auds") is not None
                        and batch["rays_o"].shape[0] % self.world[1] == 0):
                    results, state = render_frame_dp(self.net, self.render_cfg, self.state,
                                                     batch, self.world)
                else:
                    results, state = render_rays(
                        self.net, self.render_cfg, self.state, batch["rays_o"],
                        batch["rays_d"], batch.get("auds"), batch["bg_coords"], batch["poses"],
                        batch.get("eye"), batch["index"], batch["bg_color"], noises=noises,
                        poses_matrix=batch.get("poses_matrix"))
            with sync("image"):
                pred = results["image"].reshape(H, W, 3).cpu().numpy()
            with sync("depth"):
                depth = results["depth"].reshape(H, W).cpu().numpy()
        return (pred, depth), state

    @staticmethod
    def _normalize_depth(depth: np.ndarray) -> np.ndarray:
        """Depth to the frame's own range, for the PNGs (world-unit depth
        would saturate a plain clip)."""
        d = np.asarray(depth, np.float32)
        lo, hi = float(d.min()), float(d.max())
        return (d - lo) / max(hi - lo, 1e-6)

    def eval_step(self, batch: dict):
        """One evaluation frame (utils.py:812-838): (pred, depth) numpy."""
        return self._render_frame(batch)[0]

    def evaluate(self, dataset, name: Optional[str] = None):
        self.evaluate_one_epoch(dataset, name)

    def evaluate_one_epoch(self, dataset, name: Optional[str] = None):
        """Render the dataset's first ``eval_count`` (default all) frames:
        their mean squared error against the ground truth, the metrics, and
        with a workspace ``validation/<name>_<i>_{rgb,depth}.png``
        (utils.py:1237-1300), rank 0's alone under data parallelism; with a
        tensorboard writer open, each meter's scalar at the epoch."""
        self.log(f"++> Evaluate at epoch {self.epoch} ...")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        for metric in self.metrics:
            metric.clear()
        save_path = (os.path.join(self.workspace, "validation")
                     if self.workspace and self.is_main else None)
        if save_path:
            os.makedirs(save_path, exist_ok=True)
        total, count = 0.0, 0
        for i in range(min(len(dataset), getattr(dataset, "eval_count", len(dataset)))):
            batch = self.next_batch(dataset, i)
            pred, depth = self.eval_step(batch)
            gt = batch["images"].reshape(pred.shape[0], pred.shape[1], -1)[..., :3]
            pred_save = pred
            if self.opt.color_space == "linear":
                # loss and metrics in linear space; the PNG in sRGB
                gt = srgb_to_linear(gt)
                pred_save = linear_to_srgb(torch.from_numpy(np.clip(pred, 0, 1))).numpy()
            with sync("eval_truth"):
                gt = gt.cpu().numpy()
            total += float(np.mean((pred - gt) ** 2))
            count += 1
            for metric in self.metrics:
                metric.update(pred, gt)
            if save_path:
                write_png(os.path.join(save_path, f"{name}_{i:04d}_rgb.png"),
                          (np.clip(pred_save, 0, 1) * 255).astype(np.uint8))
                write_png(os.path.join(save_path, f"{name}_{i:04d}_depth.png"),
                          (np.clip(self._normalize_depth(depth), 0, 1) * 255).astype(np.uint8))
        avg = total / max(count, 1)
        self.stats["valid_loss"].append(avg)
        self.stats["results"].append(self.metrics[0].measure() if self.metrics else avg)
        for metric in self.metrics:
            self.log(metric.report())
            if self.writer is not None:
                metric.write(self.writer, self.epoch, prefix="evaluate")
            metric.clear()
        self.log(f"++> Evaluate epoch {self.epoch} Finished, loss={avg:.6f}")

    def test_step(self, batch: dict, bg_color=None, perturb=False):
        """Render one frame (utils.py:841-868) and keep the state it leaves
        (``smooth_lips`` advances the audio code from frame to frame).
        ``fix_eye`` >= 0 replaces the eye value; ``bg_color`` the background;
        ``perturb``, falsy or an int seed, jitters the march."""
        if self.opt.exp_eye and self.opt.fix_eye >= 0:
            batch["eye"] = torch.full((1, 1), self.opt.fix_eye, device=self.device)
        if bg_color is not None:
            batch["bg_color"] = torch.as_tensor(bg_color, dtype=torch.float32,
                                                device=self.device)
        noises = None
        if perturb:
            noises = torch.rand(batch["rays_o"].shape[0], device=self.device,
                                generator=torch.Generator(self.device).manual_seed(int(perturb)))
        frame, self.state = self._render_frame(batch, noises)
        return frame

    def test(self, dataset, save_path: Optional[str] = None, name: Optional[str] = None,
             write_image: bool = False) -> float:
        """Render every frame of the dataset into ``<save_path>/<name>.mp4``
        (default ``<workspace>/results``; per-frame PNGs without an mp4
        writer) at 25 fps (utils.py:923-973), rank 0's alone under data
        parallelism; returns the frames rendered per second, batches and host
        copies included."""
        if save_path is None:
            if not self.workspace:
                raise ValueError("test needs a save_path or a trainer workspace")
            save_path = os.path.join(self.workspace, "results")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        if self.is_main:
            os.makedirs(save_path, exist_ok=True)
        self.log(f"==> Start Test, save results to {save_path}")
        frames = []
        t0 = time.perf_counter()
        for i in range(len(dataset)):
            pred, depth = self.test_step(self.next_batch(dataset, i))
            if self.opt.color_space == "linear":
                pred = linear_to_srgb(torch.from_numpy(np.clip(pred, 0, 1))).numpy()
            img = (np.clip(pred, 0, 1) * 255).astype(np.uint8)
            if write_image and self.is_main:
                write_png(os.path.join(save_path, f"{name}_{i:04d}_rgb.png"), img)
                write_png(os.path.join(save_path, f"{name}_{i:04d}_depth.png"),
                          (np.clip(self._normalize_depth(depth), 0, 1) * 255).astype(np.uint8))
            frames.append(img)
        fps = len(frames) / max(time.perf_counter() - t0, 1e-9)
        self.log(f"==> Rendered {len(frames)} frames at {fps:.2f} FPS")
        if self.is_main:
            write_video(os.path.join(save_path, f"{name}.mp4"), np.stack(frames, 0))
        self.log("==> Finished Test.")
        return fps

    # ----------------------------------------------- the interactive app
    def train_gui(self, dataset, step: int = 16) -> dict:
        """A training burst of the interactive app (utils.py:976-1035): the
        untrained cells marked at step 0, then ``step`` loop steps (the
        upkeep when due) over the dataset's epoch order; returns the mean
        loss as {"loss": float}."""
        if self.global_step == 0:
            self.state = mark_untrained_grid(self.render_cfg, self.state, dataset.poses,
                                             tuple(dataset.intrinsics))
        order = dataset.epoch_indices()
        losses = [self.step(dataset, order[s % len(order)]) for s in range(step)]
        with sync("burst_loss"):
            return {"loss": float(torch.stack(losses).mean())}

    def test_gui(self, pose, intrinsics, W: int, H: int, auds=None, eye: float = 0.25,
                 index: int = 0, bg_color=None, spp: int = 1, downscale: float = 1):
        """A free-viewpoint frame (utils.py:1037-1135): {"image" [H, W, 3],
        "depth" [H, W]} numpy, rendered at ``downscale`` of (H, W) and
        resized back (bilinear image, nearest depth, through cv2), in sRGB
        with ``color_space == "linear"``. The rays are built on the device
        from the 4x4 ``pose`` and (fx, fy, cx, cy) ``intrinsics``; ``auds``
        is the audio window (numpy or a tensor) or None; ``bg_color`` the
        background ([H*W, 3], area-resized on the device to the render's
        size, or already at the render's size), white when None;
        ``spp`` > 1 perturbs the march, seeded by ``spp``."""
        rH, rW = int(H * downscale), int(W * downscale)
        dev = self.device
        rays_o, rays_d = rays_from_pixels(
            torch.as_tensor(np.asarray(pose, np.float32)).to(dev),
            np.asarray(intrinsics) * downscale, torch.arange(rH * rW, device=dev), rW)
        if bg_color is None:
            bg = torch.ones((rH * rW, 3), device=dev)
        else:
            bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev).reshape(-1, 3)
            if bg.shape[0] == H * W and (rH, rW) != (H, W):
                # the app's full-size background at the render's size (JAX
                # passes it as it is, and its render fails on the shapes)
                bg = torch.nn.functional.interpolate(
                    bg.view(1, H, W, 3).permute(0, 3, 1, 2), size=(rH, rW),
                    mode="area").permute(0, 2, 3, 1).reshape(-1, 3)
        if (rH, rW) not in self._bg_coords:
            self._bg_coords[(rH, rW)] = _to_tensor(get_bg_coords(rH, rW), dev)
        batch = self.to_device({
            "rays_o": rays_o, "rays_d": rays_d, "H": rH, "W": rW,
            "bg_coords": self._bg_coords[(rH, rW)],
            "poses": convert_poses(np.asarray(pose, np.float32)[None]),
            "poses_matrix": np.asarray(pose, np.float32)[None], "auds": auds,
            "eye": np.asarray([[eye]], np.float32) if self.opt.exp_eye else None,
            "index": index, "bg_color": bg})
        pred, depth = self.test_step(batch, perturb=False if spp == 1 else spp)
        if (rH, rW) != (H, W):
            import cv2

            pred = cv2.resize(pred, (W, H), interpolation=cv2.INTER_LINEAR)
            depth = cv2.resize(depth, (W, H), interpolation=cv2.INTER_NEAREST)
        if self.opt.color_space == "linear":
            pred = linear_to_srgb(torch.from_numpy(np.clip(pred, 0, 1))).numpy()
        return {"image": pred, "depth": depth}

    # ------------------------------------------------------------- meshes
    def save_mesh(self, save_path: Optional[str] = None, resolution: int = 256,
                  threshold: float = 10.0) -> str:
        """The density iso-surface as a PLY (utils.py:871-891), default
        ``<workspace>/meshes/<name>_<epoch>.ply``: sigma of the evaluation
        parameters on a ``resolution``^3 lattice over the box, with no audio
        code, on the device. A model with an eye input (``exp_eye``) takes
        the app's default eye value, 0.25 (JAX's query passes none there and
        fails on the shapes). Returns the path; under data parallelism the
        other ranks than 0 return it without a mesh."""
        save_path = save_path or os.path.join(self.workspace, "meshes",
                                              f"{self.name}_{self.epoch}.ply")
        if not self.is_main:
            return save_path
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        self.log(f"==> Saving mesh to {save_path}")
        e = torch.full((1, 1), 0.25, device=self.device) if self.net_cfg.eye_dim > 0 else None
        aabb = self.render_cfg.aabb
        with self._eval_params(), torch.no_grad():
            vertices, triangles = extract_geometry(
                aabb[:3], aabb[3:], resolution, threshold,
                lambda p: self.net.field_density(p, None, e)["sigma"], device=self.device)
        save_mesh_ply(save_path, vertices, triangles)
        self.log(f"==> Finished saving mesh ({len(vertices)} verts, {len(triangles)} faces).")
        return save_path

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
            self.log("[INFO] Training from scratch ...")
            return
        if use_checkpoint in ("latest", "latest_model"):
            path = ckpt_lib.latest_checkpoint(self.ckpt_path, self.name)
            if path is None:
                self.log("[WARN] No checkpoint found, model randomly initialized.")
                return
            self.load_checkpoint(path, model_only=use_checkpoint == "latest_model")
            return
        if use_checkpoint == "best":
            path = (self.best_path if os.path.exists(self.best_path)
                    else ckpt_lib.latest_checkpoint(self.ckpt_path, self.name))
            if path:
                self.load_checkpoint(path)
            return
        self.log(f"[INFO] Loading {use_checkpoint} ...")
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
        self.optimizer, self.scheduler = self._optimizer(step)
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
        ``full`` (utils.py:1302-1360). ``best`` writes the best checkpoint
        ``<workspace>/checkpoints/<self.name>.npz`` instead: the evaluation
        parameters (the EMA, else the live ones) and the renderer state
        without its density grid; before any evaluation it warns and writes
        nothing, as the JAX trainer does. Under data parallelism only rank 0
        writes."""
        if not self.workspace:
            raise ValueError("the trainer has no workspace to save a checkpoint in")
        if not self.is_main:
            return
        if best and not self.stats["results"]:
            self.log("[WARN] no evaluated results found, skip saving best checkpoint.")
            warnings.warn("no evaluated results found; the best checkpoint is not saved")
            return
        name = name or f"{self.name}_ep{self.epoch:04d}"
        rc = self.render_cfg
        meta = {
            "epoch": self.epoch,
            "global_step": self.global_step,
            "mean_density": float(self.state.mean_density),
            "mean_density_torso": float(self.state.mean_density_torso),
            # the adapted capacities and the march lattice the field was
            # trained with: a fresh JAX trainer at default capacities drops
            # work (PARITY.md), and another K or S changes the quadrature
            "render_cfg": {k: getattr(rc, k) for k in CAPACITY_FIELDS},
            "grid_shape": self._grid_shape_id(),
            "arch": self.net_cfg.arch,
        }
        if best:
            params = (jax_from_state_dict({k: v.cpu().numpy() for k, v in self.ema_params.items()})
                      if self.ema_params is not None else network_to_jax(self.net))
            ckpt_lib.save_checkpoint(self.best_path, params, self.state, meta=meta,
                                     include_grid=False)
            return
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
        rebuilt, the seven capacities restored but for those the user set
        (kept, with a warning) and, on a ``model_only`` load, all of them
        when the trainer has restored its own already; and unless
        ``model_only`` the epoch and step counts. Adam starts afresh, then
        takes the checkpoint's moments and schedule on a full load (the
        port's own, or a JAX checkpoint's optax state)."""
        if path.endswith(".pth"):
            ckpt_lib.check_arch(path, {}, self.net_cfg.arch)
            params, arrays, meta = ckpt_lib.import_torch_checkpoint(path)
            self._load_params(params)
            self._apply_state_arrays(arrays, meta)
            self.optimizer, self.scheduler = self._optimizer()
            self.log(f"[INFO] imported torch checkpoint ({len(params)} groups).")
            return
        params, state, ema, opt_flat, meta = ckpt_lib.load_checkpoint(path)
        ckpt_lib.check_arch(path, meta, self.net_cfg.arch)
        self._check_grid_shape(path, meta, params)
        cap = {k: v for k, v in (meta.get("render_cfg") or {}).items() if k in CAPACITY_FIELDS}
        # a model-only load (freeze_loaded_head) keeps the capacities a
        # trainer has already restored from its own checkpoint
        if model_only and self._cap_restored:
            cap = {}
        if cap and self._user_cap_fields:
            # the capacities the user set beat the checkpoint's record
            skipped = {k: v for k, v in cap.items() if k in self._user_cap_fields}
            if skipped:
                self.log(
                    "[WARN] checkpoint carries trained render capacities "
                    f"{skipped} but these fields were explicitly set at "
                    "construction — keeping the constructor values "
                    f"({ {k: getattr(self.render_cfg, k) for k in skipped} }).")
            cap = {k: v for k, v in cap.items() if k not in self._user_cap_fields}
        if cap:
            self.render_cfg = rc = dataclasses.replace(self.render_cfg, **cap)
            self.log("[INFO] restored trained render capacities "
                     f"(frac={rc.ray_capacity_frac} mult={rc.sample_capacity_mult} "
                     f"K={rc.march_iters} slots={rc.sample_slots})")
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
            self.log("[INFO] restored optimizer state.")
        else:
            self.optimizer, self.scheduler = self._optimizer()
        self.log(f"[INFO] loaded checkpoint {path} (epoch {self.epoch}).")

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
                st, occ_bbox=compute_occ_bbox(rc, st.density_grid, thresh),
                occ_sphere=compute_occ_sphere(rc, st.density_grid, thresh),
            ).with_sigma_bytes(build_sigma_bytes(st.density_grid, thresh))
            if "density_bitfield" not in arrays:
                st = dataclasses.replace(st, density_bitfield=packbits(st.density_grid,
                                                                       thresh))
        else:
            if "sigma_bytes" in arrays:
                st = st.with_sigma_bytes(tensor("sigma_bytes", torch.uint8,
                                                st.sigma_bytes.shape))
            elif "density_bitfield" in arrays:
                occ = unpackbits(st.density_bitfield, rc.cascade, rc.grid_size).reshape(-1)
                st = st.with_sigma_bytes(torch.where(occ > 0, 129, 0).to(torch.uint8))
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
