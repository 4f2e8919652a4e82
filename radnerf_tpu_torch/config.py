"""Training options of the port (a copy of the ``radnerf_tpu/config.py``
``Options`` fields the port reads, with the same names and defaults;
reference main.py:12-108)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Options:
    seed: int = 0
    workspace: str = "workspace"
    # the head stage's checkpoint the torso stage starts from
    head_ckpt: str = ""

    # training
    iters: int = 200_000
    lr: float = 5e-3
    lr_net: float = 5e-4
    num_rays: int = 4096 * 16
    max_steps: int = 16
    update_extra_interval: int = 16
    ema_update_interval: int = 1000

    # precision / losses
    fp16: bool = False
    lambda_amb: float = 0.1

    # appearance / conditioning
    exp_eye: bool = False
    torso_shrink: float = 0.8

    # scene
    color_space: str = "srgb"
    bound: float = 1.0
    dt_gamma: float = 1.0 / 256
    cull_T: float = 1e-6
    min_near: float = 0.05
    density_thresh: float = 10.0
    density_thresh_torso: float = 0.01
    patch_size: int = 1
    finetune_lips: bool = False
    smooth_lips: bool = False
    torso: bool = False

    # audio and codes
    att: int = 2
    emb: bool = False
    ind_dim: int = 4
    ind_num: int = 10_000
    ind_dim_torso: int = 8
    amb_dim: int = 2
    train_camera: bool = False
    asr_model: str = "cpierse/wav2vec2-large-xlsr-53-esperanto"

    # grid shape and march length
    grid_levels: int = 16
    grid_ch: int = 2
    grid_base: int = 16
    amb_grid_levels: Optional[int] = None
    amb_grid_ch: Optional[int] = None
    amb_grid_base: Optional[int] = None
    march_iters: Optional[int] = None

    @property
    def audio_in_dim(self) -> int:
        # network.py:114-119
        if "esperanto" in self.asr_model:
            return 44
        if "deepspeech" in self.asr_model:
            return 29
        return 32
