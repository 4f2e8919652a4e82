"""Options of the port (a copy of the ``radnerf_tpu/config.py`` ``Options``
fields the port reads, with the same names and defaults; reference
main.py:12-108). The capacity knobs are JAX's: ``auto_capacity`` adapts
the render capacities to each upkeep's telemetry (``train/capacity.py``),
``sample_capacity_mult`` and ``ray_capacity_frac`` start them, and
``cap_overrides`` names the ones the user set, which beat a checkpoint's
record. The port drops no work at any of them: of the capacities only K,
S and the group slots change what it renders. ``data_parallel`` shards the training batches and frames over the ranks of
an initialised ``torch.distributed`` group (``parallel/mesh.py``); no CLI
flag sets it, as none of JAX's does."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Options:
    # data
    path: str = ""
    workspace: str = "workspace"
    seed: int = 0
    data_range: Tuple[int, int] = (0, -1)
    # the head stage's checkpoint the torso stage starts from
    head_ckpt: str = ""

    # training
    iters: int = 200_000
    lr: float = 5e-3
    lr_net: float = 5e-4
    ckpt: str = "latest"
    num_rays: int = 4096 * 16
    max_steps: int = 16
    update_extra_interval: int = 16
    ema_update_interval: int = 1000
    # accepted for the reference CLI only: its staged renderer, which chunks
    # by it, is unreachable from its own main.py (cuda_ray forced on)
    max_ray_batch: int = 4096
    # shard ray batches and frames over the ranks of the process group
    # the caller started (torchrun); without one, or at one rank, a no-op
    data_parallel: bool = False

    # precision / losses
    fp16: bool = False
    lambda_amb: float = 0.1

    # appearance / conditioning
    bg_img: str = ""
    exp_eye: bool = False
    fix_eye: float = -1.0
    smooth_eye: bool = False
    torso_shrink: float = 0.8

    # scene
    color_space: str = "srgb"
    # where the dataset keeps its frames: 0 decoded from disk at each
    # batch, 1 on the host, 2 on the device
    preload: int = 0
    bound: float = 1.0
    scale: float = 4.0
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dt_gamma: float = 1.0 / 256
    cull_T: float = 1e-6
    min_near: float = 0.05
    density_thresh: float = 10.0
    density_thresh_torso: float = 0.01
    patch_size: int = 1
    finetune_lips: bool = False
    smooth_lips: bool = False
    # LPIPS-alex calibration weights (npz or torch file); empty: the
    # metric's uncalibrated seeded filters
    lpips_weights: str = ""
    torso: bool = False

    # the interactive app (``--gui``): its view and progressive supersampling
    gui: bool = False
    W: int = 450
    H: int = 450
    radius: float = 3.35
    fovy: float = 21.24
    max_spp: int = 1

    # audio and codes
    att: int = 2
    aud: str = ""
    emb: bool = False
    ind_dim: int = 4
    ind_num: int = 10_000
    ind_dim_torso: int = 8
    amb_dim: int = 2
    part: bool = False
    part2: bool = False
    train_camera: bool = False
    smooth_path: bool = False
    smooth_path_window: int = 7
    # streaming audio features (``--asr``): a wav file, or the microphone
    # when empty; 20 ms chunks at ``fps`` = 50 and a CTC window of l + m + r
    # chunks
    asr: bool = False
    asr_wav: str = ""
    asr_play: bool = False
    asr_model: str = "cpierse/wav2vec2-large-xlsr-53-esperanto"
    asr_save_feats: bool = False
    fps: int = 50
    l: int = 10
    m: int = 50
    r: int = 10

    # test mode
    test: bool = False
    test_train: bool = False
    pose: str = ""  # inference only: the pose json

    # the field: "radnerf" (RAD-NeRF's, the default) or "ernerf" (ER-NeRF's
    # tri-plane field with region attention and adaptive pose encoding;
    # rendering only, in float32: models/network_triplane.py)
    arch: str = "radnerf"

    # grid shape and the render capacities
    grid_levels: int = 16
    grid_ch: int = 2
    grid_base: int = 16
    amb_grid_levels: Optional[int] = None
    amb_grid_ch: Optional[int] = None
    amb_grid_base: Optional[int] = None
    sample_capacity_mult: float = 4.0  # JAX's field-eval buffer = mult * num_rays
    march_iters: Optional[int] = None  # None -> the safe bound from MarchConfig
    ray_capacity_frac: float = 1.0  # JAX's occupied-box ray compaction capacity
    # adapt the render capacities to the measured occupancy at each upkeep
    # inside an epoch (the mean_count analogue, raymarching.py:224-229)
    auto_capacity: bool = True
    # capacity fields the user set explicitly (main.py's options_from_args
    # records the flags typed): the trainer keeps these over a checkpoint's
    # record and restores every other one from it
    cap_overrides: Tuple[str, ...] = ()

    def apply_O(self) -> "Options":
        """-O bundle: fp16 + exp_eye (main.py:111-113)."""
        self.fp16 = True
        self.exp_eye = True
        return self

    def apply_test_mode(self) -> "Options":
        """Test-mode smoothing defaults (main.py:115-118)."""
        self.test = True
        self.smooth_path = True
        self.smooth_eye = True
        self.smooth_lips = True
        return self

    @property
    def audio_in_dim(self) -> int:
        # network.py:114-119
        if "esperanto" in self.asr_model:
            return 44
        if "deepspeech" in self.asr_model:
            return 29
        return 32
