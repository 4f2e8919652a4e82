#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (radnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the hand-written CUDA kernels: one
512x512 head+torso inference frame of the bench scene
(radnerf_tpu_torch/scene.py, a copy of bench.py's) at the shipped model
widths in float32 (kernels A, B, C); a head-stage training run from scratch
at full width (A, B, C and the backward kernels A', C'); the gather study
at the Pallas row-loop kernel's shapes (kernel D); the torso stage from the
head run's checkpoint (A, A', B, C; no C'); that checkpoint loaded into a
fresh trainer; and the CLIs. Every training phase reads the same
processed-video directory, written in a temporary place (deleted at the
end) before phase 7: 8 frames of 512x512 rendered by the frame path, their
RGBA torso plates, landmarks, background, audio table and train / val
transforms, every image PNG content under the format's own names; loaded
with ``--preload 2``, so each batch is built on the card.

The frame:

  1. device: the nvidia-smi name and power limit, torch and CUDA versions;
  2. build: every kernel from radnerf_tpu_torch/csrc, one nvcc per source,
     all at once;
  3. main path: one frame with every launch count set to 0 just before and
     read just after; every kernel must have launched;
  4. kernels against their plain twins at the shapes that frame gave them;
  5. the frame against the same frame rendered through the twins on the
     CPU: PSNR, telemetry, head visibility;
  6. timing: the frame over 30 frames, a torch.profiler breakdown of 3
     frames and of 3 torso passes alone (the torso's share of the GEMMs and
     `cat` copies), and each kernel beside its bound, its twin and (where
     one exists) a single PyTorch call; kernel A per call.

ER-NeRF's frame (``ernerf_phase``; ``build_scene(arch="ernerf")``, 512x512,
float32), after phase 6: the points ``encode_x`` gives kernel A-tri on one
eager frame, A-tri held to its plain twin on them bit for bit
(``torch.equal``); ERNERF_FRAMES frames through ``render_rays`` with every
launch count and the graphs' counts set to 0 just before: A-tri, A (the
torso's encode), B and C once a frame (a replayed segment counted as
``frames_ran`` counts it); A-tri's ms, device ms and plain ms on those
points beside its bound (``triplane_work``).

Training (``NetworkConfig(torso=False, exp_eye=True)``, ``Options``
defaults: 65,536 rays, grid 128, max_steps 16, upkeep every 16 steps):
  7. train: the directory's dataset (``TalkingHeadDataset``), the trainer
     started as main.py starts it (seeded init, empty
     state, untrained cells marked, upkeep at step 0 and every 16 steps),
     48 steps with every launch count set to 0 just before and read just
     after; every kernel but D must have launched, every loss is finite,
     the grid is non-empty after the first upkeep, and the loss on one
     fixed batch falls;
  8. the backward kernels, the perturbed march and the compositor against
     their plain versions at the train step's shapes (C' on C's outputs);
     A' also on as many points spread uniformly over the box (no
     contention);
  9. the gather study: kernel D at P = 2 Mi rows of 16 bf16, T in {4096,
     65536}, counts from 0, bit for bit with ``table[idx]``;
 10. timing: the trainer's own loop entry (``Trainer.step``: upkeep when
     due, the card's batch, step) fenced call by call, so the step's ms and the
     upkeep's; a torch.profiler breakdown of 3 steps; the batch preparation
     alone; and the kernels beside their bounds, plain versions and (for
     D) ``index_select``: A' on the step's points and on the spread ones; A
     on the step's D = 3 points (held bit for bit to its twin); B (with
     noises) and C on phase 8's inputs, with their launches in the run.

The torso stage (``Options(torso=True, exp_eye=True)``: full width, 65,536
rays, grid 128, upkeep every 16 steps), as main.py runs it with
``--torso --head_ckpt``:
 11. torso_train: phase 7's head trainer saved as a full checkpoint in a
     temporary workspace (deleted at the end), a fresh torso trainer that
     loads it with ``freeze_loaded_head``, 32 steps on the directory's
     torso dataset (the torso plate over the background is the target)
     with every launch count set to 0 just before and read just after: A
     launched, A', B and C 32 times, C' never; every head parameter equal
     to the checkpoint's and frozen, every torso parameter moved, every
     loss finite, the torso grid non-empty after the first upkeep, pixels
     under the torso mask at the last step, the fixed batch's torso loss
     falling;
 12. torso_kernel_checks: A' at a torso step's own inputs (the deformed
     points, the torso table, the upstream gradient) against autograd
     through the plain encode; A at the torso upkeep's 16,384 points bit
     for bit with its plain version;
     torso_timing: ``Trainer.step`` of the torso stage fenced call by call
     (median), a torch.profiler breakdown of 3 steps, A' and A at those
     shapes beside their bounds and plain versions;
 13. checkpoint: a fresh head trainer loads the phase-11 checkpoint: its
     parameters and renderer state equal the writer's, and it renders the
     512x512 frame bit for bit as the writer does.

The dataset and the entry points, on the same directory:
 14. dataset: phase 7's dataset, whose frames on the card must equal the
     decoded files; one training batch equal to the host's numpy gather of
     the same pixels bit for bit, its rays within one float32 ulp;
     ``next_batch`` timed against that numpy batch; one torso plate's
     decode timed through ``imread_u8`` and the port's own PNG reader;
 15. entry: ``radnerf_tpu_torch.main`` in this process at full width
     (``--exp_eye --preload 2 --ema_update_interval 1``, 65,536 rays, 2
     epochs of the 8 frames, the evaluation, the test split evaluated and
     rendered) with every launch count set to 0 just before and read just
     after: A, A', B, C and C' launched, every loss finite,
     ``ngp_ep0002.npz`` and the best ``ngp.npz`` written, ``ngp.npz``
     holding the EMA, moved off the initial draw wherever training moved
     the live parameters, the eval PSNR finite, the validation PNGs and the
     test video (or its PNGs) written; then ``radnerf_tpu_torch.infer`` from
     that ``ngp.npz`` on a pose json and 6 audio rows: one frame each;
 16. entry_timing: that trainer's ``Trainer.step`` fenced call by call
     (median, beside phase 10's), a 3-step profile and its busy share, the
     batch preparation alone, A (both calls), B and C against their plain
     versions on one eval frame's own inputs (~4.2M samples, [262,144, 16]
     lattice), the eval frame fenced and profiled, ``test``'s FPS.

Data parallelism (``data_parallel_phase``), after phase 16 on the same
directory:
 data_parallel: this process's 1-rank head step, then two ranks spawned
     on this card (gloo: NCCL refuses two ranks on one device) with
     ``Options(data_parallel=True)``, loading the kernels built in phase 2:
     8 float32 head steps at 65,536 global rays with every launch count set
     to 0 just before and read just after on each rank (A, A', B, C, C'
     launched), the first step's loss and gradients against the 1-rank
     step's, every rank's parameters, Adam moments and state bit for bit
     alike; 2 -O steps (A-bf16, its packing pass, A'-bf16), in sync; the
     512x512 bench frame by ``render_frame_dp`` against the 1-rank frame
     (>= 60 dB, the same n_hit); the 2-rank step ms beside the 1-rank one,
     which two processes sharing one card make no scaling figure.

The grid and march variants (``variants_phase``, ``variant_kernel_checks``):
 variants: ``radnerf_tpu_torch.main --exp_eye --grid_levels 8 --grid_ch 4
     --bound 2 --max_steps 128`` on the same directory at full width (the
     JAX bench's 8x4 grid, 3-D and 2-D; cascade 2; the general orbit, K =
     257, S = 128), 16 steps, evaluation, test, then ``infer``, with every
     launch count set to 0 just before and read just after; an eval
     frame's peak memory reckoned first; the fixed batch's loss before and
     after; the step fenced and profiled, an eval frame fenced, profiled
     and its samples counted;
 variant_kernel_checks: A bit for bit and A' (per row of the table
     gradient, x within 1e-5) on that run's recorded step and eval calls,
     on ``get_encoder("hashgrid")`` at its defaults and on smoothstep,
     align_corners, 1- and 8-channel grids; B bit for bit on the recorded
     step (noises) and eval calls and at cascade 2 on the affine orbit;
     each beside its ms, plain ms and bound, one kernels-line entry per
     kernel and variant.

The two-level march and the bitfield march (``march_variants_phase``):
 march_variants: B-grouped and B-bitfield, B's variants. The sparse
     two-blob scene (``scene.build_sparse_scene``) and the portrait bench
     scene at 512x512, K = the frame's n_k_span rounded up to even, at most
     96: the frame with march_group off and on bit for bit, B-grouped
     launched once by the grouped frame (counts from 0) and bit for bit
     with its twin on the frame's rays (every kept group marched, and
     group_slots = n_group_max - 1), B and B-grouped in turns; 8 head steps
     with march_group on (counts from 0: B-grouped each step, B never),
     the fixed batch's loss falling, a step's march held to the twin;
     B-bitfield bit for bit with its twin, without and with the float-grid
     cull, on the bench frame's rays and the variants eval frame's
     (cascade 2, the general orbit), in turns with B; both kernels bit for
     bit with their twins on MARCH_ADVERSARIAL_RAYS rays of each adversarial
     call of ``radnerf_tpu_torch.studies.march`` (K = 96 over 3 coarse
     chunks, group_slots 0, 1 and 11, training noises, NaN nears; float-grid
     culls crossing at slots 1, 8, S - 1 and 2, negative, NaN and 1e12 grid
     values; S = 128 with count > S).

The adaptive capacities (``capacity_phase``, ``train/capacity.py``):
 capacity: three head-stage runs through ``Trainer.train`` at the
     ``Options`` defaults (``auto_capacity`` on) with an upkeep every
     CAP_UPKEEP steps, CAP_EPOCHS epochs, counts from 0, K, S and the group
     slots at each upkeep: from scratch (K adapted to the measured span);
     with ``march_group`` on (B before the first adaptation, B-grouped at
     every step once K <= MARCH_K_CAP; the group buffer adapted next);
     resumed at step 1 on the bench head's occupancy (K and S shrink to the
     head, at least two adaptations). B bit for bit, C and C' against their
     plain versions on that run's first adapted step; the step at the
     default and the adapted lattice in turns; the bench frame at
     ``fresh_render_config``'s lattice (JAX bench.py's two fresh passes at
     headroom 1.1), with and without ``march_group``, bit for bit with the
     default lattice's frame, its kernels against their plain versions,
     each frame fenced and profiled in turns. Measured only.

The bf16 policy (``-O``): the frame and the head step beside their float32
runs (bf16_frame, bf16_train), A-bf16 (on corner-packed tables), its
packing pass and A'-bf16 against their plain versions on the path's points
and on spread ones, A'-bf16 beside its reduction floor
(bf16_kernel_checks), the -O policy at other grids (bf16_variants,
bf16_variant_kernel_checks), and the README's -O recipe through the CLIs
(recipe: head, lips finetune, torso, --test, infer):
 bf16_variants: ``radnerf_tpu_torch.main -O --exp_eye --grid_levels 8
     --grid_ch 4`` on the same directory at full width (the JAX bench's 8x4
     grid under its bf16 policy; bound 1, max_steps 16), 16 steps, the
     evaluation, the test split, then ``--test``, ``--torso`` (8 steps, the
     torso grid at 4 channels too) and ``infer -O --torso``, each with every
     launch count set to 0 just before and read just after: A-bf16, its
     packing pass and A'-bf16 launched, the float32 A and A' never; the
     fixed batch's loss before and after; the head step fenced and profiled
     beside bf16_train's C = 2 step;
 bf16_variant_kernel_checks: A-bf16 and its packing pass bit for bit,
     A'-bf16 per row of the table gradient (x within 1e-5), on that step's
     recorded 4-channel calls and on 2^20 spread points at 1, 8, 3 and 16
     channels, smoothstep (D = 2) and align_corners (D = 3); float32 A bit
     for bit and A' per row at 3 and 16 channels on the same points; each
     beside its ms, device ms, plain ms and bound, one kernels-line entry
     per kernel and variant.

The grids past RAD-NeRF's (``lifted_phase``): D outside {2, 3}, more than 32
levels or 16 channels, which A, A', A-bf16, its packing pass and A'-bf16
run on their general path:
 lifted: ``main --exp_eye --amb_dim 4 --grid_levels 33 --grid_ch 17`` (a
     4-D ambient grid, 33 levels of 17 channels in every grid, float32) and
     ``main -O --exp_eye --amb_dim 1 --grid_levels 40 --grid_ch 32`` on the
     same directory at full width, each: LIFTED_STEPS head steps, the
     evaluation, the test split, ``--test``, ``--torso`` (LIFTED_TORSO_STEPS
     steps) and ``infer --torso``, each command with every launch count set
     to 0 just before and read just after (the run's grid kernels launched,
     the other policy's never), the fixed batch's loss falling, the files
     written; one more head step's grid calls recorded and held to their
     plain versions (A, A-bf16 and the packing bit for bit, A' and A'-bf16
     per row, as the variants checks hold them); then LIFTED_POINTS seeded
     points a grid of LIFTED_GRIDS (hash and tiled D = 1, 4, 7; tiled D = 8
     at 1 channel and 4 levels; 33 and 64 levels; 17, 32 and 64 channels,
     32 on a hash grid too) through A and A' with x and, on the tiled grids,
     A-bf16, its packing pass and A'-bf16, each held the same way, beside
     its ms, device ms, plain ms and bound; one kernels-line entry a kernel
     for each run and for the spread points.

Camera offsets, the live path, meshes (each path with the launch counts
set to 0 just before and read just after):
 camera: ``main -O --train_camera`` at full width, the offsets moved and
     kept by the checkpoint; a float32 step with offsets beside the same
     step without (fenced, profiled); the step through the kernels against
     the plain versions (loss, the offsets' and the tables' gradients), B's
     xyz against the positions formed again from its t, bit for bit;
 live: what ``infer -O --torso --gui --asr`` serves, built by that entry
     point (its ``serve`` captured) on the recipe's torso checkpoint, the
     speech features streamed from a seeded wav through a seeded stand-in
     acoustic model on the card: 30 playing frames fenced, the ASR's share,
     a profile; A-bf16, B and C on a live frame against their plain
     versions; progressive supersampling, a downscaled and a depth frame;
     ``serve`` on a free port, two JPEG parts of its stream; the training
     app of ``main -O --gui``: a 16-step ``train_gui`` burst;
 mesh: ``Trainer.save_mesh`` at 256^3 on the camera run's checkpoint: A's
     launches, the sweep, tetrahedra and PLY timed apart, A on a lattice
     chunk and the card's tetrahedra on a 64^3 sub-field against their
     plain and CPU results.

Preprocessing (``python -m radnerf_tpu_torch.process``), on the reference's
inputs at full size written in a temporary place (``preprocess_phase``):
 preprocess: a seeded synthetic 3DMM at the BFM's sizes (34,650 vertices,
     68,556 triangles, id 100, exp 79, tex 100) in the reference's three
     files, 64 frames of 512x512 rendered from it by the port's renderer
     over a seeded background, their landmarks, a 2.56 s wav and a seeded
     BiSeNet checkpoint; tasks 2, 4, 5, 6, 8 (with the photometric stage)
     and 9 through ``process.main`` with the launch counts set to 0 just
     before and read just after (kernel E launched), tasks 1 and 3 where
     ffmpeg is installed; task 4's masks, the BiSeNet on the card against
     the CPU, the focal and the landmark fit's reprojection error, the
     photometric loss falling in both stages, the landmark fit's id and exp
     stage on a second 3DMM whose bases move a landmark by pixels (the
     cell's move it by a fraction of one, so that the sweep can single out
     the true focal), the photometric refinement on the card against the
     CPU on the cell's first 10 frames, bc.jpg against the background, the
     torso alpha against the truth masks, ``main`` training 8 head steps on
     the written directory; E against ``rasterize_plain``
     on a photometric step's own inputs (64 x 512 x 512) bit for bit; the
     tasks' wall ms, the BiSeNet's ms a frame, the tracker's steps a
     second, the photometric step fenced and profiled, E against its bound
     (the function's own bytes) and the z-buffer's layout floor, the
     centres within one pixel of the triangles' boxes and those E tests
     after its trim beside those covered.

Each kernel's ``ms`` comes from ``cuda_ms``, whose events bracket the
calls as the host enqueues them (a kernel shorter than its wrapper's Python
reads the host); ``device_ms`` times the same calls queued on the card.
Kernel C's entries also carry its layout floor: the bytes the [N, S]
lattice makes any compositor move (whole valid rows, whole 32-byte sectors
around each processed step), which its bound does not count.

Each phase prints one JSON line; then the kernels line (A' also carries its
torso-stage reading in the report), the nvidia-smi line, and last the
device line. Any failed check raises, and the script exits
non-zero. It exits non-zero without a CUDA device, and outside the
repository (the port is imported from the checkout). A full report goes to
chiprun_out/chip_smoke.json, the profiler's tables to
chiprun_out/chip_smoke_profile.txt and chiprun_out/chip_smoke_train_profile.txt.
The torso and entry steps', the live frame's and the photometric step's
tables go beside them.
"""

import contextlib
import copy
import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# kernel-vs-twin tolerances (max |kernel - twin|): kernels and twins run the
# same float32 ops in the same order (kernels built with -fmad=false), so
# the expected difference is 0; the room left is for a last-ulp difference
# between CUDA's expf/exp2f and PyTorch's, times the values' size
TOL_GRID = 1e-5       # tables U(-4, 4): 1e-5 is ~40 ulp of the largest value
TOL_MARCH = 1e-6      # t ~ 3, xyz ~ 1: identical ops, same cells
TOL_COMPOSITE = 1e-5  # depth ~ 3
# kernel B's sample set (valid rows and per-ray counts) must equal the
# twin's exactly: both decide every step with the same float32 ops, exp2f
# included, so a differing ray is a fault; unused slots must hold exact 0s
MIN_FRAME_PSNR_DB = 60.0  # kernel frame vs twin frame on the CPU
# backward kernels vs autograd through the plain versions, as max|diff| over
# the tensor's max|value|: A' adds into the table with atomics in an order
# that changes from run to run (autograd's index_put accumulates in its
# own), C' takes suffix sums from the saved outputs where autograd
# multiplies through the transmittance chain: float32 sums in another order
TOL_BACKWARD_REL = 1e-5
# A''s table gradient: a row that sums n contributions in two orders differs
# by about sqrt(n) float32 roundings of the partial sums (a random walk), so
# its tolerance is max(TOL_BACKWARD_REL, 4 * sqrt(n_busiest) * 2^-24) with
# n_busiest the most contributions any row of this run takes (the untrained
# ambient MLP sends ~1M samples into the same few 2-D cells)

# ER-NeRF's phase: the frames it renders with the counts zeroed (the first
# eager, the second capturing, the rest replayed)
ERNERF_FRAMES = 8
# the frame's kernels, the training run's, the gather study's
FRAME_KERNELS = ("grid_encode", "march_rays", "composite_rays")
TRAIN_KERNELS = FRAME_KERNELS + ("grid_encode_backward", "composite_rays_backward")
REPLACES = {
    "grid_encode": "radnerf_tpu/ops/grid_encode.py:168",
    "grid_encode_backward": "radnerf_tpu/ops/grid_encode.py:168",
    "march_rays": "radnerf_tpu/ops/marching.py:374",
    # the bitfield branch (:466-470, occupancy_lookup_wide :188) and the
    # float-grid cull (:490-509) of march_rays; march_rays_grouped
    "march_rays_bitfield": "radnerf_tpu/ops/marching.py:374",
    "march_rays_grouped": "radnerf_tpu/ops/marching.py:523",
    "composite_rays": "radnerf_tpu/ops/marching.py:731",
    "composite_rays_backward": "radnerf_tpu/ops/marching.py:731",
    "row_gather": "scripts/bench_gather.py:79",
    # the bf16 policy: build_packed_table(dtype=bfloat16) + the bf16 lerp
    "grid_encode_bf16": "radnerf_tpu/ops/grid_encode.py:308",
    "grid_encode_backward_bf16": "radnerf_tpu/ops/grid_encode.py:308",
    # A-bf16's packing pass: the corner-packed rows of the -O tables
    "grid_pack_bf16": "radnerf_tpu/ops/grid_encode.py:243",
    # with _bin_triangles (:172), vmapped per frame in Render3DMM.__call__
    "rasterize": "radnerf_tpu/preprocess/render_3dmm.py:218",
    # ER-NeRF's three GridEncoder calls and their cat (no JAX form)
    "triplane_encode": "ER-NeRF nerf_triplane/network.py encode_x",
}
BF16_KERNELS = ("grid_encode_bf16", "grid_encode_backward_bf16", "grid_pack_bf16")
# the README's -O recipe: head steps, lips finetune steps, torso steps
RECIPE_HEAD_STEPS, RECIPE_LIPS_STEPS, RECIPE_TORSO_STEPS = 8, 8, 8
TRAIN_STEPS = 48
TORSO_STEPS = 32
TRAIN_SIZE = 512  # the targets' height and width
# the on-disk dataset of phases 14-16: its frames, the validation (and test)
# split's, the entry run's epochs, the audio rows infer renders
DATASET_FRAMES, VAL_FRAMES, ENTRY_EPOCHS, INFER_FRAMES = 8, 4, 2, 6
# the data_parallel phase: its ranks (gloo, sharing this card), float32
# head steps (one epoch of the 8 frames), -O steps; a collective's and the
# whole spawn's time limits
DP_WORLD, DP_STEPS, DP_BF16_STEPS = 2, 8, 2
DP_COLLECTIVE_S, DP_TIMEOUT_S = 300, 600
PROFILED_STEPS = 3
GATHER_ROWS, GATHER_WIDTH, GATHER_TABLES = 2 * 1024 * 1024, 16, (4096, 65536)
# the camera phase: -O steps through the CLI, float32 steps of each trainer
# timed in turns; a whole step, kernels against plain versions: the loss (rel)
# and each gradient (of its largest), the CPU step check's tolerances
CAMERA_STEPS, CAMERA_TIMED_STEPS = 8, 10
TOL_STEP_REL, TOL_STEP_GRAD = 1e-5, 1e-4
# the live phase: its frames, their side, the wav's seconds
LIVE_FRAMES, LIVE_SIZE, LIVE_SECONDS = 30, 512, 3.0
# the mesh phase: save_mesh's defaults; the side of the sub-field the card's
# tetrahedra are held to the CPU's on
MESH_RESOLUTION, MESH_THRESHOLD, TETRA_CHECK = 256, 10.0, 64
# the preprocess phase: the reference's inputs at full size -- the BFM's
# sizes (a 175 x 198 vertex lattice: 34,650 vertices, 68,556 triangles; id
# 100, exp 79, tex 100), one photometric window of 64 frames of 512x512 at
# focal 1100 (one of the sweep's candidates), 2.56 s of audio (64 frames at
# 25 fps), then 8 head steps of main on the written directory
PRE_FRAMES, PRE_SIZE, PRE_FOCAL, PRE_SECONDS = 64, 512, 1100.0, 2.56
PRE_LATTICE, PRE_DIMS, PRE_TRAIN_STEPS = (175, 198), (100, 79, 100), 8
# the synthetic 3DMM's id and exp basis amplitudes: the pipeline's (chosen so
# that the focal sweep can single out the true focal: a landmark moves by a
# fraction of a pixel) and the id/exp check's (a landmark moves by pixels)
PRE_AMPS, IDEXP_AMPS = (0.001, 0.005), (0.01, 0.05)
# its checks: the BiSeNet's logits on the card against the CPU's, as
# max|diff| over max|logit| (TF32 off; cuDNN's convolution algorithms sum in
# other orders: float32 sums of up to 4,608 terms through 18 layers); the
# tracker's mean landmark reprojection error; bc.jpg against the background
# where the background was seen (the frames and the plate are JPEGs, the
# frames at quality 100, the plate at cv2's 95: |diff| in 8-bit levels)
TOL_BISENET_REL, MAX_REPROJ_PX, TOL_BG_MEAN, TOL_BG_P99 = 1e-4, 1.0, 2.0, 10.0
# the tracker's id and exp on the card, beside the cell: photometric_refine on
# the card against the CPU on the cell's first 10 frames in windows of 5 (the
# second with the laplacian over the 5 frames before it): the steps' losses
# (rel), each parameter's max|diff| over its largest |value|, the projected
# landmarks (px). Both run the same float32 operations, summed in other
# orders; an Adam step moves a parameter by up to its learning rate (0.01 for
# stage 1's id and exp), so a skipped or wrong update shows at 1e-2
PHOTO_CHECK = {"frames": 10, "batch_size": 5, "light_iters": 6, "fine_iters": 4}
TOL_PHOTO_LOSS_REL, TOL_PHOTO_PARAM_REL, TOL_PHOTO_LMS_PX = 1e-3, 1e-2, 1e-2
# the variants phase: the JAX bench's 8x4 grid (bench.py:47-58; 3-D and 2-D)
# at bound 2 (cascade 2) with max_steps 128 (dt_min < dt_max: the general
# orbit, K = 257), through main's flags; 16 steps (2 epochs of the 8
# frames), then fenced and profiled steps; the variant checks' points (2^20,
# get_encoder's hash grid at its defaults among them) and their grids
VARIANT_FLAGS = ["--grid_levels", "8", "--grid_ch", "4", "--bound", "2", "--max_steps", "128"]
VARIANT_STEPS, VARIANT_TIMED_STEPS, VARIANT_POINTS = 16, 8, 1 << 20
VARIANT_GRIDS = {  # name -> GridSpec.create arguments (16 levels, desired 2048)
    "smoothstep": dict(input_dim=2, interpolation="smoothstep"),
    "align_corners": dict(input_dim=3, align_corners=True),
    "c1": dict(input_dim=3, level_dim=1),
    "c8": dict(input_dim=3, level_dim=8),
}
# the bf16_variants phase: the -O policy at the JAX bench's 8x4 grid through
# main's flags (bound 1, max_steps 16 otherwise); the head's steps (2 epochs
# of the 8 frames), the torso's; the grids its checks hold the bf16 kernels
# (and, at 3 and 16 channels, the float32 ones) to their plain versions on
# VARIANT_POINTS spread points
# the march_variants phase: the two-level march's K cap (24 groups of 4
# steps, the most it takes), the head steps it trains with march_group on,
# the float-grid cull's transmittance for B-bitfield's checks
MARCH_K_CAP, MARCH_GROUP_STEPS, BITFIELD_CULL_T = 96, 8, 1e-4
# the rays of each adversarial call of the two kernels (studies/march.py)
MARCH_ADVERSARIAL_RAYS = 65536
# the capacity phase: the head stage at the port's defaults but an upkeep
# every CAP_UPKEEP steps, CAP_EPOCHS epochs of the 8 frames, so that the
# upkeeps at steps 4, 12, 20 and 28 adapt the capacities (those at an
# epoch's first step do not, as in JAX's trainer); the fenced steps and
# frames of each lattice, twice in turns
CAP_UPKEEP, CAP_EPOCHS, CAP_TIMED = 4, 4, 8
BF16_VARIANT_FLAGS = ["--grid_levels", "8", "--grid_ch", "4"]
BF16_VARIANT_STEPS, BF16_VARIANT_TORSO_STEPS = 16, 8
# the lifted phase: the grids past RAD-NeRF's (D outside {2, 3}, more than
# 32 levels or 16 channels), which the kernels' general path runs. Two CLI
# runs at full width on the written directory, each with every grid of its
# flags on the general path: float32 with a 4-D ambient grid and 33 levels
# of 17 channels in every grid, -O with a 1-D ambient grid and 40 levels of
# 32; LIFTED_STEPS head steps (one epoch of the 8 frames) and as many torso
# steps each. Then LIFTED_POINTS spread points a grid of LIFTED_GRIDS
# (16 levels of 2 channels, desired resolution 2048, unless named; the
# 1-D hash grid at 2^10 rows, so that its finest levels hash)
LIFTED_RUNS = {
    "f32": ["--exp_eye", "--amb_dim", "4", "--grid_levels", "33", "--grid_ch", "17"],
    "bf16": ["-O", "--exp_eye", "--amb_dim", "1", "--grid_levels", "40", "--grid_ch", "32"],
}
LIFTED_STEPS, LIFTED_TORSO_STEPS, LIFTED_POINTS = 8, 8, 1 << 20
LIFTED_GRIDS = {
    "hash_d1": dict(input_dim=1, gridtype="hash", log2_hashmap_size=10),
    "hash_d4": dict(input_dim=4, gridtype="hash"),
    "hash_d7": dict(input_dim=7, gridtype="hash"),
    "tiled_d1": dict(input_dim=1),
    "tiled_d4": dict(input_dim=4),
    "tiled_d7": dict(input_dim=7),
    "tiled_d8": dict(input_dim=8, num_levels=4, level_dim=1),
    "l33": dict(input_dim=3, num_levels=33),
    "l64": dict(input_dim=3, num_levels=64),
    "c17": dict(input_dim=3, level_dim=17),
    "c32": dict(input_dim=3, level_dim=32),
    "c64": dict(input_dim=3, level_dim=64),
    "hash_c32": dict(input_dim=3, level_dim=32, gridtype="hash"),
}
# the plain backward's points a chunk on the spread points (autograd through
# the plain encode keeps every corner's rows: 8 GB at 64 channels a chunk)
LIFTED_PLAIN_CHUNK = 1 << 18
BF16_VARIANT_GRIDS = {  # name -> GridSpec.create arguments (16 levels, desired 2048)
    "c1": dict(input_dim=3, level_dim=1),
    "c8": dict(input_dim=3, level_dim=8),
    "c3": dict(input_dim=3, level_dim=3),
    "c16": dict(input_dim=2, level_dim=16),
    "smoothstep": dict(input_dim=2, interpolation="smoothstep"),
    "align_corners": dict(input_dim=3, align_corners=True),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _warm_up(fn):
    """fn() fenced call by call for at least 50 ms (one call at least):
    after an idle stretch the card's clocks need a few ms of load to rise,
    and 20 launches of a 0.05 ms kernel are not that long. Returns the mean
    ms of a fenced call."""
    torch.cuda.synchronize()
    t0, calls = time.perf_counter(), 0
    while True:
        fn()
        torch.cuda.synchronize()
        calls += 1
        if time.perf_counter() - t0 >= 0.05:
            return (time.perf_counter() - t0) / calls * 1e3


def _events_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over ``reps`` back-to-back calls on the
    current stream, after the warm-up. The events bracket the calls as the
    host enqueues them, so where a wrapper's Python takes longer than its
    kernel this reads the host; ``device_ms`` reads the card."""
    _warm_up(fn)
    return _events_ms(fn, reps)


def device_ms(fn, reps):
    """``cuda_ms`` with the timed calls queued behind a sleep kernel that
    lasts about twice the host's time to enqueue them (at most 100 ms), so
    the card runs them back to back and the events time the card alone."""
    host_ms = _warm_up(fn)  # a call's host time is at most its fenced time
    # the card's clock is at most ~2 GHz, so 2e6 cycles last at least 1 ms
    torch.cuda._sleep(int(min(2.0 * reps * host_ms, 100.0) * 2e6))
    return _events_ms(fn, reps)


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_profile(fn, reps):
    """torch.profiler over fn(0) .. fn(reps - 1): (profiler, the device-side
    events only, largest first). An operator's own entry repeats the device
    time of the kernels it launched, so only kernels and copies are kept."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    # a user-annotated range (``Optimizer.step#Adam.step``) also carries the
    # device time of the kernels inside it: left out, as the operators are
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    events.sort(key=lambda e: -e.self_device_time_total)
    return prof, events


def ms_by_class(events, reps):
    """Device ms per rep by kind of kernel: cuDNN convolutions, cuBLAS
    GEMMs, `torch.cat` copies, everything else."""
    out = {"conv": 0.0, "gemm": 0.0, "cat": 0.0, "other": 0.0}
    for e in events:
        kind = ("conv" if "fprop" in e.key else "gemm" if "gemm" in e.key
                else "cat" if "CatArrayBatchedCopy" in e.key else "other")
        out[kind] += e.self_device_time_total / reps / 1e3
    return out


def psnr(a, b):
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def row_counts(x, spec, bound):
    """(contributions each table row takes from the in-bounds points, one
    per (point, level, corner); the number of in-bounds points)."""
    from radnerf_tpu_torch.ops.grid_encode import _corner_index

    D, L = spec.input_dim, spec.num_levels
    x01 = (x + bound) / (2.0 * bound)
    inb = ((x01 >= 0) & (x01 <= 1)).all(dim=-1)
    x01 = x01[inb]
    counts = torch.zeros(spec.n_embeddings, dtype=torch.int64, device=x.device)
    for level in range(L):
        pg = torch.floor(x01 * spec.level_scale(level) + spec.shift).long()
        for corner in range(1 << D):
            bits = torch.tensor([(corner >> d) & 1 for d in range(D)], device=x.device)
            rows = _corner_index(spec, level, pg + bits) + spec.offsets[level]
            counts += torch.bincount(rows, minlength=spec.n_embeddings)
    return counts, int(inb.sum())


def _weight_tree_flops(D):
    """Multiplies that form all 2^D corner weights of a cell as a tree over
    the dims (dim d doubles the 2^d partial products: 4 + 8 + ... + 2^D),
    about 2 a corner at any D."""
    return (1 << (D + 1)) - 4


def grid_work(x, spec, bound, elem=4, counts=None):
    """Bytes and flops one grid encode needs for these points: the points,
    the output, and each table row the in-bounds points touch, read once
    (rows of C values of ``elem`` bytes, 2 for the bf16 policy; a hashed
    level's rows are those its hash reaches; at any D); per in-bounds
    (point, level) 3D flops for the position, D for the 1 - f terms (5D more
    for smoothstep's weights), the corner weights as a tree
    (``_weight_tree_flops``) and 2C per corner accumulation. ``counts``:
    ``row_counts``' result, where the caller has it."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    counts, n_in = counts or row_counts(x, spec, bound)
    n_rows = int((counts > 0).sum())
    n_bytes = x.numel() * 4 + x.shape[0] * L * C * elem + n_rows * C * elem
    smooth = 5 * D if spec.interpolation == "smoothstep" else 0
    n_flops = n_in * L * (4 * D + smooth + _weight_tree_flops(D) + (1 << D) * 2 * C)
    return n_bytes, n_flops


def triplane_work(x, spec, bound):
    """Bytes and flops one A-tri call (ER-NeRF's tri-plane encode) needs for
    points x [N, 3]: the points read once, and each plane's ``grid_work`` of
    its projection but for the projection's own reads (the features it
    writes, each distinct row its in-box points touch, its operations).
    ``portbench/reference/work_triplane.py`` counts the same from the plain
    reference's hash (tests/test_torch_triplane.py holds the two equal)."""
    from radnerf_tpu_torch.ops.triplane_encode import PLANES

    n_bytes, n_flops = x.numel() * 4, 0
    for dims in PLANES:
        x2 = x[:, list(dims)]
        b, f = grid_work(x2, spec, bound)
        n_bytes += b - x2.numel() * 4
        n_flops += f
    return n_bytes, n_flops


def grid_backward_work(x, spec, bound, need_x, elem=4, counts=None):
    """Bytes and flops the grid-encode backward needs: the points and
    grad_out read once, each touched row of the (float32) table gradient
    written once (and, for the x gradient, each touched table row read once
    and grad_x written); grad_out and table values of ``elem`` bytes (2 for
    the bf16 policy); per in-bounds (point, level) 3D flops for the
    position, D for the 1 - f terms, the corner weights as a tree
    (``_weight_tree_flops``) and C a corner for the weighted gradient; with
    the x gradient 2C a corner for the dot with the row, the weights'
    derivatives as the reverse of that tree (its multiplies again, and one
    multiply-add a corner for the dims' differences) and 2D to scale the
    position gradient (smoothstep: 5D more for the weights and 4D for their
    slopes). ``counts`` as grid_work's."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    counts, n_in = counts or row_counts(x, spec, bound)
    n_rows = int((counts > 0).sum())
    n_bytes = x.numel() * 4 + x.shape[0] * L * C * elem + n_rows * C * 4
    tree = _weight_tree_flops(D)
    per_point = 4 * D + tree
    per_corner = C
    smooth = 5 * D if spec.interpolation == "smoothstep" else 0
    if need_x:
        n_bytes += n_rows * C * elem + x.numel() * 4
        per_point += tree + 2 * D
        per_corner += 2 * C + 2
        smooth += 4 * D if smooth else 0
    n_flops = n_in * L * (per_point + smooth + (1 << D) * per_corner)
    return n_bytes, n_flops


def march_work(rays_o, rays_d, nears, fars, window, mcfg, noises=None, bits=False):
    """Bytes and flops the march needs: the ray geometry, window and noises,
    the distinct sigma bytes its steps look up (with ``bits``, the distinct
    bitfield bytes: a cell's bit is in byte cell >> 3), the [N, S] outputs;
    ~20 flops per step walked (position, clamp, cell), ~6 more on the
    general orbit (its step) and ~12 more at cascade > 1 (the level). The
    walk is the kernel's: on the affine orbit from the window's first step
    of the orbit from ``nears + dt * noises``, on the general orbit every
    step from ``nears + clamp(nears * dt_gamma, dt_min, dt_max) * noises``,
    until the window's end or K steps; a cell is the plain version's (the
    cascade's level, ``floor(0.5 * (p / mip_bound + 1) * H)``)."""
    from radnerf_tpu_torch.ops.marching import _cells, _clamp_dt

    N, S, K = rays_o.shape[0], mcfg.n_sample_slots, mcfg.n_march_iters
    dt = float(np.float32(mcfg.dt_min))
    t_lo, t_hi = window
    t_end = torch.minimum(fars, t_hi)
    if mcfg.affine:
        t0 = nears if noises is None else nears + dt * noises
        k0 = torch.clamp(torch.floor((t_lo - t0) / torch.full_like(t0, dt)), min=0.0)
    else:
        t0 = nears if noises is None else nears + _clamp_dt(nears, mcfg) * noises
    cells, steps, t = [], 0, t0
    for k in range(K):
        if mcfg.affine:
            t, step = t0 + (k0 + k) * dt, torch.full_like(t0, dt)
        else:  # the recurrence
            if k:
                t = t + step
            step = _clamp_dt(t, mcfg)
        walk = t < t_end
        if not bool(walk.any()):
            break
        steps += int(walk.sum())
        p = torch.clamp(rays_o[walk] + t[walk, None] * rays_d[walk], -mcfg.bound, mcfg.bound)
        c = _cells(p, step[walk], mcfg)
        cells.append(c >> 3 if bits else c)
    n_cells = int(torch.unique(torch.cat(cells)).numel()) if cells else 0
    n_in = 24 + 16 + (4 if noises is not None else 0)
    n_bytes = N * n_in + n_cells + N * S * (4 + 4 + 1 + 12) + N * 4
    per_step = 20 + (0 if mcfg.affine else 6) + (12 if mcfg.cascade > 1 else 0)
    return n_bytes, per_step * steps


def grid_cull_work(out, mcfg):
    """Bytes and flops the float-grid cull adds on the march's selected
    samples ``out`` (the bitfield march's result without the cull): the
    distinct float32 grid cells they read, ~26 flops a sample (its cell,
    the clamp, scale and product, the running sum and the test)."""
    from radnerf_tpu_torch.ops.marching import _cells

    valid = out["valid"]
    cells = _cells(out["xyz"][valid], out["dt"][valid], mcfg)
    return 4 * int(torch.unique(cells).numel()), 26 * int(valid.sum())


def march_grouped_work(args, group_slots, cull_T, noises=None):
    """Bytes and flops the two-level march needs on ``args`` (rays_o,
    rays_d, nears, fars, sigma bytes, coarse bytes, MarchConfig, window):
    the ray geometry, window and noises, the distinct coarse bytes its
    walked groups look up and the distinct sigma bytes its fine steps look
    up (the twin's plan: the groups from the window's first step while they
    start inside it, the fine steps of the first ``group_slots`` kept groups
    before K and the window's end), the [N, S] outputs and two counts a
    ray; ~20 flops a lookup (position, clamp, cell), ~6 more each with the
    cull."""
    from radnerf_tpu_torch.ops.marching import _grouped_fine, _grouped_plan

    o, d, nears, fars, sb, cb, cfg, window = args
    plan = _grouped_plan(o, d, nears, fars, cb, cfg, window, group_slots, cull_T, noises)
    fine = _grouped_fine(o, d, sb, cfg, plan)
    N, S = o.shape[0], cfg.n_sample_slots
    lookups = plan["cells_c"].numel() + int(fine["looked"].sum())
    n_cells = int(torch.unique(plan["cells_c"]).numel()) + \
        int(torch.unique(fine["cells"][fine["looked"]]).numel())
    n_in = 24 + 16 + (4 if noises is not None else 0)
    n_bytes = N * n_in + n_cells + N * S * (4 + 4 + 1 + 12) + N * 8
    return n_bytes, (20 + (6 if cull_T > 0.0 else 0)) * lookups


def composite_steps(sig, dts, valid, T_thresh):
    """(steps examined, [N, S] mask of the valid steps processed) up to each
    ray's early stop."""
    N, S = sig.shape
    T = torch.ones(N, device=sig.device)
    alive = torch.ones(N, dtype=torch.bool, device=sig.device)
    examined, processed = 0, torch.zeros_like(valid)
    for s in range(S):
        examined += int(alive.sum())
        v = alive & valid[:, s]
        processed[:, s] = v
        T = torch.where(v, T * torch.exp(-sig[:, s] * dts[:, s]), T)
        alive = alive & (T >= T_thresh)
    return examined, processed


def composite_work(sig, dts, valid, T_thresh):
    """Bytes and flops compositing needs: the valid byte of each step up to
    the early stop, 28 B (sigma, dt, t, rgb, ambient) and ~15 flops for each
    valid step it processes, 24 B out per ray."""
    examined, processed = composite_steps(sig, dts, valid, T_thresh)
    n = int(processed.sum())
    return examined + n * 28 + sig.shape[0] * 24, n * 15


def composite_layout_floor(sig, dts, valid, T_thresh):
    """Bytes the [N, S] layout makes any compositor move, which the bound
    above does not count: every valid row whole, each 32-byte sector that
    holds a processed valid step's sigma, dt, t or ambient (8 slots a
    sector) or part of its rgb triple, and 24 B out per ray."""
    N, S = sig.shape
    idx = composite_steps(sig, dts, valid, T_thresh)[1].reshape(-1).nonzero().squeeze(1)
    scalar_sectors = int(torch.unique(idx // 8).numel())
    rgb_sectors = int(torch.unique(torch.cat([(3 * idx) // 8, (3 * idx + 2) // 8])).numel())
    return N * S + 32 * (4 * scalar_sectors + rgb_sectors) + N * 24


def composite_backward_work(sig, dts, valid, T_thresh):
    """Bytes and flops the composite backward needs: the valid byte of each
    step up to the early stop and 24 B (sigma, dt, t, rgb) for each valid
    step it processes, 44 B per ray (the four upstream gradients, the saved
    image, depth and weights sum), and the [N, S] gradients of sigma, rgb
    and ambient written once (20 B a slot); ~40 flops per processed step."""
    N, S = sig.shape
    examined, processed = composite_steps(sig, dts, valid, T_thresh)
    n = int(processed.sum())
    return examined + n * 24 + N * 44 + N * S * 20, n * 40


def rel_err(got, want):
    """max|got - want| / max|want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def render_targets(scene, rng, n_frames):
    """``n_frames`` frames of the bench camera rendered by the port's frame
    path, each with its own audio window: (the audio features [n, 44, 16]
    drawn from ``rng``, then per frame the image [H*W, 3], the torso layer
    over the background [H*W, 3] and the torso's alpha [H*W, 1], numpy)."""
    from radnerf_tpu_torch.data import get_audio_features
    from radnerf_tpu_torch.models import render_rays

    net, rc, state, batch = scene
    auds = rng.normal(size=(n_frames, 44, 16)).astype(np.float32)
    images, plates, alphas = [], [], []
    for i in range(n_frames):
        aud = torch.from_numpy(get_audio_features(auds, 2, i)).to(batch["rays_o"].device)
        res, _ = render_rays(net, rc, state, batch["rays_o"], batch["rays_d"], aud,
                             batch["bg_coords"], batch["poses"], batch["eye"], batch["index"],
                             batch["bg_color"])
        images.append(res["image"].cpu().numpy())
        plates.append(res["torso_color"].cpu().numpy())
        alphas.append(res["torso_alpha"].cpu().numpy())
    return auds, images, plates, alphas


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from radnerf_tpu_torch.models import render_rays
    from radnerf_tpu_torch.models.renderer import field_on_lattice, march_window
    from radnerf_tpu_torch.ops import (
        _kernels, composite_rays, composite_rays_plain, grid_encode, grid_encode_plain,
        march_rays, march_rays_plain, near_far_from_aabb,
    )
    from radnerf_tpu_torch.scene import build_scene

    start = time.perf_counter()
    report = {}
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")

    # ---- 1. device
    smi = nvidia_smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the bf16 policy's GEMMs sum in float32, as JAX's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    report["device"] = {"nvidia_smi": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda,
                        "name": torch.cuda.get_device_name(0)}
    emit({"phase": "device", **report["device"]})

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _kernels.build_all()
    report["build"] = {
        "seconds": time.perf_counter() - t0,
        # each kernel's registers and spills, under the name of its function
        "ptxas": {k: [l.strip() for l in v.splitlines()
                      if "registers" in l or "spill" in l or "Function properties" in l]
                  for k, v in logs.items()},
    }
    emit({"phase": "build", **report["build"]})

    # ---- 3. the main path: one frame, launch counts from 0
    net, rc, state, b, auds = build_scene(512, 512, device=dev)

    def frame(aud):
        return render_rays(net, rc, state, b["rays_o"], b["rays_d"], aud, b["bg_coords"],
                           b["poses"], b["eye"], b["index"], b["bg_color"])[0]

    torch.cuda.synchronize()
    _kernels.reset_launches()
    res = frame(auds[0])
    torch.cuda.synchronize()
    launches = _kernels.launches()
    telemetry = {k: int(v) for k, v in res.items() if k.startswith("n_")}
    report["main_path"] = {"launches": launches, "telemetry": telemetry}
    emit({"phase": "main_path", **report["main_path"]})
    for name in FRAME_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    if launches["grid_encode_backward"] or launches["composite_rays_backward"]:
        raise RuntimeError("the inference frame launched a backward kernel")

    # ---- 4. kernels against their twins at the main path's shapes
    mcfg = rc.march_config()
    o, d = b["rays_o"], b["rays_d"]
    nears, fars = near_far_from_aabb(o, d, o.new_tensor(rc.aabb), rc.min_near)
    window = march_window(state, o, d, nears, fars)
    m_args = (o, d, nears, fars, state.sigma_bytes, mcfg, window, rc.cull_T)
    mk, mp = march_rays(*m_args), march_rays_plain(*m_args)
    torch.cuda.synchronize()
    # rays whose sample set differs: another valid row or another count
    n_ray_diff = int(((mk["valid"] != mp["valid"]).any(dim=1)
                      | (mk["count"] != mp["count"])).sum())
    both = (mk["valid"] & mp["valid"])
    march_err = max(float((mk[k] - mp[k]).abs()[both].max()) for k in ("t", "dt"))
    march_err = max(march_err, float((mk["xyz"] - mp["xyz"]).abs()[both].max()))
    # t, dt and xyz are exactly 0 in every unused slot, on both sides
    nonzero_unused = sum(int((m[k] != 0).reshape(*m["valid"].shape, -1)[~m["valid"]].sum())
                         for m in (mk, mp) for k in ("t", "dt", "xyz"))
    checks = {"march_rays": {"max_abs_err": march_err, "tol": TOL_MARCH,
                             "rays_differing": n_ray_diff,
                             "nonzero_unused_slot_values": nonzero_unused}}

    code = net.individual_codes[0]
    with torch.no_grad():
        enc_a = net.encode_audio(auds[0])
        xs = mk["xyz"][mk["valid"]]
        _, _, ambient = net.spatial_and_ambient(xs, enc_a)
        _, _, dx = net.forward_torso(b["bg_coords"], b["poses"], net.individual_codes_torso[0])
        xp = torch.clamp(b["bg_coords"] * net.cfg.torso_shrink + dx, -1.0, 1.0)
    cfg = net.cfg
    grid_calls = {
        "spatial": (xs, net.encoder.detach(), cfg.grid_spec, cfg.bound),
        "ambient": (ambient, net.encoder_ambient.detach(), cfg.ambient_spec, 1.0),
        "torso": (xp, net.torso_encoder.detach(), cfg.torso_spec, 1.0),
    }
    grid_err = {}
    for name, args in grid_calls.items():
        gk, gp = grid_encode(*args), grid_encode_plain(*args)
        torch.cuda.synchronize()
        grid_err[name] = {"n_points": int(args[0].shape[0]),
                          "max_abs_err": float((gk - gp).abs().max())}
    checks["grid_encode"] = {"max_abs_err": max(v["max_abs_err"] for v in grid_err.values()),
                             "tol": TOL_GRID, "calls": grid_err}

    with torch.no_grad():
        sig, col, amb = field_on_lattice(net, mk, d, enc_a, code, b["eye"])
    c_args = (sig, col, mk["dt"], mk["t"], mk["valid"])
    c_kw = dict(ambient=amb.abs().sum(dim=-1), T_thresh=rc.T_thresh)
    ck, cp = composite_rays(*c_args, **c_kw), composite_rays_plain(*c_args, **c_kw)
    torch.cuda.synchronize()
    checks["composite_rays"] = {"max_abs_err": max(float((ck[k] - cp[k]).abs().max())
                                                   for k in ck),
                                "tol": TOL_COMPOSITE}
    report["kernel_checks"] = checks
    emit({"phase": "kernel_checks", **checks})
    for name, c in checks.items():
        if not c["max_abs_err"] <= c["tol"]:
            raise RuntimeError(f"{name}: max|kernel - twin| {c['max_abs_err']} > {c['tol']}")
    if n_ray_diff != 0:
        raise RuntimeError(f"march_rays: {n_ray_diff} rays differ from the twin "
                           "in valid slots or count")
    if nonzero_unused != 0:
        raise RuntimeError(f"march_rays: {nonzero_unused} nonzero values in unused slots")

    # ---- 5. the frame against the twins' frame on the CPU
    ws_max = float(res["weights_sum"].max())
    t0 = time.perf_counter()
    net_cpu = copy.deepcopy(net).to("cpu")
    res_cpu, _ = render_rays(net_cpu, rc, state.to("cpu"),
                             *(b[k].cpu() for k in ("rays_o", "rays_d")), auds[0].cpu(),
                             *(b[k].cpu() for k in ("bg_coords", "poses", "eye", "index",
                                                    "bg_color")))
    twin_s = time.perf_counter() - t0
    tel_cpu = {k: int(v) for k, v in res_cpu.items() if k.startswith("n_")}
    fr = {
        "psnr_vs_twin_db": psnr(res["image"].cpu(), res_cpu["image"]),
        "psnr_min_db": MIN_FRAME_PSNR_DB,
        "max_abs_err": float((res["image"].cpu() - res_cpu["image"]).abs().max()),
        "weights_sum_max": ws_max,
        "torso_alpha_max": float(res["torso_alpha"].max()),
        "image_mean": float(res["image"].mean()),
        "weights": "scene.random_weights, numpy seed 0: tables U(-4, 4), He-uniform "
                   "MLP weights, default biases, codes N(0, 0.1)",
        "telemetry": telemetry, "telemetry_twin_cpu": tel_cpu,
        "twin_cpu_seconds": twin_s,
    }
    report["frame"] = fr
    emit({"phase": "frame", **fr})
    if not bool(torch.isfinite(res["image"]).all()) or res["image"].shape != (512 * 512, 3):
        raise RuntimeError("the frame is not a finite [512*512, 3] image")
    if not ws_max > 0.05:
        raise RuntimeError(f"the head is invisible: weights_sum.max() = {ws_max}")
    if tel_cpu != telemetry:
        raise RuntimeError(f"telemetry differs from the twins': {telemetry} vs {tel_cpu}")
    if not fr["psnr_vs_twin_db"] >= MIN_FRAME_PSNR_DB:
        raise RuntimeError(f"frame PSNR vs twins {fr['psnr_vs_twin_db']:.2f} dB")

    # ---- 6. timing
    n_frames = 30
    frame(auds[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_frames):
        frame(auds[i % auds.shape[0]])
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / n_frames * 1e3
    report["timing"] = {"frame_ms": frame_ms, "fps": 1e3 / frame_ms, "frames": n_frames,
                        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}

    # where the frame's device time goes: torch.profiler over 3 frames
    prof, events = device_profile(lambda i: frame(auds[i]), 3)
    busy_us = sum(e.self_device_time_total for e in events)
    by_class = ms_by_class(events, 3)
    # the torso pass alone (it runs on every pixel; only the masked ones
    # are kept): its share of the frame's GEMMs and `cat` copies
    code_t = net.individual_codes_torso[0]
    with torch.no_grad():
        _, torso_events = device_profile(
            lambda i: net.forward_torso(b["bg_coords"], b["poses"], code_t), 3)
    torso = ms_by_class(torso_events, 3)
    report["profile"] = {
        # busy share against the unprofiled frame time above: the first
        # profiled frame also pays the profiler's own start-up
        "frames": 3, "device_busy_ms_per_frame": busy_us / 3e3,
        "device_busy_share": busy_us / 3e3 / frame_ms,
        "ms_per_frame_by_class": by_class,
        "torso_pass": {"pixels": int(b["bg_coords"].shape[0]),
                       "device_ms": sum(torso.values()), "ms_by_class": torso,
                       "gemm_share_of_frame": torso["gemm"] / by_class["gemm"],
                       "cat_share_of_frame": torso["cat"] / by_class["cat"]},
        "top": [{"name": e.key[:80], "ms_per_frame": e.self_device_time_total / 3e3,
                 "calls_per_frame": e.count / 3} for e in events[:15]],
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    emit({"phase": "profile", **{k: v for k, v in report["profile"].items() if k != "top"},
          "top5": report["profile"]["top"][:5]})

    kernels = []
    # grid encode: one kernel, three launches a frame; times and work summed
    g = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "calls": {}}
    for name, args in grid_calls.items():
        ms = cuda_ms(lambda: grid_encode(*args), 20)
        dms = device_ms(lambda: grid_encode(*args), 20)
        pms = cuda_ms(lambda: grid_encode_plain(*args), 3)
        nb, nf = grid_work(args[0], args[2], args[3])
        bms, by = bound_ms(nb, nf)
        g["calls"][name] = {"ms": ms, "device_ms": dms, "plain_ms": pms, "bound_ms": bms,
                            "bound_by": by, "bytes": nb, "flops": nf,
                            "n_points": int(args[0].shape[0])}
        g["ms"] += ms
        g["device_ms"] += dms
        g["plain_ms"] += pms
        g["bytes"] += nb
        g["flops"] += nf
    bms, by = bound_ms(g["bytes"], g["flops"])
    kernels.append({"name": "grid_encode", "ms": g["ms"], "device_ms": g["device_ms"],
                    "plain_ms": g["plain_ms"], "bound_ms": bms, "bound_by": by,
                    "max_abs_err": checks["grid_encode"]["max_abs_err"],
                    "calls": g["calls"]})

    nb, nf = march_work(o, d, nears, fars, window, mcfg)
    bms, by = bound_ms(nb, nf)
    kernels.append({"name": "march_rays", "ms": cuda_ms(lambda: march_rays(*m_args), 20),
                    "device_ms": device_ms(lambda: march_rays(*m_args), 20),
                    "plain_ms": cuda_ms(lambda: march_rays_plain(*m_args), 3),
                    "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
                    "max_abs_err": march_err})

    nb, nf = composite_work(c_args[0], c_args[2], c_args[4], rc.T_thresh)
    bms, by = bound_ms(nb, nf)
    floor_b = composite_layout_floor(c_args[0], c_args[2], c_args[4], rc.T_thresh)
    kernels.append({"name": "composite_rays",
                    "ms": cuda_ms(lambda: composite_rays(*c_args, **c_kw), 20),
                    "device_ms": device_ms(lambda: composite_rays(*c_args, **c_kw), 20),
                    "plain_ms": cuda_ms(lambda: composite_rays_plain(*c_args, **c_kw), 3),
                    "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
                    "layout_floor_ms": bound_ms(floor_b, 0)[0], "layout_floor_bytes": floor_b,
                    "max_abs_err": checks["composite_rays"]["max_abs_err"]})
    for k in kernels:
        # no single PyTorch call computes any of the three functions
        k.update(route="cuda", source=f"radnerf_tpu_torch/csrc/{k['name']}.cu",
                 replaces=REPLACES[k["name"]], launches=launches[k["name"]],
                 library_ms=None)
    report["timing"]["kernels"] = list(kernels)  # the frame's three only
    emit({"phase": "timing", "frame_ms": frame_ms, "fps": report["timing"]["fps"],
          "kernel_ms": {k["name"]: k["ms"] for k in kernels},
          "kernel_device_ms": {k["name"]: k["device_ms"] for k in kernels},
          "grid_encode_calls": {n: {k: v for k, v in c.items() if "ms" in k}
                                for n, c in g["calls"].items()}})

    kernels.append(ernerf_phase(report))
    torch.cuda.empty_cache()

    from radnerf_tpu_torch.config import Options

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_dataset(root, (net, rc, state, b))
        write_s = time.perf_counter() - t0
        train_kernels, head_trainer, ds = train_phases(
            report, out_dir, Options(path=root, exp_eye=True, preload=2))
        kernels += train_kernels
        kernels.append(gather_phase(report, dev))
        with tempfile.TemporaryDirectory() as workspace:
            head_ckpt, torso_bwd = torso_phases(report, out_dir, head_trainer, root, workspace)
            checkpoint_phase(report, head_trainer, head_ckpt, (net, rc, state, b), auds[0])
        next(k for k in kernels
             if k["name"] == "grid_encode_backward")["calls"]["torso"] = torso_bwd
        dataset_phase(report, head_trainer, ds, root, write_s)
        del head_trainer, ds
        torch.cuda.empty_cache()
        entry_trainer = entry_phase(report, root)
        entry_timing_phase(report, out_dir, entry_trainer, root)
        del entry_trainer
        torch.cuda.empty_cache()
        data_parallel_phase(report, root)
        t0 = time.perf_counter()
        step_calls, eval_calls, variant_launches, variant_state = variants_phase(
            report, out_dir, root)
        kernels += variant_kernel_checks(report, step_calls, eval_calls, variant_launches)
        variants_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        variant_eval = next((a, kw) for name, a, kw in eval_calls if name == "march_rays")
        kernels += march_variants_phase(report, root, variant_eval, variant_state)
        march_variants_s = time.perf_counter() - t0
        del step_calls, eval_calls, variant_eval, variant_state
        torch.cuda.empty_cache()
        capacity_phase(report, out_dir, root, smi)
        torch.cuda.empty_cache()
        frame_calls = bf16_frame_phase(report, out_dir, (net, rc, state, b), auds)
        step_calls = bf16_train_phase(report, out_dir, root)
        bf16_entries = bf16_kernel_checks(report, frame_calls, step_calls)
        del frame_calls, step_calls
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        step_calls, bf16_variant_launches = bf16_variants_phase(report, out_dir, root)
        kernels += bf16_variant_kernel_checks(report, step_calls, bf16_variant_launches)
        bf16_variants_s = time.perf_counter() - t0
        del step_calls
        torch.cuda.empty_cache()
        kernels += lifted_phase(report, root)
        torch.cuda.empty_cache()
        recipe_launches = recipe_phase(report, root)
        for k in bf16_entries:
            k["launches"] = recipe_launches[k["name"]]
        kernels += bf16_entries
        marks = [time.perf_counter()]
        head_ckpt = camera_phase(report, out_dir, root)
        marks.append(time.perf_counter())
        live_phase(report, out_dir, root)
        marks.append(time.perf_counter())
        mesh_phase(report, out_dir, root, head_ckpt)
        marks.append(time.perf_counter())
        kernels.append(preprocess_phase(report, out_dir, dev))
        marks.append(time.perf_counter())
        report["phase_seconds"] = {"since_start": marks[0] - start,
                                   "data_parallel": report["data_parallel"]["seconds"],
                                   "variants": variants_s,
                                   "march_variants": march_variants_s,
                                   "capacity": report["capacity"]["seconds"],
                                   "bf16_variants": bf16_variants_s,
                                   "lifted": report["lifted"]["seconds"],
                                   **{name: b - a for name, a, b in
                                      zip(("camera", "live", "mesh", "preprocess"), marks,
                                          marks[1:])}}
        emit({"phase": "phase_seconds", **report["phase_seconds"]})

    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = [{k: kern[k] for k in keys} for kern in kernels]
    for entry, kern in zip(line, kernels):  # whose launches: the path's, or its check's
        if "launches_in" in kern:
            entry["launches_in"] = kern["launches_in"]
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def train_phases(report, out_dir, opt):
    """Phases 7, 8 and 10 (training) on the card: ``opt`` the trainer's
    options, whose ``path`` is the directory ``write_dataset`` wrote and
    whose ``preload`` says where its frames are kept. Returns (the
    kernels-line entries of A' and C', the trainer, the dataset)."""
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.models import (
        RendererState, field_on_lattice, mark_untrained_grid, update_density_grid,
    )
    from radnerf_tpu_torch.models.renderer import march_window
    from radnerf_tpu_torch.ops import (
        _kernels, composite_rays, composite_rays_backward, composite_rays_backward_plain,
        composite_rays_plain, grid_encode, grid_encode_backward, grid_encode_backward_plain,
        grid_encode_plain, march_rays, march_rays_plain, near_far_from_aabb,
    )
    from radnerf_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    ds = TalkingHeadDataset(opt, split="train", device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    dev = ds.device
    tr = Trainer(opt, device=dev)
    rc, net = tr.render_cfg, tr.net

    # the fixed batch, and the model at step 0 on a grid upkept as the
    # trainer's first upkeep does (its own jitter), for the loss check
    fixed = tr.next_batch(ds, 0)
    fixed_noises = torch.rand(opt.num_rays, generator=torch.Generator(dev).manual_seed(123),
                              device=dev)
    with torch.no_grad():
        aud0 = ds.audio_window(0)
        probe = update_density_grid(
            net, rc, mark_untrained_grid(rc, RendererState.create(rc, device=dev), ds.poses,
                                         ds.intrinsics),
            net.encode_audio(aud0), fixed["eye"], generator=torch.Generator(dev).manual_seed(7))
        loss_0 = float(tr.loss(fixed, fixed_noises, 0, state=probe)[0])

    # ---- 7. the training run, launch counts from 0
    epochs = TRAIN_STEPS // len(ds)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    tr.train(ds, max_epochs=epochs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _kernels.launches()
    with torch.no_grad():
        loss_end = float(tr.loss(fixed, fixed_noises, 0)[0])
    losses = tr.stats["step_loss"]
    telemetry = {k: int(v) for k, v in tr.telemetry.items()}
    tp = {"steps": tr.global_step, "launches": launches, "seconds": run_s,
          "dataset_seconds": data_s, "loss_first": losses[0], "loss_last": losses[-1],
          "loss_min": min(losses), "loss_max": max(losses),
          "fixed_batch_loss_step0": loss_0, "fixed_batch_loss_end": loss_end,
          "mean_density_after_upkeeps": tr.stats["mean_density"],
          "telemetry_last_step": telemetry,
          "model": "NetworkConfig(torso=False, exp_eye=True), float32, Options defaults, "
                   "seeded init (torch.Generator seed 0)",
          "data": f"write_dataset's {len(ds)} frames, --preload {opt.preload}"}
    report["train"] = {**tp, "step_losses": losses}
    emit({"phase": "train", **tp})
    for name in TRAIN_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the training path")
    if tr.global_step != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"training: {tr.global_step} steps, losses {losses}")
    if not tr.stats["mean_density"][0] > 0:
        raise RuntimeError("the density grid is empty after the first upkeep")
    if not telemetry["n_samples_needed"] > 0:
        raise RuntimeError("the last train step marched no sample")
    if not loss_end < loss_0:
        raise RuntimeError(f"fixed-batch loss did not fall: {loss_0} -> {loss_end}")

    # ---- 8. backward kernels and the perturbed march at the step's shapes
    batch = tr.next_batch(ds, 1)
    noises = tr.draw_noises(opt.num_rays)
    mcfg = rc.march_config()
    o, d = batch["rays_o"], batch["rays_d"]
    nears, fars = near_far_from_aabb(o, d, o.new_tensor(rc.aabb), rc.min_near)
    m_args = (o, d, nears, fars, tr.state.sigma_bytes, mcfg,
              march_window(tr.state, o, d, nears, fars), rc.cull_T)
    mk = march_rays(*m_args, noises=noises)
    mp = march_rays_plain(*m_args, noises=noises)
    n_ray_diff = int(((mk["valid"] != mp["valid"]).any(dim=1)
                      | (mk["count"] != mp["count"])).sum())
    both = mk["valid"] & mp["valid"]
    march_err = max(float((mk[k] - mp[k]).abs()[both].max()) for k in ("t", "dt", "xyz"))
    nonzero_unused = sum(int((m[k] != 0).reshape(*m["valid"].shape, -1)[~m["valid"]].sum())
                         for m in (mk, mp) for k in ("t", "dt", "xyz"))

    cfg = net.cfg
    gen = torch.Generator(dev).manual_seed(5)
    with torch.no_grad():
        enc_a = net.encode_audio(batch["auds"])
        xs = mk["xyz"][mk["valid"]]
        _, _, ambient = net.spatial_and_ambient(xs, enc_a)
        sig, col, amb = field_on_lattice(net, mk, d, enc_a, net.individual_codes[1],
                                         batch["eye"])
    n_s = xs.shape[0]
    bwd_calls = {
        # the spatial encode's points come from the march: no x gradient
        "spatial": (xs, net.encoder.detach(), cfg.grid_spec, cfg.bound, False),
        "ambient": (ambient, net.encoder_ambient.detach(), cfg.ambient_spec, 1.0, True),
    }
    g_outs = {k: torch.randn((n_s, v[2].output_dim), generator=gen, device=dev)
              for k, v in bwd_calls.items()}
    # as many points spread uniformly over each grid's box, the same grad_out:
    # the uncontended regime of a trained field
    gen_u = torch.Generator(dev).manual_seed(6)
    for name, (x, *rest) in list(bwd_calls.items()):
        bound = rest[2]
        u = (torch.rand(x.shape, generator=gen_u, device=dev) * 2.0 - 1.0) * bound
        bwd_calls[f"{name}_spread"] = (u, *rest)
        g_outs[f"{name}_spread"] = g_outs[name]
    a_err = {}
    for name, (x, emb, spec, bound, need_x) in bwd_calls.items():
        gk = grid_encode_backward(x, emb, g_outs[name], spec, bound, need_x=need_x)
        gp = grid_encode_backward_plain(x, emb, g_outs[name], spec, bound, need_x=need_x)
        n_busy = int(row_counts(x, spec, bound)[0].max())
        a_err[name] = {"n_points": n_s, "busiest_row_contributions": n_busy,
                       "table_tol_rel": max(TOL_BACKWARD_REL, 4.0 * math.sqrt(n_busy) * 2**-24),
                       "table_rel_err": rel_err(gk[0], gp[0]),
                       "table_max_abs_err": float((gk[0] - gp[0]).abs().max())}
        if need_x:
            a_err[name].update(x_rel_err=rel_err(gk[1], gp[1]), x_tol_rel=TOL_BACKWARD_REL,
                               x_max_abs_err=float((gk[1] - gp[1]).abs().max()))

    c_args = (sig, col, mk["dt"], mk["t"], mk["valid"], amb.abs().sum(dim=-1))
    outs = composite_rays(*c_args, T_thresh=rc.T_thresh)
    outs_p = composite_rays_plain(*c_args, T_thresh=rc.T_thresh)
    c_fwd_err = max(float((outs[k] - outs_p[k]).abs().max()) for k in outs)
    N = o.shape[0]
    c_grads = {k: torch.randn((N, 3) if k == "image" else (N,), generator=gen, device=dev)
               for k in ("image", "depth", "weights_sum", "ambient_sum")}
    ck = composite_rays_backward(*c_args, c_grads, outs, T_thresh=rc.T_thresh)
    cp = composite_rays_backward_plain(*c_args, c_grads, T_thresh=rc.T_thresh)
    c_err = {name: {"rel_err": rel_err(a, b_), "max_abs_err": float((a - b_).abs().max())}
             for name, a, b_ in zip(("sigmas", "rgbs", "ambient"), ck, cp)}
    torch.cuda.synchronize()
    checks = {
        "march_rays_noises": {"max_abs_err": march_err, "tol": TOL_MARCH,
                              "rays_differing": n_ray_diff,
                              "nonzero_unused_slot_values": nonzero_unused,
                              "n_samples": int(mk["valid"].sum())},
        "grid_encode_backward": {"calls": a_err, "tol_rel": TOL_BACKWARD_REL},
        "composite_rays": {"max_abs_err": c_fwd_err, "tol": TOL_COMPOSITE},
        "composite_rays_backward": {"grads": c_err, "tol_rel": TOL_BACKWARD_REL},
    }
    report["train_kernel_checks"] = checks
    emit({"phase": "train_kernel_checks", **checks})
    if n_ray_diff != 0 or nonzero_unused != 0 or not march_err <= TOL_MARCH:
        raise RuntimeError(f"march_rays with noises differs from its twin: {checks}")
    for name, e in a_err.items():
        if not (e["table_rel_err"] <= e["table_tol_rel"]
                and e.get("x_rel_err", 0.0) <= TOL_BACKWARD_REL):
            raise RuntimeError(f"grid_encode_backward ({name}) differs: {e}")
    if not c_fwd_err <= TOL_COMPOSITE:
        raise RuntimeError(f"composite_rays differs from its twin at the step's shapes: "
                           f"{c_fwd_err}")
    if not max(v["rel_err"] for v in c_err.values()) <= TOL_BACKWARD_REL:
        raise RuntimeError(f"composite_rays_backward differs: {c_err}")

    # ---- 10. training time: the trainer's loop entry, each call fenced
    # (steps that run the upkeep apart), then steps that run none profiled,
    # then the batch preparation alone
    interval = opt.update_extra_interval
    order = ds.epoch_indices()
    step_ms, upkeep_step_ms = [], []
    for n in range(2 * interval - PROFILED_STEPS):
        upkeep = tr.global_step % interval == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step(ds, order[n % len(order)])
        torch.cuda.synchronize()
        (upkeep_step_ms if upkeep else step_ms).append((time.perf_counter() - t0) * 1e3)
    if any((tr.global_step + i) % interval == 0 for i in range(PROFILED_STEPS)):
        raise RuntimeError("a profiled step would run the upkeep")
    prof, events = device_profile(lambda i: tr.step(ds, order[i % len(order)]),
                                  PROFILED_STEPS)
    prep_ms = []
    for n in range(8):
        t0 = time.perf_counter()
        tr.next_batch(ds, order[n % len(order)])
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    busy_ms = sum(e.self_device_time_total for e in events) / PROFILED_STEPS / 1e3
    med = float(np.median(step_ms))
    tt = {"train_step_ms_median": med, "train_step_ms": step_ms,
          "upkeep_step_ms": upkeep_step_ms,
          "upkeep_ms": [u - med for u in upkeep_step_ms],
          "batch_prep_ms_median": float(np.median(prep_ms)),
          "rays": opt.num_rays, "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "profile": {"steps": PROFILED_STEPS, "device_busy_ms_per_step": busy_ms,
                      "device_busy_share": busy_ms / med,
                      "ms_per_step_by_class": ms_by_class(events, PROFILED_STEPS),
                      "top": [{"name": e.key[:80],
                               "ms_per_step": e.self_device_time_total / PROFILED_STEPS / 1e3,
                               "calls_per_step": e.count / PROFILED_STEPS}
                              for e in events[:15]]}}
    with open(os.path.join(out_dir, "chip_smoke_train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))

    kernels = []
    # A': the kernels line sums the step's two calls; the spread points are
    # beside them
    g = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "calls": {}}
    for name, (x, emb, spec, bound, need_x) in bwd_calls.items():
        go = g_outs[name]
        def bwd():
            return grid_encode_backward(x, emb, go, spec, bound, need_x=need_x)
        ms, dms = cuda_ms(bwd, 20), device_ms(bwd, 20)
        nb, nf = grid_backward_work(x, spec, bound, need_x)
        bms, by = bound_ms(nb, nf)
        call = {"ms": ms, "device_ms": dms, "bound_ms": bms, "bound_by": by, "bytes": nb,
                "flops": nf, "n_points": n_s, "x_grad": need_x}
        if not name.endswith("_spread"):
            # one timed call: the plain version takes seconds on these points
            call["plain_ms"] = cuda_ms(lambda: grid_encode_backward_plain(
                x, emb, go, spec, bound, need_x=need_x), 1)
            g["ms"] += ms
            g["device_ms"] += dms
            g["plain_ms"] += call["plain_ms"]
            g["bytes"] += nb
            g["flops"] += nf
        g["calls"][name] = call
    bms, by = bound_ms(g["bytes"], g["flops"])
    kernels.append({"name": "grid_encode_backward", "ms": g["ms"], "device_ms": g["device_ms"],
                    "plain_ms": g["plain_ms"],
                    "bound_ms": bms, "bound_by": by, "calls": g["calls"],
                    "max_abs_err": max(v for e in a_err.values() for k, v in e.items()
                                       if k.endswith("max_abs_err"))})
    nb, nf = composite_backward_work(sig, mk["dt"], mk["valid"], rc.T_thresh)
    bms, by = bound_ms(nb, nf)
    kernels.append({
        "name": "composite_rays_backward",
        "ms": cuda_ms(lambda: composite_rays_backward(*c_args, c_grads, outs,
                                                      T_thresh=rc.T_thresh), 20),
        "device_ms": device_ms(lambda: composite_rays_backward(*c_args, c_grads, outs,
                                                              T_thresh=rc.T_thresh), 20),
        "plain_ms": cuda_ms(lambda: composite_rays_backward_plain(*c_args, c_grads,
                                                                  T_thresh=rc.T_thresh), 3),
        "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
        "max_abs_err": max(v["max_abs_err"] for v in c_err.values())})
    for k in kernels:
        # no single PyTorch call computes either gradient
        k.update(route="cuda", source=f"radnerf_tpu_torch/csrc/{k['name']}.cu",
                 replaces=REPLACES[k["name"]], launches=launches[k["name"]],
                 library_ms=None)
    # kernels B (with noises) and C at the step's calls, on phase 8's inputs
    nb, nf = march_work(o, d, nears, fars, m_args[6], mcfg, noises)
    bms, by = bound_ms(nb, nf)
    b_step = {"n_rays": N, "launches": launches["march_rays"],
              "ms": cuda_ms(lambda: march_rays(*m_args, noises=noises), 20),
              "device_ms": device_ms(lambda: march_rays(*m_args, noises=noises), 20),
              "plain_ms": cuda_ms(lambda: march_rays_plain(*m_args, noises=noises), 3),
              "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
              "max_abs_err": march_err}
    nb, nf = composite_work(sig, mk["dt"], mk["valid"], rc.T_thresh)
    bms, by = bound_ms(nb, nf)
    floor_b = composite_layout_floor(sig, mk["dt"], mk["valid"], rc.T_thresh)
    c_step = {"n_rays": N, "n_valid": int(mk["valid"].sum()),
              "launches": launches["composite_rays"],
              "ms": cuda_ms(lambda: composite_rays(*c_args, T_thresh=rc.T_thresh), 20),
              "device_ms": device_ms(lambda: composite_rays(*c_args, T_thresh=rc.T_thresh), 20),
              "plain_ms": cuda_ms(lambda: composite_rays_plain(*c_args, T_thresh=rc.T_thresh),
                                  3),
              "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
              "layout_floor_ms": bound_ms(floor_b, 0)[0], "layout_floor_bytes": floor_b}
    tt["march_rays_step"], tt["composite_rays_step"] = b_step, c_step
    # kernel A at the step's D = 3 call (the spatial encode of its samples)
    a_args = (xs, net.encoder.detach(), cfg.grid_spec, cfg.bound)
    if not torch.equal(grid_encode(*a_args), grid_encode_plain(*a_args)):
        raise RuntimeError("kernel A differs from its twin on the step's points")
    nb, nf = grid_work(xs, cfg.grid_spec, cfg.bound)
    bms, by = bound_ms(nb, nf)
    a_step = {"n_points": n_s, "ms": cuda_ms(lambda: grid_encode(*a_args), 20),
              "device_ms": device_ms(lambda: grid_encode(*a_args), 20),
              "plain_ms": cuda_ms(lambda: grid_encode_plain(*a_args), 3),
              "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf, "bit_for_bit": True}
    tt["grid_encode_step"] = a_step
    tt["kernels"] = kernels
    report["train_timing"] = tt
    emit({"phase": "train_timing", **{k: v for k, v in tt.items()
                                      if k not in ("profile", "kernels", "train_step_ms")},
          "device_busy_share": tt["profile"]["device_busy_share"],
          "ms_per_step_by_class": tt["profile"]["ms_per_step_by_class"],
          "top5": tt["profile"]["top"][:5],
          "kernel_ms": {k["name"]: k["ms"] for k in kernels},
          "kernel_device_ms": {k["name"]: k["device_ms"] for k in kernels},
          "grid_encode_backward_calls": {
              n: {k: v for k, v in c.items() if "ms" in k} for n, c in g["calls"].items()}})
    return kernels, tr, ds


def torso_phases(report, out_dir, head, root, workspace):
    """Phases 11 and 12 and the torso timing on the head trainer's device:
    ``head`` is phase 7's trainer, ``root`` the dataset's directory,
    ``workspace`` a temporary directory for the head checkpoint. Returns (the
    checkpoint's path, A''s reading at the torso step's call)."""
    import radnerf_tpu_torch.models.network as network_mod
    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.models import update_torso_grid
    from radnerf_tpu_torch.ops import (
        _kernels, grid_encode, grid_encode_backward, grid_encode_backward_plain,
        grid_encode_plain,
    )
    from radnerf_tpu_torch.train import Trainer

    dev = head.device
    # ---- 11. the torso stage from the head run's checkpoint
    head.workspace = workspace
    head.save_checkpoint(full=True)
    head_ckpt = head.stats["checkpoints"][-1]
    saved = {k: v.detach().clone() for k, v in head.net.named_parameters()}
    opt = Options(path=root, torso=True, exp_eye=True, preload=head.opt.preload,
                  num_rays=head.opt.num_rays)
    tr = Trainer(opt, device=dev)
    tr.freeze_loaded_head(head_ckpt)
    rc, net = tr.render_cfg, tr.net
    torso_names = [n for n, _ in net.named_parameters() if n not in saved]
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    ds_t = TalkingHeadDataset(opt, split="train", device=dev)

    # the fixed batch, and the model at step 0 on a torso grid upkept once
    fixed = tr.next_batch(ds_t, 0)
    fixed_noises = torch.rand(opt.num_rays, generator=torch.Generator(dev).manual_seed(123),
                              device=dev)
    with torch.no_grad():
        probe = update_torso_grid(net, rc, tr.state, fixed["poses"],
                                  net.individual_codes_torso[0],
                                  generator=torch.Generator(dev).manual_seed(7))
        loss_0 = float(tr.loss(fixed, fixed_noises, 0, state=probe)[0])
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    tr.train(ds_t, max_epochs=TORSO_STEPS // len(ds_t))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _kernels.launches()
    with torch.no_grad():
        loss_end = float(tr.loss(fixed, fixed_noises, 0)[0])
    losses = tr.stats["step_loss"]
    telemetry = {k: int(v) for k, v in tr.telemetry.items()}
    head_unchanged = all(torch.equal(p, saved[n]) and not p.requires_grad
                         for n, p in net.named_parameters() if n in saved)
    torso_moved = {n: not torch.equal(p, before[n]) for n, p in net.named_parameters()
                   if n in torso_names}
    tp = {"steps": tr.global_step, "launches": launches, "seconds": run_s,
          "loss_first": losses[0], "loss_last": losses[-1],
          "fixed_batch_loss_step0": loss_0, "fixed_batch_loss_end": loss_end,
          "mean_density_torso_after_upkeeps": tr.stats["mean_density_torso"],
          "telemetry_last_step": telemetry, "head_parameters_unchanged": head_unchanged,
          "torso_parameters_moved": torso_moved,
          "model": "NetworkConfig(torso=True, exp_eye=True), float32, Options(torso=True) "
                   "defaults, torso seeded init (torch.Generator seed 0), head from phase 7's "
                   "checkpoint",
          "data": f"write_dataset's {len(ds_t)} frames, --torso --preload {opt.preload}"}
    report["torso_train"] = {**tp, "step_losses": losses}
    emit({"phase": "torso_train", **tp})
    want = {"march_rays": TORSO_STEPS, "composite_rays": TORSO_STEPS,
            "grid_encode_backward": TORSO_STEPS, "composite_rays_backward": 0}
    if launches["grid_encode"] <= 0 or any(launches[k] != v for k, v in want.items()):
        raise RuntimeError(f"torso stage launches {launches}, want A > 0 and {want}")
    if tr.global_step != TORSO_STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"torso training: {tr.global_step} steps, losses {losses}")
    if not head_unchanged or not torso_names or not all(torso_moved.values()):
        raise RuntimeError(f"head changed or torso still: head unchanged {head_unchanged}, "
                           f"torso moved {torso_moved}")
    if not tr.stats["mean_density_torso"][0] > 0 or not telemetry["n_torso_mask"] > 0:
        raise RuntimeError(f"empty torso grid or mask: {tr.stats['mean_density_torso']}, "
                           f"{telemetry}")
    if not loss_end < loss_0:
        raise RuntimeError(f"fixed-batch torso loss did not fall: {loss_0} -> {loss_end}")

    # ---- 12. A' and A at the torso stage's own calls: the encode's points
    # and upstream gradient recorded in a step, its points in an upkeep
    seen = {}
    encode = network_mod.grid_encode

    def recording(x, table, spec, bound=1.0):
        out = encode(x, table, spec, bound)
        if table is net.torso_encoder:
            seen["x"] = x.detach()
            if out.requires_grad:
                out.register_hook(lambda g: seen.__setitem__("grad_out", g.detach()))
        return out

    network_mod.grid_encode = recording
    try:
        batch = tr.next_batch(ds_t, 1)
        tr.loss(batch, tr.draw_noises(opt.num_rays), tr.global_step)[0].backward()
        tr.optimizer.zero_grad(set_to_none=True)
        x_step, grad_out = seen["x"], seen["grad_out"]
        update_torso_grid(net, rc, tr.state, batch["poses"], net.individual_codes_torso[1],
                          generator=torch.Generator(dev).manual_seed(8))
        x_upkeep = seen["x"]
    finally:
        network_mod.grid_encode = encode
    table, spec = net.torso_encoder.detach(), net.cfg.torso_spec
    gk = grid_encode_backward(x_step, table, grad_out, spec, 1.0, need_x=True)
    gp = grid_encode_backward_plain(x_step, table, grad_out, spec, 1.0, need_x=True)
    n_busy = int(row_counts(x_step, spec, 1.0)[0].max())
    a_bwd = {"n_points": int(x_step.shape[0]), "busiest_row_contributions": n_busy,
             "table_tol_rel": max(TOL_BACKWARD_REL, 4.0 * math.sqrt(n_busy) * 2**-24),
             "table_rel_err": rel_err(gk[0], gp[0]),
             "table_max_abs_err": float((gk[0] - gp[0]).abs().max()),
             "x_rel_err": rel_err(gk[1], gp[1]), "x_tol_rel": TOL_BACKWARD_REL,
             "x_max_abs_err": float((gk[1] - gp[1]).abs().max())}
    a_args = (x_upkeep, table, spec, 1.0)
    a_fwd = {"n_points": int(x_upkeep.shape[0]),
             "bit_for_bit": bool(torch.equal(grid_encode(*a_args), grid_encode_plain(*a_args)))}
    torch.cuda.synchronize()
    checks = {"grid_encode_backward_torso": a_bwd, "grid_encode_torso_upkeep": a_fwd}
    report["torso_kernel_checks"] = checks
    emit({"phase": "torso_kernel_checks", **checks})
    if not (a_bwd["table_rel_err"] <= a_bwd["table_tol_rel"]
            and a_bwd["x_rel_err"] <= TOL_BACKWARD_REL):
        raise RuntimeError(f"grid_encode_backward differs at the torso step: {a_bwd}")
    if not a_fwd["bit_for_bit"] or a_fwd["n_points"] != rc.grid_size**2:
        raise RuntimeError(f"grid_encode differs from its twin at the torso upkeep: {a_fwd}")

    # ---- torso timing: the loop entry fenced call by call, a profile of
    # steps that run no upkeep, A' and A at the stage's calls
    interval = opt.update_extra_interval
    order = ds_t.epoch_indices()
    step_ms, upkeep_step_ms = [], []
    for n in range(2 * interval - PROFILED_STEPS):
        upkeep = tr.global_step % interval == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step(ds_t, order[n % len(order)])
        torch.cuda.synchronize()
        (upkeep_step_ms if upkeep else step_ms).append((time.perf_counter() - t0) * 1e3)
    if any((tr.global_step + i) % interval == 0 for i in range(PROFILED_STEPS)):
        raise RuntimeError("a profiled torso step would run the upkeep")
    prof, events = device_profile(lambda i: tr.step(ds_t, order[i % len(order)]),
                                  PROFILED_STEPS)
    with open(os.path.join(out_dir, "chip_smoke_torso_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    busy_ms = sum(e.self_device_time_total for e in events) / PROFILED_STEPS / 1e3
    med = float(np.median(step_ms))

    def bwd():
        return grid_encode_backward(x_step, table, grad_out, spec, 1.0, need_x=True)

    nb, nf = grid_backward_work(x_step, spec, 1.0, True)
    bms, by = bound_ms(nb, nf)
    torso_bwd = {"n_points": int(x_step.shape[0]), "x_grad": True,
                 "launches_in_torso_run": launches["grid_encode_backward"],
                 "ms": cuda_ms(bwd, 20), "device_ms": device_ms(bwd, 20),
                 "plain_ms": cuda_ms(lambda: grid_encode_backward_plain(
                     x_step, table, grad_out, spec, 1.0, need_x=True), 3),
                 "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
                 "max_abs_err": max(a_bwd["table_max_abs_err"], a_bwd["x_max_abs_err"])}
    nb, nf = grid_work(x_upkeep, spec, 1.0)
    bms, by = bound_ms(nb, nf)
    upkeep_fwd = {"n_points": int(x_upkeep.shape[0]),
                  "ms": cuda_ms(lambda: grid_encode(*a_args), 20),
                  "device_ms": device_ms(lambda: grid_encode(*a_args), 20),
                  "plain_ms": cuda_ms(lambda: grid_encode_plain(*a_args), 3),
                  "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf}
    tt = {"torso_step_ms_median": med, "torso_step_ms": step_ms,
          "upkeep_step_ms": upkeep_step_ms, "upkeep_ms": [u - med for u in upkeep_step_ms],
          "rays": opt.num_rays,
          "profile": {"steps": PROFILED_STEPS, "device_busy_ms_per_step": busy_ms,
                      "device_busy_share": busy_ms / med,
                      "ms_per_step_by_class": ms_by_class(events, PROFILED_STEPS),
                      "top": [{"name": e.key[:80],
                               "ms_per_step": e.self_device_time_total / PROFILED_STEPS / 1e3,
                               "calls_per_step": e.count / PROFILED_STEPS}
                              for e in events[:15]]},
          "grid_encode_backward_torso_step": torso_bwd, "grid_encode_torso_upkeep": upkeep_fwd}
    report["torso_timing"] = tt
    emit({"phase": "torso_timing", **{k: v for k, v in tt.items()
                                      if k not in ("profile", "torso_step_ms")},
          "device_busy_ms_per_step": busy_ms, "device_busy_share": busy_ms / med,
          "ms_per_step_by_class": tt["profile"]["ms_per_step_by_class"],
          "top5": tt["profile"]["top"][:5]})
    return head_ckpt, torso_bwd


def checkpoint_phase(report, head, head_ckpt, scene, aud):
    """Phase 13: a fresh head trainer loads the head checkpoint; its
    parameters and renderer state must equal the writer's, and its 512x512
    frame of the bench camera must equal the writer's bit for bit."""
    import dataclasses

    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.models import render_rays
    from radnerf_tpu_torch.train import Trainer

    b = scene[3]
    fresh = Trainer(Options(exp_eye=True), device=head.device)
    fresh.load_checkpoint(head_ckpt)
    own = dict(head.net.named_parameters())
    params_equal = all(torch.equal(p, own[n]) for n, p in fresh.net.named_parameters())
    state_differs = [f.name for f in dataclasses.fields(fresh.state)
                     if not torch.equal(getattr(fresh.state, f.name), getattr(head.state, f.name))]

    def frame(tr):
        return render_rays(tr.net, tr.render_cfg, tr.state, b["rays_o"], b["rays_d"], aud,
                           b["bg_coords"], b["poses"], b["eye"], b["index"], b["bg_color"])[0]

    mine, theirs = frame(head), frame(fresh)
    frame_differs = [k for k in mine if not torch.equal(mine[k], theirs[k])]
    cp = {"params_equal": params_equal, "state_fields_differing": state_differs,
          "frame_fields_differing": frame_differs,
          "frame_max_abs_err": float((mine["image"] - theirs["image"]).abs().max()),
          "weights_sum_max": float(mine["weights_sum"].max()),
          "telemetry": {k: int(v) for k, v in theirs.items() if k.startswith("n_")},
          "global_step": fresh.global_step, "epoch": fresh.epoch}
    report["checkpoint"] = cp
    emit({"phase": "checkpoint", **cp})
    if not params_equal or state_differs or frame_differs:
        raise RuntimeError(f"the loaded checkpoint differs from its writer: {cp}")
    if fresh.global_step != head.global_step:
        raise RuntimeError(f"step count {fresh.global_step}, writer {head.global_step}")


def _u8(x):
    return np.clip(np.round(np.asarray(x) * 255.0), 0, 255).astype(np.uint8)


def write_dataset(root, scene):
    """A processed-video directory in the reference's layout at ``root``:
    DATASET_FRAMES frames of the bench camera rendered by the frame path
    (``render_targets``, audio from numpy seed 2) as ``gt_imgs/<i>.jpg``,
    their torso layer and alpha as the RGBA plates ``torso_imgs/<i>.png``,
    68 landmarks each in the frame's middle (``ori_imgs/<i>.lms``), the
    background as ``bc.jpg``, the audio table ``aud_eo.npy`` [T, 16, 44], and
    ``transforms_train.json`` (every frame) / ``transforms_val.json`` (the
    first VAL_FRAMES). Every image is PNG content under the format's own
    names: lossless (so the frames on the card can equal the files, and the
    eval PSNR means something), and decoded by content as cv2 would."""
    from radnerf_tpu_torch.utils.image import write_png

    H = W = TRAIN_SIZE
    rng = np.random.default_rng(2)
    auds, images, plates, alphas = render_targets(scene, rng, DATASET_FRAMES)
    for sub in ("gt_imgs", "torso_imgs", "ori_imgs"):
        os.makedirs(os.path.join(root, sub))
    # the transform_matrix whose NGP pose (scale 4) is the bench camera's:
    # identity rotation at (0, 0, -3.3)
    pose = np.zeros((4, 4), np.float32)
    pose[0, :3], pose[1, :3], pose[2, :3], pose[3, 3] = [0, 0, -1], [1, 0, 0], [0, -1, 0], 1.0
    pose[0, 3] = -3.3 / 4.0
    frames = []
    for i in range(DATASET_FRAMES):
        write_png(os.path.join(root, "gt_imgs", f"{i}.jpg"), _u8(images[i]).reshape(H, W, 3))
        write_png(os.path.join(root, "torso_imgs", f"{i}.png"),
                  _u8(np.concatenate([plates[i], alphas[i]], -1)).reshape(H, W, 4))
        np.savetxt(os.path.join(root, "ori_imgs", f"{i}.lms"),
                   rng.uniform(0.3 * H, 0.7 * H, (68, 2)))
        frames.append({"img_id": i, "aud_id": i, "transform_matrix": pose.tolist()})
    write_png(os.path.join(root, "bc.jpg"), _u8(scene[3]["bg_color"].cpu()).reshape(H, W, 3))
    np.save(os.path.join(root, "aud_eo.npy"), auds.transpose(0, 2, 1))
    camera = {"focal_len": 1200.0 * H / 450.0, "cx": W / 2, "cy": H / 2}
    for name, fr in (("train", frames), ("val", frames[:VAL_FRAMES])):
        with open(os.path.join(root, f"transforms_{name}.json"), "w") as f:
            json.dump({**camera, "frames": fr}, f)


def fenced_ms(fn, reps):
    """ms of each of ``reps`` calls of fn(i), each fenced by synchronize()."""
    out = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def host_batch(ds, index, rng, image, torso):
    """The training batch of frame ``index`` built on the host in numpy, as
    the JAX collate builds it (its ``get_rays`` draws the pixels from
    ``rng``, the torso plate is composited over the whole frame, the pixels
    gathered after), from the frame and its plate decoded (float32 [H, W,
    C])."""
    from radnerf_tpu_torch.data import convert_poses, get_audio_features, get_bg_coords, \
        get_rays

    rays = get_rays(ds.poses[index], ds.intrinsics, ds.H, ds.W, ds.num_rays, rng=rng)
    inds = rays["inds"]
    bg_torso = (torso[..., :3] * torso[..., 3:] + ds.bg_img * (1 - torso[..., 3:])).reshape(-1, 3)
    xmin, xmax, ymin, ymax = ds.face_rect[index]
    return {"index": index, "H": ds.H, "W": ds.W,
            "images": image.reshape(-1, 3)[inds], "bg_color": bg_torso[inds],
            "bg_coords": get_bg_coords(ds.H, ds.W)[inds],
            "face_mask": ((rays["j"] >= xmin) & (rays["j"] < xmax)
                          & (rays["i"] >= ymin) & (rays["i"] < ymax)),
            "auds": get_audio_features(ds.auds, ds.opt.att, index),
            "eye": ds.eye_area[index].reshape(1, 1), "rays_o": rays["rays_o"],
            "rays_d": rays["rays_d"], "poses": convert_poses(ds.poses[index][None])}


def dataset_phase(report, head, ds, root, write_s):
    """Phase 14: ``write_dataset``'s directory as phase 7 loaded it
    (``ds``, with ``--preload 2``): the frames on the card equal the decoded
    files; one training batch equals the host's numpy gather of the same
    pixels (``host_batch``, the JAX collate's formulas) bit for bit, its rays
    within one float32 ulp; ``next_batch`` on the card timed against the
    numpy batch moved by the same trainer; one torso plate decoded by
    ``imread_u8`` as this machine decodes it and by the port's own PNG
    reader, on the plate as written here (rows unfiltered) and as cv2 writes
    it (filtered rows: the real plates' case), where cv2 is installed."""
    from radnerf_tpu_torch.utils import image as image_mod
    from radnerf_tpu_torch.utils.image import U8_TO_UNIT, imread_u8

    paths = [(os.path.join(root, "gt_imgs", f"{i}.jpg"),
              os.path.join(root, "torso_imgs", f"{i}.png")) for i in range(len(ds))]
    decoded = [tuple(imread_u8(p) for p in pair) for pair in paths]
    files_equal = all(torch.equal(ds.images[i].cpu(), torch.from_numpy(decoded[i][0]))
                      and torch.equal(ds.torso_imgs[i].cpu(), torch.from_numpy(decoded[i][1]))
                      for i in range(len(ds)))
    unit = [tuple(U8_TO_UNIT[a] for a in pair) for pair in decoded]

    # one batch against the host's numpy gather of the same pixels
    index = 3
    rng = copy.deepcopy(ds.rng)
    batch = ds.collate(index)
    host = host_batch(ds, index, rng, *unit[index])
    differing = [k for k in ("images", "bg_color", "bg_coords", "face_mask", "auds", "eye",
                             "rays_o", "poses")
                 if not np.array_equal(batch[k].cpu().numpy(), host[k])]
    got_d = batch["rays_d"].cpu().numpy()
    ulps = int(np.abs(got_d.view(np.int32).astype(np.int64)
                      - host["rays_d"].view(np.int32).astype(np.int64)).max())

    order = ds.epoch_indices()
    disk_ms = fenced_ms(lambda i: head.next_batch(ds, order[i % len(order)]), 8)
    numpy_ms = fenced_ms(lambda i: head.to_device(host_batch(
        ds, int(order[i % len(order)]), ds.rng, *unit[order[i % len(order)]])), 8)

    # decoding a plate: --preload 0 decodes a frame and a plate each step,
    # --preload 1/2 each once at load
    def decode_ms(fn):
        return float(np.median(fenced_ms(lambda i: fn(), 3)))

    plate = paths[0][1]
    with open(plate, "rb") as f:
        data = f.read()
    decode = {"imread_u8_ms": decode_ms(lambda: imread_u8(plate)),
              "own_reader_unfiltered_ms": decode_ms(lambda: image_mod._read_png(data, plate))}
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        filtered = os.path.join(root, "plate_cv2.png")
        cv2.imwrite(filtered, cv2.cvtColor(decoded[0][1], cv2.COLOR_RGBA2BGRA))
        with open(filtered, "rb") as f:
            data = f.read()
        decode.update(
            imread_u8_cv2_written_ms=decode_ms(lambda: imread_u8(filtered)),
            own_reader_cv2_written_ms=decode_ms(lambda: image_mod._read_png(data, filtered)),
            own_reader_cv2_written_equal=bool(np.array_equal(
                image_mod._read_png(data, filtered), decoded[0][1])))
    dp = {"frames": len(ds), "size": [ds.H, ds.W], "preload": ds.preload,
          "rays": ds.num_rays, "write_seconds": write_s,
          "load_seconds": report["train"]["dataset_seconds"],
          "frames_equal_files": files_equal, "batch_fields_differing": differing,
          "rays_d_max_ulp": ulps, "face_mask_pixels": int(batch["face_mask"].sum()),
          "next_batch_ms_median": float(np.median(disk_ms)), "next_batch_ms": disk_ms,
          "numpy_next_batch_ms_median": float(np.median(numpy_ms)),
          "numpy_next_batch_ms": numpy_ms, "plate_decode": decode}
    report["dataset"] = dp
    emit({"phase": "dataset", **dp})
    if not files_equal or differing or ulps > 1:
        raise RuntimeError(f"the dataset on the card differs from its files or the host "
                           f"gather: {dp}")
    if not 0 < dp["face_mask_pixels"] < ds.num_rays:
        raise RuntimeError(f"the face mask is empty or full: {dp}")
    if not decode.get("own_reader_cv2_written_equal", True):
        raise RuntimeError(f"the own PNG reader differs from cv2 on a cv2-written plate: {dp}")


def entry_phase(report, root):
    """Phase 15: the port's CLI in this process at full width, as a user
    runs it (``python -m radnerf_tpu_torch.main <dir> --exp_eye --preload 2``,
    65,536 rays, 2 epochs of the 8 frames, evaluation, the test split
    evaluated and rendered) with every launch count set to 0 just before and
    read just after; then ``infer`` from its ``ngp.npz`` on a pose json and
    an audio table, one frame per audio row. Returns the trainer."""
    from radnerf_tpu_torch import infer
    from radnerf_tpu_torch.convert import _state_dict_from_jax
    from radnerf_tpu_torch.main import main as port_main
    from radnerf_tpu_torch.models import NeRFNetwork, graph_stats, reset_graph_stats
    from radnerf_tpu_torch.ops import _kernels
    from radnerf_tpu_torch.train import checkpoint as ckpt_lib

    ws = os.path.join(root, "workspace")
    # the EMA moves every step (the CLI's default interval, 1000 steps,
    # would leave the evaluated parameters at their initial draw)
    argv = [root, "--workspace", ws, "--exp_eye", "--preload", "2", "--ckpt", "scratch",
            "--iters", str(ENTRY_EPOCHS * DATASET_FRAMES), "--ema_update_interval", "1"]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    tr = port_main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _kernels.launches()
    losses = tr.stats["step_loss"]
    ckpts = sorted(os.listdir(tr.ckpt_path))
    # the best checkpoint holds the EMA, which training moved off the
    # initial draw wherever it moved the live parameters
    best = _state_dict_from_jax(ckpt_lib.load_checkpoint(tr.best_path)[0])
    init = dict(NeRFNetwork(tr.net_cfg, device=tr.device, generator=torch.Generator()
                            .manual_seed(tr.opt.seed)).named_parameters())
    live = dict(tr.net.named_parameters())
    ema = {"parameters": len(tr.ema_params),
           "best_equals_ema": all(k in best and np.array_equal(best[k], v.cpu().numpy())
                                  for k, v in tr.ema_params.items()),
           "live_moved": sum(not torch.equal(live[k], init[k]) for k in live),
           "ema_moved": sum(not torch.equal(v, init[k]) for k, v in tr.ema_params.items()),
           "moved_live_still_ema": [k for k in live if not torch.equal(live[k], init[k])
                                    and torch.equal(tr.ema_params[k], init[k])]}
    del init
    validation = sorted(os.listdir(os.path.join(ws, "validation")))
    results = sorted(os.listdir(os.path.join(ws, "results")))
    # the run log (JAX's log_<name>.txt): its banner and every epoch
    with open(os.path.join(ws, "log_ngp.txt")) as fh:
        log_lines = fh.read().splitlines()
    log_events = ["[INFO] Trainer: ngp | ", "[INFO] #parameters: ",
                  *(f"==> Start Training Epoch {e} ..." for e in range(1, ENTRY_EPOCHS + 1)),
                  *(f"==> Finished Epoch {e}: " for e in range(1, ENTRY_EPOCHS + 1)),
                  "++> Evaluate at epoch ", "==> Finished Test."]
    log_missing = [e for e in log_events if not any(l.startswith(e) for l in log_lines)]

    pose_path, aud_path = os.path.join(root, "pose.json"), os.path.join(root, "novel.npy")
    with open(os.path.join(root, "transforms_val.json")) as f:
        camera = json.load(f)
    with open(pose_path, "w") as f:
        json.dump({k: camera[k] for k in ("focal_len", "cx", "cy", "frames")}, f)
    np.save(aud_path, np.random.default_rng(3).normal(size=(INFER_FRAMES, 16, 44))
            .astype(np.float32))
    out = os.path.join(root, "infer")
    torch.cuda.synchronize()
    _kernels.reset_launches()
    reset_graph_stats()
    fps = infer.main(["--pose", pose_path, "--aud", aud_path, "--workspace", out, "--exp_eye",
                      "--ckpt", tr.best_path])
    torch.cuda.synchronize()
    # the host's launches: a replayed frame's kernels are in the graphs' replays
    infer_launches, infer_graphs = _kernels.launches(), graph_stats()
    infer_files = sorted(os.listdir(os.path.join(out, "results")))
    ep = {"argv": argv, "seconds": run_s, "steps": tr.global_step, "epochs": tr.epoch,
          "eval_interval": tr.eval_interval, "launches": launches,
          "loss_first": losses[0], "loss_last": losses[-1],
          "eval_psnr": tr.stats["results"], "eval_loss": tr.stats["valid_loss"],
          "metrics": [type(m).__name__ for m in tr.metrics], "checkpoints": ckpts, "ema": ema,
          "validation_files": len(validation), "result_files": results,
          "log_lines": len(log_lines), "log_banner": log_lines[:2],
          "log_events_missing": log_missing,
          "infer": {"launches": infer_launches, "graphs": infer_graphs, "fps": fps,
                    "files": len(infer_files)},
          "model": "NetworkConfig(torso=False, exp_eye=True) full width, float32, the CLI's "
                   "defaults (65,536 rays, grid 128), seeded init"}
    report["entry"] = {**ep, "step_losses": losses}
    emit({"phase": "entry", **ep})
    missing = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    if missing or any(infer_launches[k] <= 0 for k in FRAME_KERNELS):
        raise RuntimeError(f"kernels not launched through the entry points: {ep}")
    if tr.global_step != ENTRY_EPOCHS * DATASET_FRAMES or \
            not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"entry training: {tr.global_step} steps, losses {losses}")
    if ckpts != ["ngp.npz", f"ngp_ep{ENTRY_EPOCHS - 1:04d}.npz", f"ngp_ep{ENTRY_EPOCHS:04d}.npz"]:
        raise RuntimeError(f"checkpoints written: {ckpts}")
    if not ema["best_equals_ema"] or not ema["live_moved"] or ema["moved_live_still_ema"]:
        raise RuntimeError(f"ngp.npz is not the trained EMA: {ema}")
    if not tr.stats["results"] or not all(math.isfinite(v) for v in tr.stats["results"]):
        raise RuntimeError(f"eval PSNR: {tr.stats['results']}")
    if len(validation) != 2 * VAL_FRAMES or not (
            "ngp_ep0002.mp4" in results or len(results) == VAL_FRAMES):
        raise RuntimeError(f"validation files {validation}, results {results}")
    if len(infer_files) not in (1, INFER_FRAMES) or not fps > 0:
        raise RuntimeError(f"infer wrote {infer_files} at {fps} FPS")
    if log_missing:
        raise RuntimeError(f"{ws}/log_ngp.txt lacks {log_missing}")
    return tr


def entry_timing_phase(report, out_dir, tr, root):
    """Phase 16: the entry trainer on its own datasets: ``Trainer.step``
    with the card's batches fenced call by call (beside phase 10's), a 3-step profile and its busy share, the batch preparation
    alone, kernels A, B and C against their plain versions on the eval
    frame's own inputs (``eval_kernel_checks``), the eval frame
    (``eval_step``) fenced and profiled, and ``test``'s FPS over the test
    split."""
    from radnerf_tpu_torch.data import TalkingHeadDataset

    ds = TalkingHeadDataset(tr.opt, split="train", device=tr.device)
    val = TalkingHeadDataset(tr.opt, split="val", device=tr.device)
    interval = tr.opt.update_extra_interval
    order = ds.epoch_indices()
    step_ms, upkeep_step_ms = [], []
    for n in range(2 * interval - PROFILED_STEPS):
        upkeep = tr.global_step % interval == 0
        (upkeep_step_ms if upkeep else step_ms).extend(
            fenced_ms(lambda i: tr.step(ds, order[n % len(order)]), 1))
    if any((tr.global_step + i) % interval == 0 for i in range(PROFILED_STEPS)):
        raise RuntimeError("a profiled entry step would run the upkeep")
    prof, events = device_profile(lambda i: tr.step(ds, order[i % len(order)]), PROFILED_STEPS)
    with open(os.path.join(out_dir, "chip_smoke_entry_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    busy_ms = sum(e.self_device_time_total for e in events) / PROFILED_STEPS / 1e3
    prep_ms = fenced_ms(lambda i: tr.next_batch(ds, order[i % len(order)]), 8)
    med = float(np.median(step_ms))

    batch = tr.next_batch(val, 0)
    checks = eval_kernel_checks(tr, batch)
    eval_ms = fenced_ms(lambda i: tr.eval_step(batch), 8)
    _, eval_events = device_profile(lambda i: tr.eval_step(batch), 3)
    eval_busy = sum(e.self_device_time_total for e in eval_events) / 3 / 1e3
    fps = [tr.test(val, save_path=os.path.join(root, "timing"), name=f"t{i}") for i in range(2)]
    et = {"train_step_ms_median": med, "train_step_ms": step_ms,
          "phase10_train_step_ms_median": report["train_timing"]["train_step_ms_median"],
          "upkeep_step_ms": upkeep_step_ms, "batch_prep_ms_median": float(np.median(prep_ms)),
          "batch_prep_ms": prep_ms,
          "phase10_batch_prep_ms_median": report["train_timing"]["batch_prep_ms_median"],
          "profile": {"steps": PROFILED_STEPS, "device_busy_ms_per_step": busy_ms,
                      "device_busy_share": busy_ms / med,
                      "ms_per_step_by_class": ms_by_class(events, PROFILED_STEPS)},
          "eval_frame_ms_median": float(np.median(eval_ms)), "eval_frame_ms": eval_ms,
          "eval_frame_device_ms": eval_busy,
          "eval_frame_device_ms_by_class": ms_by_class(eval_events, 3),
          "test_fps": fps, "test_frames": len(val), "eval_kernel_checks": checks}
    report["entry_timing"] = et
    emit({"phase": "entry_timing", **{k: v for k, v in et.items()
                                      if k not in ("train_step_ms", "batch_prep_ms")}})
    for name, calls in checks.items():
        for c in calls:
            if not c["ok"]:
                raise RuntimeError(f"{name} differs from its twin in the eval frame: {c}")


def variants_phase(report, out_dir, root):
    """variants: ``python -m radnerf_tpu_torch.main <dir> --exp_eye
    --grid_levels 8 --grid_ch 4 --bound 2 --max_steps 128`` in this process
    at full width in float32 (65,536 rays, VARIANT_STEPS steps: 2 epochs of
    the 8 frames, the evaluation, the test split) with every launch count
    set to 0 just before and read just after: kernels A and A' at 4
    channels, B on the general orbit at cascade 2, C and C' launched; the
    peak memory reckoned before the run (an eval frame marches at most
    512 * 512 * 128 samples) and measured; the loss on a fixed batch before
    (the seeded init on an upkept grid) and after; the files written; then
    ``Trainer.step`` fenced (upkeep steps apart) and a 3-step profile, an
    eval frame fenced and profiled with its samples, and infer from the
    run's ngp.npz. Returns (one step's recorded A, A' and B calls, one eval
    frame's A and B calls, the run's launches, its renderer state)."""
    import radnerf_tpu_torch.models.network as network_mod
    import radnerf_tpu_torch.models.renderer as renderer_mod
    from radnerf_tpu_torch import infer
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.main import build_parser, options_from_args
    from radnerf_tpu_torch.main import main as port_main
    from radnerf_tpu_torch.models import (
        NetworkConfig, RenderConfig, RendererState, graph_stats, mark_untrained_grid,
        reset_graph_stats, update_density_grid,
    )
    from radnerf_tpu_torch.ops import _kernels, march_rays
    from radnerf_tpu_torch.train import Trainer

    ws = os.path.join(root, "variants")
    argv = [root, "--workspace", ws, "--exp_eye", "--preload", "2", "--ckpt", "scratch",
            "--iters", str(VARIANT_STEPS), "--ema_update_interval", "1", *VARIANT_FLAGS]
    opt = options_from_args(build_parser().parse_args(argv))
    rc, ncfg = RenderConfig.from_options(opt), NetworkConfig.from_options(opt)
    mcfg = rc.march_config()
    if mcfg.affine or rc.cascade != 2 or ncfg.grid_spec.level_dim != 4:
        raise RuntimeError(f"the variant flags do not give the variants: {mcfg}, {ncfg}")
    # the peak, reckoned before the run: an eval frame's [N, S] march outputs
    # and scattered field values (45 B a slot), and per sample its index and
    # the field's widest live set (the sigma MLP's input and what it keeps:
    # position, direction, both encodes, the ambient MLP's input and hidden
    # layer, the ambient coordinates, the sigma MLP's input and hidden layer)
    gs, gw = ncfg.grid_spec, ncfg.ambient_spec
    slots = TRAIN_SIZE * TRAIN_SIZE * mcfg.n_sample_slots
    floats = (3 + 3 + gs.output_dim + gs.output_dim + ncfg.audio_dim + ncfg.hidden_dim_ambient
              + 2 + gw.output_dim + gs.output_dim + gw.output_dim + 1 + ncfg.hidden_dim)
    reckoned = slots * 45 + slots * (8 + 4 * floats)
    card = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "variants_reckoning", "eval_frame_samples_at_most": slots,
          "field_floats_per_sample": floats, "reckoned_eval_peak_gb": reckoned / 1e9,
          "card_gb": card / 1e9})
    if reckoned > 0.8 * card:
        raise RuntimeError(f"an eval frame would take {reckoned / 1e9:.1f} GB")

    # the fixed batch's loss at the seeded init (main's own draw), on a grid
    # upkept as the first upkeep does
    ds = TalkingHeadDataset(opt, split="train", device="cuda")
    dev = ds.device
    tr0 = Trainer(opt, device=dev)
    fixed = tr0.next_batch(ds, 0)
    fixed_noises = torch.rand(opt.num_rays, generator=torch.Generator(dev).manual_seed(123),
                              device=dev)
    with torch.no_grad():
        probe = update_density_grid(
            tr0.net, rc, mark_untrained_grid(rc, RendererState.create(rc, device=dev),
                                             ds.poses, ds.intrinsics),
            tr0.net.encode_audio(ds.audio_window(0)), fixed["eye"],
            generator=torch.Generator(dev).manual_seed(7))
        loss_0 = float(tr0.loss(fixed, fixed_noises, 0, state=probe)[0])
    del tr0, probe
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    tr = port_main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _kernels.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        loss_end = float(tr.loss(fixed, fixed_noises, 0)[0])
    losses = tr.stats["step_loss"]
    files = {"checkpoints": sorted(os.listdir(tr.ckpt_path)),
             "validation": len(os.listdir(os.path.join(ws, "validation"))),
             "results": sorted(os.listdir(os.path.join(ws, "results")))}
    out = os.path.join(root, "variants_infer")
    _kernels.reset_launches()
    reset_graph_stats()
    fps = infer.main(["--pose", os.path.join(root, "pose.json"), "--aud",
                      os.path.join(root, "novel.npy"), "--workspace", out, "--exp_eye",
                      "--ckpt", tr.best_path, *VARIANT_FLAGS])
    torch.cuda.synchronize()
    infer_launches, infer_graphs = _kernels.launches(), graph_stats()
    files["infer"] = len(os.listdir(os.path.join(out, "results")))

    # the step, fenced (upkeep steps apart) and profiled; one more step's
    # kernel calls recorded
    interval, order = opt.update_extra_interval, ds.epoch_indices()
    step_ms, upkeep_step_ms = [], []
    for n in range(VARIANT_TIMED_STEPS):
        upkeep = tr.global_step % interval == 0
        (upkeep_step_ms if upkeep else step_ms).extend(
            fenced_ms(lambda i: tr.step(ds, order[n % len(order)]), 1))
    if any((tr.global_step + i) % interval == 0 for i in range(PROFILED_STEPS + 1)):
        raise RuntimeError("a profiled or recorded variants step would run the upkeep")
    prof, events = device_profile(lambda i: tr.step(ds, order[i % len(order)]), PROFILED_STEPS)
    with open(os.path.join(out_dir, "chip_smoke_variants_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    busy_ms = sum(e.self_device_time_total for e in events) / PROFILED_STEPS / 1e3
    # the module itself (the package's name grid_encode is the function)
    grid_mod = sys.modules["radnerf_tpu_torch.ops.grid_encode"]
    with recorded_calls([(network_mod, "grid_encode"), (grid_mod, "grid_encode_backward"),
                         (renderer_mod, "march_rays")]) as step_calls:
        tr.step(ds, order[0])
    torch.cuda.synchronize()

    # an eval frame: fenced, profiled, its samples; its calls recorded
    val = TalkingHeadDataset(tr.opt, split="val", device=dev)
    batch = tr.next_batch(val, 0)
    with recorded_calls([(network_mod, "grid_encode"),
                         (renderer_mod, "march_rays")]) as eval_calls:
        tr.eval_step(batch)
    torch.cuda.synchronize()
    m_args, m_kw = next((a, kw) for name, a, kw in eval_calls if name == "march_rays")
    n_samples = int(march_rays(*m_args, **m_kw)["valid"].sum())
    eval_ms = fenced_ms(lambda i: tr.eval_step(batch), 3)
    _, eval_events = device_profile(lambda i: tr.eval_step(batch), 2)
    # the frames whose kernels the trace kept (one march a frame): a trace
    # of two frames this large has kept one of them
    frames = int(sum(e.count for e in eval_events if "march_rays_kernel" in e.key))
    if frames < 1:
        raise RuntimeError("the eval frames' profile holds no march")
    eval_busy = sum(e.self_device_time_total for e in eval_events) / frames / 1e3
    med = float(np.median(step_ms))
    vp = {"argv": argv, "seconds": run_s, "steps": VARIANT_STEPS, "launches": launches,
          "march": {"cascade": mcfg.cascade, "affine": mcfg.affine, "dt_min": mcfg.dt_min,
                    "dt_max": mcfg.dt_max, "K": mcfg.n_march_iters, "S": mcfg.n_sample_slots},
          "grids": {"spatial": str(gs), "ambient": str(gw)},
          "loss_first": losses[0], "loss_last": losses[-1],
          "fixed_batch_loss_step0": loss_0, "fixed_batch_loss_end": loss_end,
          "eval_psnr": tr.stats["results"], "files": files,
          "infer": {"launches": infer_launches, "graphs": infer_graphs, "fps": fps},
          "max_memory_allocated_gb": peak_gb, "reckoned_eval_peak_gb": reckoned / 1e9,
          "train_step_ms_median": med, "train_step_ms": step_ms,
          "upkeep_step_ms": upkeep_step_ms,
          "profile": {"steps": PROFILED_STEPS, "device_busy_ms_per_step": busy_ms,
                      "device_busy_share": busy_ms / med,
                      "ms_per_step_by_class": ms_by_class(events, PROFILED_STEPS),
                      "grid_encode_ms": kernel_class_ms(events, PROFILED_STEPS, "grid_encode"),
                      "march_ms": kernel_class_ms(events, PROFILED_STEPS, "march_rays")},
          "eval_frame_ms": eval_ms, "eval_frame_device_ms": eval_busy,
          "eval_frames_profiled": frames,
          "eval_frame_device_ms_by_class": ms_by_class(eval_events, frames),
          "eval_frame_samples": n_samples,
          "model": "NetworkConfig(torso=False, exp_eye=True) full width, float32, grids 8x4 "
                   "(3-D and 2-D), bound 2, max_steps 128, the CLI's defaults otherwise"}
    report["variants"] = {**vp, "step_losses": losses}
    emit({"phase": "variants", **{k: v for k, v in vp.items() if k != "train_step_ms"}})
    problems = []
    if any(launches[k] <= 0 for k in TRAIN_KERNELS) or \
            any(infer_launches[k] <= 0 for k in FRAME_KERNELS):
        problems.append(f"launches {launches}, infer {infer_launches}")
    if len(losses) != VARIANT_STEPS or not all(math.isfinite(v) for v in losses):
        problems.append(f"losses {losses}")
    if not loss_end < loss_0:
        problems.append(f"the fixed batch's loss did not fall: {loss_0} -> {loss_end}")
    if "ngp.npz" not in files["checkpoints"] or files["validation"] != 2 * VAL_FRAMES or \
            not files["results"] or files["infer"] not in (1, INFER_FRAMES):
        problems.append(f"files {files}")
    if [n for n, _, _ in step_calls] != ["march_rays", "grid_encode", "grid_encode",
                                         "grid_encode_backward", "grid_encode_backward"]:
        problems.append(f"the step's calls {[n for n, _, _ in step_calls]}")
    if not n_samples > 0:
        problems.append("the eval frame marched no sample")
    if problems:
        raise RuntimeError(f"variants: {problems}")
    state = tr.state
    del tr, ds, val, prof, events
    torch.cuda.empty_cache()
    return step_calls, eval_calls, launches, state


def variant_kernel_checks(report, step_calls, eval_calls, launches):
    """variant_kernel_checks: kernels A, A' and B on the variants
    against their plain versions on the card. A bit for bit and A'
    (the table gradient per row within 2 (n - 1) 2^-24 of its sum of |terms|
    or 1e-4 of the largest, x within 1e-5) on the variants run's recorded
    4-channel calls (the step's and an eval frame's), on get_encoder
    ("hashgrid") at its defaults and on VARIANT_GRIDS' tiled grids
    (smoothstep, align_corners, 1 and 8 channels), each on VARIANT_POINTS
    seeded points (a few outside the box) with a seeded upstream gradient;
    B bit for bit (valid, t, dt, xyz, count) on the recorded step call
    (with noises) and eval call (without), and at cascade 2 on the affine
    orbit (bound 2, max_steps 16) on the eval call's rays. Each beside its
    ms, device ms, plain ms and bound. Returns the kernels line's entries:
    one per kernel and variant; the variants run's own (A and A' at 4
    channels, B on the general orbit at cascade 2) carry its launches, the
    others, which run only in their checks, the launches of their check."""
    from radnerf_tpu_torch.ops import (
        GridSpec, MarchConfig, get_encoder, grid_encode, march_rays, march_rays_plain,
    )

    dev = step_calls[0][1][0].device
    gen = torch.Generator(dev).manual_seed(31)
    rows = {"grid_encode": [], "grid_encode_backward": [], "march_rays": []}
    mar = []
    # a step's backward call carries its forward's points and table: the
    # step's A and A' are held on it, the eval frame's A on its own calls
    for where, calls in (("step", step_calls), ("eval", eval_calls)):
        for name, args, kw in calls:
            if name == "grid_encode_backward":
                grid_kernel_rows(rows, "path", where, *args, kw["need_x"], floor=True)
            elif name == "grid_encode" and where == "eval":
                grid_kernel_rows(rows, "path", where, *args[:2], None, *args[2:], False)
            elif name == "march_rays":  # the renderer passes the window, cull and noises by name
                mar.append(("general_cascade2", where, args, kw))
    specs = {"hashgrid": get_encoder("hashgrid")[0].spec,
             **{k: GridSpec.create(num_levels=16, desired_resolution=2048, **v)
                for k, v in VARIANT_GRIDS.items()}}
    for variant, spec in specs.items():
        D, C = spec.input_dim, spec.level_dim
        x = (torch.rand((VARIANT_POINTS, D), generator=gen, device=dev) * 2.04 - 1.02)
        table = torch.randn((spec.n_embeddings, C), generator=gen, device=dev)
        go = torch.randn((VARIANT_POINTS, spec.output_dim), generator=gen, device=dev)
        grid_kernel_rows(rows, variant, "spread", x, table, go, spec, 1.0, True, floor=True)
    _, _, m_args, m_kw = next(m for m in mar if m[1] == "eval")
    cfg2 = MarchConfig(bound=2.0, cascade=2, grid_size=m_args[5].grid_size, max_steps=16,
                       dt_gamma=m_args[5].dt_gamma)
    mar.append(("cascade2_affine", "eval", (*m_args[:5], cfg2), m_kw))

    for variant, where, args, kw in mar:
        def call(args=args, kw=kw):
            return march_rays(*args, **kw)
        def plain(args=args, kw=kw):
            return march_rays_plain(*args, **kw)
        mk, check_launches = counted("march_rays", call)
        mp = plain()
        torch.cuda.synchronize()
        cfg = args[5]
        nb, nf = march_work(*args[:4], kw["t_window"], cfg, kw.get("noises"))
        bms, by = bound_ms(nb, nf)
        differing = [k for k in ("valid", "t", "dt", "xyz", "count")
                     if not torch.equal(mk[k], mp[k])]
        rows["march_rays"].append({
            "variant": variant, "where": where, "cascade": cfg.cascade, "affine": cfg.affine,
            "noises": kw.get("noises") is not None, "check_launches": check_launches,
            "n_rays": int(args[0].shape[0]), "n_samples": int(mk["valid"].sum()),
            "bit_for_bit": not differing, "differing": differing,
            "max_abs_err": max(float((mk[k].float() - mp[k].float()).abs().max())
                               for k in ("t", "dt", "xyz")),
            "ms": cuda_ms(call, 20), "device_ms": device_ms(call, 20),
            "plain_ms": cuda_ms(plain, 3), "bound_ms": bms, "bound_by": by, "bytes": nb,
            "flops": nf})
    # what the card refuses raises before a launch: the bf16 kernels on a
    # hash grid (no packed copy, as in JAX), a hashed level at D > 7 (no
    # prime, as in JAX); 17 channels, 33 levels, 1-D and 4-D points are taken
    refused, want_refused = {}, {}
    for what, kw, dtype, refuse in (("c17", dict(level_dim=17), None, False),
                                    ("l33", dict(num_levels=33), torch.bfloat16, False),
                                    ("d4", dict(input_dim=4), None, False),
                                    ("d1", dict(input_dim=1), None, False),
                                    ("bf16_hash", dict(gridtype="hash"), torch.bfloat16, True),
                                    ("hash_d8", dict(gridtype="hash", input_dim=8), None,
                                     True)):
        spec = GridSpec.create(**{"num_levels": 4, "base_resolution": 4,
                                  "log2_hashmap_size": 8, **kw})
        x = torch.zeros((4, spec.input_dim), device=dev)
        table = torch.zeros((spec.n_embeddings, spec.level_dim), device=dev)
        try:
            grid_encode(x, table, spec, table_dtype=dtype)
            refused[what] = False
        except ValueError:
            refused[what] = True
        want_refused[what] = refuse
    torch.cuda.synchronize()
    rows["refused"] = refused
    report["variant_kernel_checks"] = rows
    emit({"phase": "variant_kernel_checks", **rows})
    if refused != want_refused:
        raise RuntimeError(f"the kernels refused {refused}, where they refuse {want_refused}")
    bad = grid_rows_wrong(rows)
    bad += [r for r in rows["march_rays"] if not r["bit_for_bit"] or r["n_samples"] == 0]
    if bad:
        raise RuntimeError(f"variant kernels differ from their plain versions: {bad}")
    if [r["variant"] for r in rows["march_rays"]].count("general_cascade2") != 2:
        raise RuntimeError("the variants step and eval frame made other march calls than B x 2")

    entries = []
    for name, kernel_rows in rows.items():
        if name == "refused":
            continue
        for variant in dict.fromkeys(r["variant"] for r in kernel_rows):
            mine = [r for r in kernel_rows if r["variant"] == variant]
            # the path's entries time the eval frame's calls (A, B) or the
            # step's (A'); the other rows stand beside them in "calls"
            path = "step" if name == "grid_encode_backward" else "eval"
            timed = [r for r in mine if r["where"] in (path, "spread")]
            bms, by = bound_ms(sum(r["bytes"] for r in timed), sum(r["flops"] for r in timed))
            # the path's variants carry the variants run's launches; the
            # others run only in their check, and carry its launches
            on_path = variant in ("path", "general_cascade2")
            entries.append({
                "name": f"{name}:{'c4_path' if variant == 'path' else variant}",
                "route": "cuda", "source": f"radnerf_tpu_torch/csrc/{name}.cu",
                "replaces": REPLACES[name],
                "launches": launches[name] if on_path else sum(r["check_launches"] for r in mine),
                "launches_in": "the variants run" if on_path else "its check only",
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": sum(r["ms"] for r in timed),
                "device_ms": sum(r["device_ms"] for r in timed),
                "plain_ms": sum(r["plain_ms"] for r in timed), "bound_ms": bms,
                "bound_by": by, "library_ms": None, "calls": mine})
    return entries


def march_variants_phase(report, root, variant_eval, variant_state):
    """march_variants: kernels B-grouped and B-bitfield, the two variants of
    B in csrc/march_rays.cu.

    On the sparse two-blob scene (``scene.build_sparse_scene``, the JAX
    package's two-level-march benchmark) and on the portrait bench scene
    (``scene.build_scene``), each at 512x512 with K = its frame's n_k_span
    rounded up to even, at most MARCH_K_CAP: the frame with march_group off
    and on, launch counts from 0 around the grouped one (B-grouped once, B
    never), image, weights_sum and depth bit for bit; B-grouped against
    its twin on the frame's rays bit for bit (t, dt, valid, xyz, count and
    the kept groups, whose sum and max are the frame's n_groups_needed and
    n_group_max), every kept group marched and group_slots = n_group_max -
    1; B and B-grouped timed in turns on those rays, each beside its bound.
    Then MARCH_GROUP_STEPS head steps with march_group on (the written
    dataset, Options defaults, K the portrait frame's), launch counts from
    0: B-grouped at every step, B never; the fixed batch's loss falls; one
    more step's recorded march held to the twin bit for bit. B-bitfield
    against its twin bit for bit on the bench frame's rays (cascade 1,
    affine) and on the variants eval frame's (``variant_eval``: cascade 2,
    the general orbit; ``variant_state``: that run's bitfield and density
    grid), without and with the float-grid cull (BITFIELD_CULL_T), timed in
    turns with B on the same rays. Then both kernels bit for bit with their
    twins, one launch each, on MARCH_ADVERSARIAL_RAYS rays of every call of
    ``studies.march.grouped_calls`` and ``bitfield_calls``. Returns the
    kernels line's two entries."""
    import radnerf_tpu_torch.models.renderer as renderer_mod
    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.models import (
        RenderConfig, RendererState, mark_untrained_grid, render_rays, update_density_grid,
    )
    from radnerf_tpu_torch.models.renderer import march_window
    from radnerf_tpu_torch.ops import (
        _kernels, march_rays, march_rays_grouped, march_rays_grouped_plain, march_rays_plain,
        near_far_from_aabb,
    )
    from radnerf_tpu_torch.ops.marching import MARCH_GROUP
    from radnerf_tpu_torch.scene import build_scene, build_sparse_scene
    from radnerf_tpu_torch.studies import march as adversarial
    from radnerf_tpu_torch.train import Trainer

    t_start = time.perf_counter()
    keys = ("valid", "t", "dt", "xyz", "count")
    scenes, grouped_rows, bitfield_rows, problems = {}, [], [], []
    path_launches = {"march_rays_grouped": 0, "march_rays": 0}

    def compare(got, want, names):
        differing = [k for k in names if not torch.equal(got[k], want[k])]
        err = max(float((got[k] - want[k]).abs().max()) for k in ("t", "dt", "xyz"))
        return differing, err

    def bitfield_rows_on(where, args, kw, mcfg, bits, grid):
        """B-bitfield against its twin and in turns with B on one call's rays."""
        o, d, nears, fars, sb = args[:5]
        window, cull = kw["t_window"], kw.get("cull_T", 0.0)
        noises = kw.get("noises")
        b_call = lambda: march_rays(o, d, nears, fars, sb, mcfg, window, cull, noises)
        for grid_cull in (False, True):
            bkw = dict(bitfield=bits, sigma_grid=grid if grid_cull else None, noises=noises)
            c = BITFIELD_CULL_T if grid_cull else 0.0
            call = lambda bkw=bkw, c=c: march_rays(o, d, nears, fars, None, mcfg, window, c,
                                                   **bkw)
            plain = lambda bkw=bkw, c=c: march_rays_plain(o, d, nears, fars, None, mcfg,
                                                          window, c, **bkw)
            got, check_launches = counted("march_rays_bitfield", call)
            want = plain()
            torch.cuda.synchronize()
            differing, err = compare(got, want, keys)
            nb, nf = march_work(o, d, nears, fars, window, mcfg, noises, bits=True)
            if grid_cull:
                nb_c, nf_c = grid_cull_work(march_rays_plain(
                    o, d, nears, fars, None, mcfg, window, 0.0, noises, bitfield=bits), mcfg)
                nb, nf = nb + nb_c, nf + nf_c
            bms, by = bound_ms(nb, nf)
            selected = int(want["count"].clamp(max=mcfg.n_sample_slots).sum())
            turns = in_turns({"march_rays": b_call, "march_rays_bitfield": call})
            bitfield_rows.append({
                "where": where, "grid_cull": grid_cull, "cull_T": c,
                "cascade": mcfg.cascade, "affine": mcfg.affine, "n_rays": int(o.shape[0]),
                "K": mcfg.n_march_iters, "S": mcfg.n_sample_slots,
                "check_launches": check_launches, "bit_for_bit": not differing,
                "differing": differing, "max_abs_err": err,
                "n_samples": int(want["valid"].sum()), "dropped_by_grid_cull":
                    selected - int(want["valid"].sum()),
                "ms": cuda_ms(call, 20), "device_ms": turns["march_rays_bitfield"],
                "march_rays_device_ms_in_turns": turns["march_rays"],
                "plain_ms": cuda_ms(plain, 3), "bound_ms": bms, "bound_by": by,
                "bytes": nb, "flops": nf})

    for name, build in (("sparse", build_sparse_scene), ("portrait", build_scene)):
        net, rc, state, b, auds = build(TRAIN_SIZE, TRAIN_SIZE, device="cuda")

        def frame(rc_):
            return render_rays(net, rc_, state, b["rays_o"], b["rays_d"], auds[0],
                               b["bg_coords"], b["poses"], b["eye"], b["index"],
                               b["bg_color"])[0]

        span = int(frame(rc)["n_k_span"])
        K = min(MARCH_K_CAP, span + span % 2)
        rc_d = dataclasses.replace(rc, march_iters=K)
        rc_g = dataclasses.replace(rc_d, march_group=True)
        dense = frame(rc_d)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        grouped = frame(rc_g)
        torch.cuda.synchronize()
        launches = _kernels.launches()
        for k in path_launches:
            path_launches[k] += launches[k]
        tel = {k: int(v) for k, v in grouped.items() if k.startswith("n_")}
        equal = {k: bool(torch.equal(dense[k], grouped[k]))
                 for k in ("image", "weights_sum", "depth")}

        mcfg = rc_g.march_config()
        o, d = b["rays_o"], b["rays_d"]
        nears, fars = near_far_from_aabb(o, d, o.new_tensor(rc.aabb), rc.min_near)
        window = march_window(state, o, d, nears, fars)
        Kg = -(-K // MARCH_GROUP)
        g_args = (o, d, nears, fars, state.sigma_bytes, state.coarse_bytes, mcfg, window)
        for slots in (Kg, max(tel["n_group_max"] - 1, 0)):
            call = lambda slots=slots: march_rays_grouped(*g_args, slots, rc.cull_T)
            plain = lambda slots=slots: march_rays_grouped_plain(*g_args, slots, rc.cull_T)
            got, check_launches = counted("march_rays_grouped", call)
            want = plain()
            torch.cuda.synchronize()
            differing, err = compare(got, want, keys + ("groups",))
            row = {"scene": name, "group_slots": slots, "K": K, "groups": Kg,
                   "check_launches": check_launches, "bit_for_bit": not differing,
                   "differing": differing, "max_abs_err": err,
                   "n_samples": int(got["valid"].sum()),
                   "n_groups_needed": int(got["groups"].sum()),
                   "n_group_max": int(got["groups"].max()),
                   "twin_n_groups_needed": int(want["groups"].sum()),
                   "twin_n_group_max": int(want["groups"].max())}
            if slots == Kg:  # the frame's own call: timed in turns with B
                b_call = lambda: march_rays(o, d, nears, fars, state.sigma_bytes, mcfg,
                                            window, rc.cull_T)
                turns = in_turns({"march_rays": b_call, "march_rays_grouped": call})
                nb, nf = march_grouped_work(g_args, slots, rc.cull_T)
                bms, by = bound_ms(nb, nf)
                nb_b, nf_b = march_work(o, d, nears, fars, window, mcfg)
                row.update(ms=cuda_ms(call, 20), device_ms=turns["march_rays_grouped"],
                           march_rays_device_ms_in_turns=turns["march_rays"],
                           march_rays_bound_ms=bound_ms(nb_b, nf_b)[0],
                           plain_ms=cuda_ms(plain, 3), bound_ms=bms, bound_by=by,
                           bytes=nb, flops=nf)
            else:
                row["truncated_rays"] = int((want["groups"] > slots).sum())
            grouped_rows.append(row)
        full = grouped_rows[-2]
        scenes[name] = {"K": K, "n_k_span": span, "groups": Kg, "frame_bit_for_bit": equal,
                        "launches": {k: launches[k] for k in path_launches},
                        "telemetry": tel, "samples_dense": int(dense["n_samples_needed"])}
        emit({"phase": "march_variants_scene", "scene": name, **scenes[name]})
        if not all(equal.values()):
            problems.append(f"{name}: the grouped frame differs from the dense one: {equal}")
        if launches["march_rays_grouped"] != 1 or launches["march_rays"] != 0:
            problems.append(f"{name}: the grouped frame launched {launches}")
        if (full["n_groups_needed"], full["n_group_max"]) != \
                (tel["n_groups_needed"], tel["n_group_max"]) or tel["n_groups_needed"] == 0:
            problems.append(f"{name}: groups {full} against the frame's telemetry {tel}")
        if grouped_rows[-1]["truncated_rays"] == 0:
            problems.append(f"{name}: group_slots {grouped_rows[-1]['group_slots']} truncates "
                            "no ray")
        if name == "portrait":  # B-bitfield on the bench frame's rays
            bitfield_rows_on("bench_frame", (o, d, nears, fars, state.sigma_bytes),
                             {"t_window": window, "cull_T": rc.cull_T}, rc.march_config(),
                             state.density_bitfield, state.density_grid)
            portrait_K = K
        del net, state, b, auds, dense, grouped
        torch.cuda.empty_cache()

    # B-bitfield at cascade 2 on the general orbit: the variants eval frame
    m_args, m_kw = variant_eval
    bitfield_rows_on("variants_eval", m_args, m_kw, m_args[5],
                     variant_state.density_bitfield, variant_state.density_grid)

    # both kernels on the adversarial calls, bit for bit with their twins
    # (every output, zero in every unused slot)
    adversarial_rows = []
    for kernel, calls, fn, plain in (
            ("march_rays_grouped", adversarial.grouped_calls, march_rays_grouped,
             march_rays_grouped_plain),
            ("march_rays_bitfield", adversarial.bitfield_calls, march_rays, march_rays_plain)):
        for name, args, kw in calls("cuda", MARCH_ADVERSARIAL_RAYS):
            got, check_launches = counted(kernel, lambda: fn(*args, **kw))
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            names = keys + (("groups",) if kernel == "march_rays_grouped" else ())
            differing, err = compare(got, want, names)
            S_ = want["valid"].shape[1]
            adversarial_rows.append({
                "kernel": kernel, "call": name, "n_rays": int(args[0].shape[0]),
                "check_launches": check_launches, "bit_for_bit": not differing,
                "differing": differing, "max_abs_err": err,
                "n_samples": int(want["valid"].sum()),
                "rays_over_S": int((want["count"] > S_).sum())})
    emit({"phase": "march_variants_adversarial", "calls": adversarial_rows})
    if not all(r["bit_for_bit"] and r["check_launches"] == 1 for r in adversarial_rows):
        problems.append(f"adversarial calls: {adversarial_rows}")

    # the head steps with march_group on
    opt = Options(path=root, exp_eye=True, preload=2)
    ds = TalkingHeadDataset(opt, split="train", device="cuda")
    dev = ds.device
    rc = dataclasses.replace(RenderConfig.from_options(opt), march_group=True,
                             march_iters=portrait_K)
    tr = Trainer(opt, render_cfg=rc, device=dev)
    fixed = tr.next_batch(ds, 0)
    fixed_noises = torch.rand(opt.num_rays, generator=torch.Generator(dev).manual_seed(123),
                              device=dev)
    with torch.no_grad():
        probe = update_density_grid(
            tr.net, rc, mark_untrained_grid(rc, RendererState.create(rc, device=dev), ds.poses,
                                            ds.intrinsics),
            tr.net.encode_audio(ds.audio_window(0)), fixed["eye"],
            generator=torch.Generator(dev).manual_seed(7))
        loss_0 = float(tr.loss(fixed, fixed_noises, 0, state=probe)[0])
    torch.cuda.synchronize()
    _kernels.reset_launches()
    tr.train(ds, max_epochs=MARCH_GROUP_STEPS // len(ds))
    torch.cuda.synchronize()
    launches = _kernels.launches()
    for k in path_launches:
        path_launches[k] += launches[k]
    with torch.no_grad():
        loss_end = float(tr.loss(fixed, fixed_noises, 0)[0])
    losses, n_steps = list(tr.stats["step_loss"]), tr.global_step
    tel = {k: int(v) for k, v in tr.telemetry.items()}
    with recorded_calls([(renderer_mod, "march_rays_grouped")]) as calls:
        tr.step(ds, ds.epoch_indices()[0])
    torch.cuda.synchronize()
    (_, s_args, s_kw), = calls
    got, step_check_launches = counted("march_rays_grouped",
                                       lambda: march_rays_grouped(*s_args, **s_kw))
    want = march_rays_grouped_plain(*s_args, **s_kw)
    torch.cuda.synchronize()
    differing, err = compare(got, want, keys + ("groups",))
    steps = {"steps": n_steps, "K": portrait_K, "launches": launches,
             "loss_first": losses[0], "loss_last": losses[-1],
             "fixed_batch_loss_step0": loss_0, "fixed_batch_loss_end": loss_end,
             "telemetry_last_step": tel,
             "step_march": {"n_rays": int(s_args[0].shape[0]),
                            "noises": s_args[10] is not None,
                            "group_slots": s_args[8], "check_launches": step_check_launches,
                            "bit_for_bit": not differing, "differing": differing,
                            "max_abs_err": err, "n_samples": int(got["valid"].sum())}}
    if launches["march_rays_grouped"] != MARCH_GROUP_STEPS or launches["march_rays"] != 0:
        problems.append(f"the grouped head steps launched {launches}")
    if n_steps != MARCH_GROUP_STEPS or len(losses) != MARCH_GROUP_STEPS or \
            not all(math.isfinite(v) for v in losses):
        problems.append(f"the grouped head steps' losses {losses}")
    if not loss_end < loss_0:
        problems.append(f"the fixed batch's loss did not fall: {loss_0} -> {loss_end}")
    if differing or s_args[10] is None or not tel.get("n_groups_needed"):
        problems.append(f"the grouped step's march {steps['step_march']}, telemetry {tel}")
    del tr, ds
    torch.cuda.empty_cache()

    bad = [r for r in grouped_rows + bitfield_rows if not r["bit_for_bit"]]
    bad += [r for r in grouped_rows if r["n_samples"] == 0]
    bad += [r for r in bitfield_rows if r["n_samples"] == 0 or
            (r["where"] == "bench_frame" and r["grid_cull"] and r["dropped_by_grid_cull"] == 0)]
    mv = {"scenes": scenes, "grouped": grouped_rows, "bitfield": bitfield_rows,
          "adversarial": adversarial_rows, "grouped_head_steps": steps,
          "path_launches": path_launches, "seconds": time.perf_counter() - t_start}
    report["march_variants"] = {**mv, "grouped_head_steps": {**steps, "step_losses": losses}}
    emit({"phase": "march_variants", **mv})
    if bad:
        problems.append(f"kernels differ from their twins or marched nothing: {bad}")
    if problems:
        raise RuntimeError(f"march_variants: {problems}")

    entries = []
    for name, rows, launches_in in (
            ("march_rays_grouped", [r for r in grouped_rows if "device_ms" in r],
             "the march_variants frames and head steps"),
            ("march_rays_bitfield", [r for r in bitfield_rows if r["grid_cull"]],
             "its check only")):
        every = grouped_rows if name == "march_rays_grouped" else bitfield_rows
        bms, by = bound_ms(sum(r["bytes"] for r in rows), sum(r["flops"] for r in rows))
        entries.append({
            "name": name, "route": "cuda", "source": "radnerf_tpu_torch/csrc/march_rays.cu",
            "replaces": REPLACES[name],
            "launches": (path_launches[name] if name == "march_rays_grouped"
                         else sum(r["check_launches"] for r in every)),
            "launches_in": launches_in,
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": sum(r["ms"] for r in rows), "device_ms": sum(r["device_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": bms, "bound_by": by,
            "library_ms": None, "calls": rows})
    return entries


def capacity_phase(report, out_dir, root, smi):
    """capacity: the trainer's adaptive capacities (``train/capacity.py``)
    on the card. Measured only: the times stand beside the card's name and
    power limit (``smi``) and claim nothing.

    Three head-stage runs through ``train`` on the written directory at the
    ``Options`` defaults (``auto_capacity`` on) but an upkeep every
    CAP_UPKEEP steps, CAP_EPOCHS epochs, launch counts from 0, K, S and the
    group slots recorded at each upkeep (those after an epoch's first step
    adapt) with JAX's log lines: "defaults", from scratch; "march_group",
    the same with ``march_group`` on: B at the steps before the first
    adaptation, B-grouped at every step after it, once K <= MARCH_K_CAP;
    "warm", a trainer resumed at step 1 on the bench scene's occupancy (the
    head the directory's frames were rendered from) with an untrained
    field: K and S shrink to that head at the first adapting upkeep, and
    later ones follow the samples as training adds them (at least two
    adaptations). B (bit for bit), C and C' against
    their plain versions on the calls of the warm run's first step after
    its first adaptation. The head step on the scene's occupancy at the
    default lattice and at that adapted one, one batch, fenced and
    profiled in turns. The 512x512 bench frame at the lattice
    ``fresh_render_config`` sizes (JAX bench.py's two fresh passes at
    headroom 1.1), with and without ``march_group``, against the default
    lattice's frame: bit for bit, A, B (or B-grouped) and C launched, A, B
    and C against their plain versions on its calls; each frame fenced and
    profiled in turns."""
    import radnerf_tpu_torch.models.renderer as renderer_mod
    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.models import (
        RenderConfig, graph_stats, render_rays, reset_graph_stats,
    )
    from radnerf_tpu_torch.ops import (
        _kernels, composite_rays, composite_rays_backward, composite_rays_backward_plain,
        composite_rays_plain, march_rays, march_rays_plain,
    )
    from radnerf_tpu_torch.scene import build_scene
    from radnerf_tpu_torch.train import Trainer
    from radnerf_tpu_torch.train.capacity import fresh_render_config

    t_start = time.perf_counter()
    problems = []
    net, scene_rc, scene_state, b, auds = build_scene(512, 512, device="cuda")

    def copy_state(st):
        return dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                          for f in dataclasses.fields(st)})

    def lattice(rc):
        mcfg = rc.march_config()
        return {"K": mcfg.n_march_iters, "S": mcfg.n_sample_slots,
                "group_slots": rc.march_group_slots, "march_group": rc.march_group,
                "ray_capacity_frac": rc.ray_capacity_frac,
                "sample_capacity_mult": rc.sample_capacity_mult}

    def busy_ms(fn, reps=PROFILED_STEPS):
        _, events = device_profile(fn, reps)
        return sum(e.self_device_time_total for e in events) / reps / 1e3

    def adaptive_run(name, group=False, warm=False):
        """A head trainer at the defaults through ``train``; returns (the
        trainer, its dataset, the run's record, the march and composite
        calls of its first step after its first adaptation)."""
        opt = Options(path=root, exp_eye=True, preload=2, update_extra_interval=CAP_UPKEEP)
        ds = TalkingHeadDataset(opt, split="train", device="cuda")
        rc = dataclasses.replace(RenderConfig.from_options(opt), march_group=group)
        tr = Trainer(opt, render_cfg=rc, device=ds.device)
        if warm:
            tr.state, tr.global_step = copy_state(scene_state), 1
        lines, upkeeps, calls = [], [], []
        tr.log = lines.append

        def recording_upkeep(dataset):
            n = _kernels.launches()
            upkeeps.append({"step": tr.global_step, "adaptations": tr._adapt_count,
                            **lattice(tr.render_cfg),
                            "launches_before": {k: n[k] for k in ("march_rays",
                                                                  "march_rays_grouped")}})
            Trainer.update_extra_state(tr, dataset)

        def recording_step(batch):
            if calls or tr._adapt_count == 0:
                return Trainer.train_step(tr, batch)
            with recorded_calls([(renderer_mod, "march_rays"),
                                 (renderer_mod, "composite_rays")]) as got:
                loss = Trainer.train_step(tr, batch)
            calls.extend(got)
            return loss

        tr.update_extra_state, tr.train_step = recording_upkeep, recording_step
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        tr.train(ds, max_epochs=CAP_EPOCHS)
        torch.cuda.synchronize()
        del tr.update_extra_state, tr.train_step  # the class's own again
        run = {"run": name, "march_group": group, "steps": tr.global_step - int(warm),
               "seconds": time.perf_counter() - t0, "launches": _kernels.launches(),
               "adaptations": tr._adapt_count, "upkeeps": upkeeps,
               "default": lattice(rc), "final": lattice(tr.render_cfg),
               "log": [l for l in lines if l.startswith(("[INFO] adapt", "==> Finished Epoch",
                                                         "[WARN]"))],
               "telemetry_last_step": {k: int(v) for k, v in tr.telemetry.items()}}
        emit({"phase": f"capacity_{name}", **run})
        for kernel in TRAIN_KERNELS:
            if run["launches"][kernel] <= 0:
                problems.append(f"{name}: kernel {kernel} was not launched")
        if not all(math.isfinite(v) for v in tr.stats["step_loss"]):
            problems.append(f"{name}: losses {tr.stats['step_loss']}")
        if tr._adapt_count < 1 or not run["final"]["K"] < run["default"]["K"]:
            problems.append(f"{name}: no adaptation narrowed the orbit: {run['final']}")
        return tr, ds, run, calls

    # ---- the defaults, from scratch
    tr, ds, run_d, _ = adaptive_run("defaults")
    del tr, ds
    torch.cuda.empty_cache()

    # ---- march_group on: B-grouped once the adapted K qualifies it
    tr, ds, run_g, _ = adaptive_run("march_group", group=True)
    first = next((u for u in run_g["upkeeps"] if u["adaptations"] >= 1), None)
    launches_g = run_g["launches"]
    if first is None or first["K"] > MARCH_K_CAP:
        problems.append(f"march_group: the lattice after the first adaptation {first}")
    elif (launches_g["march_rays"], launches_g["march_rays_grouped"]) != \
            (first["step"], run_g["steps"] - first["step"]):
        problems.append(f"march_group: launches {launches_g}, the first adaptation at step "
                        f"{first['step']} of {run_g['steps']}")
    if run_g["adaptations"] < 2 or not run_g["telemetry_last_step"].get("n_groups_needed"):
        problems.append(f"march_group: {run_g['adaptations']} adaptations, telemetry "
                        f"{run_g['telemetry_last_step']}")
    del tr, ds
    torch.cuda.empty_cache()

    # ---- warm: the scene's occupancy, then the untrained field's
    tr, ds, run_w, calls = adaptive_run("warm", warm=True)
    adapted = [u for u in run_w["upkeeps"] if u["adaptations"] >= 1]
    shrunk = adapted[0] if adapted else None
    if run_w["adaptations"] < 2 or shrunk is None or \
            not shrunk["S"] < run_w["default"]["S"]:
        problems.append(f"warm: {run_w['adaptations']} adaptations, upkeeps {run_w['upkeeps']}")

    # B, C and C' on the calls of the warm run's first adapted step
    (_, m_args, m_kw), = [c for c in calls if c[0] == "march_rays"]
    (_, c_args, c_kw), = [c for c in calls if c[0] == "composite_rays"]
    mk, mp = march_rays(*m_args, **m_kw), march_rays_plain(*m_args, **m_kw)
    differing = [k for k in ("valid", "t", "dt", "xyz", "count") if not torch.equal(mk[k], mp[k])]
    c_in = (*c_args, c_kw["ambient"])
    outs = composite_rays(*c_in, T_thresh=c_kw["T_thresh"])
    outs_p = composite_rays_plain(*c_in, T_thresh=c_kw["T_thresh"])
    gen = torch.Generator(ds.device).manual_seed(9)
    N = c_args[0].shape[0]
    grads = {k: torch.randn((N, 3) if k == "image" else (N,), generator=gen, device=ds.device)
             for k in ("image", "depth", "weights_sum", "ambient_sum")}
    ck = composite_rays_backward(*c_in, grads, outs, T_thresh=c_kw["T_thresh"])
    cp = composite_rays_backward_plain(*c_in, grads, T_thresh=c_kw["T_thresh"])
    torch.cuda.synchronize()
    checks = {
        "march_rays": {"n_rays": int(m_args[0].shape[0]), "noises": m_kw.get("noises") is not None,
                       "K": m_args[5].n_march_iters, "S": int(mk["valid"].shape[1]),
                       "n_samples": int(mk["valid"].sum()),
                       "rays_over_S": int((mk["count"] > mk["valid"].shape[1]).sum()),
                       "bit_for_bit": not differing, "differing": differing},
        "composite_rays": {"shape": list(c_args[4].shape), "tol": TOL_COMPOSITE,
                           "max_abs_err": max(float((outs[k] - outs_p[k]).abs().max())
                                              for k in outs)},
        "composite_rays_backward": {"tol_rel": TOL_BACKWARD_REL, "grads": {
            name: {"rel_err": rel_err(a, b_), "max_abs_err": float((a - b_).abs().max())}
            for name, a, b_ in zip(("sigmas", "rgbs", "ambient"), ck, cp)}},
    }
    emit({"phase": "capacity_kernel_checks", **checks})
    if differing or m_kw.get("noises") is None or shrunk is None or \
            (checks["march_rays"]["K"], checks["march_rays"]["S"]) != (shrunk["K"], shrunk["S"]) \
            or checks["march_rays"]["n_samples"] == 0:
        problems.append(f"B at the adapted lattice: {checks['march_rays']}")
    if not checks["composite_rays"]["max_abs_err"] <= TOL_COMPOSITE:
        problems.append(f"C at the adapted lattice: {checks['composite_rays']}")
    if not max(g["rel_err"] for g in checks["composite_rays_backward"]["grads"].values()) \
            <= TOL_BACKWARD_REL:
        problems.append(f"C' at the adapted lattice: {checks['composite_rays_backward']}")

    # the head step on the scene's occupancy, default and adapted lattices
    batch = tr.next_batch(ds, 1)
    tr.state = copy_state(scene_state)
    default = RenderConfig.from_options(tr.opt)
    small = dataclasses.replace(default, march_iters=shrunk["K"], sample_slots=shrunk["S"])

    def step_at(rc):
        def step(i):
            tr.render_cfg = rc
            tr.train_step(batch)
        return step

    fenced = {"default": [], "adapted": []}
    busy = {"default": [], "adapted": []}
    for name in ("default", "adapted", "adapted", "default"):
        rc = default if name == "default" else small
        fenced[name] += fenced_ms(step_at(rc), CAP_TIMED)
        busy[name].append(busy_ms(step_at(rc)))
    step_t = {name: {"lattice": lattice(default if name == "default" else small),
                     "fenced_ms_median": float(np.median(fenced[name])),
                     "device_busy_ms": float(np.mean(busy[name])),
                     "device_busy_ms_turns": busy[name]} for name in fenced}
    step_t["telemetry"] = {k: int(v) for k, v in tr.telemetry.items()}
    emit({"phase": "capacity_step_timing", "card": smi, **step_t})
    del tr, ds, batch, calls, mk, mp, outs, outs_p, ck, cp
    torch.cuda.empty_cache()

    # ---- the bench frame at the fresh lattice against the default lattice
    def frame(rc_):
        return render_rays(net, rc_, scene_state, b["rays_o"], b["rays_d"], auds[0],
                           b["bg_coords"], b["poses"], b["eye"], b["index"], b["bg_color"])[0]

    def telemetry(rc_):
        return {k: int(v) for k, v in frame(rc_).items() if k.startswith("n_")}

    n, radius = int(b["rays_o"].shape[0]), float(scene_state.occ_sphere[3])
    frames = {"default": scene_rc,
              "fresh": fresh_render_config(scene_rc, telemetry, n, radius),
              "fresh_march_group": fresh_render_config(
                  dataclasses.replace(scene_rc, march_group=True), telemetry, n, radius)}
    base = frame(scene_rc)
    frame_rows = {}
    for name, rc_ in frames.items():
        torch.cuda.synchronize()
        _kernels.reset_launches()
        reset_graph_stats()
        got = frame(rc_)
        torch.cuda.synchronize()
        launches, graphs = {k: v for k, v in _kernels.launches().items() if v}, graph_stats()
        equal = {k: bool(torch.equal(got[k], base[k]))
                 for k in ("image", "depth", "weights_sum", "torso_alpha")}
        march = "march_rays_grouped" if rc_.march_group else "march_rays"
        frame_rows[name] = {"lattice": lattice(rc_), "launches": launches, "graphs": graphs,
                            "bit_for_bit_with_default": equal,
                            "telemetry": {k: int(v) for k, v in got.items()
                                          if k.startswith("n_")}}
        if not all(equal.values()):
            problems.append(f"the {name} frame differs from the default lattice's: {equal}")
        # march, torso, composite: the torso on
        ran = {k: frames_ran(k, launches, graphs, 3) for k in (march, "composite_rays")}
        if ran != {march: 1, "composite_rays": 1} or launches.get("grid_encode", 0) != 3:
            problems.append(f"the {name} frame launched {launches}, graphs {graphs}")
        if name != "default":
            checks_f = frame_kernel_checks(lambda rc_=rc_: frame(rc_), {
                "grid_encode": 3, "march_rays": 0 if rc_.march_group else 1,
                "composite_rays": 1})
            frame_rows[name]["kernel_checks"] = checks_f
            if not all(r["ok"] for rows in checks_f.values() for r in rows):
                problems.append(f"the {name} frame's kernels differ: {checks_f}")
    fenced = {name: [] for name in frames}
    busy = {name: [] for name in frames}
    for name in list(frames) + list(frames)[::-1]:
        fenced[name] += fenced_ms(lambda i, rc_=frames[name]: frame(rc_), 10)
        busy[name].append(busy_ms(lambda i, rc_=frames[name]: frame(rc_)))
    for name in frames:
        frame_rows[name].update(fenced_ms_median=float(np.median(fenced[name])),
                                device_busy_ms=float(np.mean(busy[name])),
                                device_busy_ms_turns=busy[name])
    emit({"phase": "capacity_frame", "card": smi, **frame_rows})
    del net, scene_state, b, auds, base
    torch.cuda.empty_cache()

    report["capacity"] = {"card": smi, "runs": [run_d, run_g, run_w], "kernel_checks": checks,
                          "step_timing": step_t, "frame": frame_rows,
                          "seconds": time.perf_counter() - t_start}
    emit({"phase": "capacity", "seconds": report["capacity"]["seconds"],
          **{f"{r['run']}_lattices": [(u["step"], u["K"], u["S"], u["group_slots"])
                                       for u in r["upkeeps"]] for r in (run_d, run_g, run_w)},
          "problems": problems})
    if problems:
        raise RuntimeError(f"capacity: {problems}")


def counted(name, fn):
    """(fn(), the launches of kernel ``name`` that call made)."""
    from radnerf_tpu_torch.ops import _kernels

    before = _kernels.KERNELS[name].launches
    out = fn()
    return out, _kernels.KERNELS[name].launches - before


def eval_kernel_checks(tr, batch):
    """Kernels A, B and C against their plain versions on the inputs one
    eval frame (``tr.eval_step(batch)``) gives them (``frame_kernel_checks``)."""
    return frame_kernel_checks(lambda: tr.eval_step(batch), {"grid_encode": 2, "march_rays": 1,
                                                             "composite_rays": 1})


def frame_kernel_checks(render, want_calls):
    """The grid encodes (A, or A-bf16 under the bf16 policy), B and C
    against their plain versions on the inputs one frame (``render()``)
    gives them, at phase 4's tolerances (A-bf16 within 1 bf16 ulp, as in
    bf16_kernel_checks): the calls are recorded by wrappers around the model
    modules' bindings, their tensors cloned as passed (an EMA is in the
    network only while the frame renders). ``want_calls``: the calls of each
    the frame must make. Each result row carries ``ok``."""
    import radnerf_tpu_torch.models.network as network_mod
    import radnerf_tpu_torch.models.renderer as renderer_mod
    from radnerf_tpu_torch.ops import (
        composite_rays, composite_rays_plain, grid_encode, grid_encode_plain, march_rays,
        march_rays_plain,
    )

    with recorded_calls([(network_mod, "grid_encode"), (renderer_mod, "march_rays"),
                         (renderer_mod, "composite_rays")]) as calls:
        render()

    out = {"grid_encode": [], "march_rays": [], "composite_rays": []}
    for name, args, kw in calls:
        if name == "grid_encode":
            gk, gp = grid_encode(*args, **kw), grid_encode_plain(*args, **kw)
            row = {"n_points": int(args[0].shape[0]), "D": int(args[0].shape[1]),
                   "dtype": str(gk.dtype).replace("torch.", ""),
                   "max_abs_err": float((gk.float() - gp.float()).abs().max()),
                   "bit_for_bit": bool(torch.equal(gk, gp))}
            if gk.dtype == torch.bfloat16:
                row["max_err_ulps"], row["elements_differing"] = bf16_ulp_err(gk, gp)
                row["ok"] = row["max_err_ulps"] <= 1.0
            else:
                row["tol"] = TOL_GRID
                row["ok"] = row["max_abs_err"] <= TOL_GRID
        elif name == "march_rays":
            mk, mp = march_rays(*args, **kw), march_rays_plain(*args, **kw)
            both = mk["valid"] & mp["valid"]
            row = {
                "n_rays": int(args[0].shape[0]), "n_samples": int(mk["valid"].sum()),
                "max_abs_err": max(float((mk[k] - mp[k]).abs()[both].max())
                                   for k in ("t", "dt", "xyz")), "tol": TOL_MARCH,
                "rays_differing": int(((mk["valid"] != mp["valid"]).any(dim=1)
                                       | (mk["count"] != mp["count"])).sum()),
                "nonzero_unused_slot_values": sum(
                    int((m[k] != 0).reshape(*m["valid"].shape, -1)[~m["valid"]].sum())
                    for m in (mk, mp) for k in ("t", "dt", "xyz"))}
            row["ok"] = (row["max_abs_err"] <= TOL_MARCH and row["rays_differing"] == 0
                         and row["nonzero_unused_slot_values"] == 0)
        else:
            ck, cp = composite_rays(*args, **kw), composite_rays_plain(*args, **kw)
            valid = args[4]
            row = {"shape": list(valid.shape), "n_valid": int(valid.sum()),
                   "max_abs_err": max(float((ck[k] - cp[k]).abs().max()) for k in ck),
                   "tol": TOL_COMPOSITE}
            row["ok"] = row["max_abs_err"] <= TOL_COMPOSITE
        out[name].append(row)
    torch.cuda.synchronize()
    if {k: len(v) for k, v in out.items()} != want_calls:
        raise RuntimeError(f"the frame made other kernel calls than {want_calls}: "
                           f"{ {k: len(v) for k, v in out.items()} }")
    return out


# ---------------------------------------------------------------------------
# the bf16 policy (-O)

def ernerf_phase(report):
    """ernerf: ER-NeRF's bench frame (the module docstring). Returns the
    kernels line's entry of A-tri."""
    import radnerf_tpu_torch.models.network_triplane as tri
    from radnerf_tpu_torch.models import graph_stats, render_rays, reset_graph_stats
    from radnerf_tpu_torch.ops import _kernels, triplane_encode, triplane_encode_plain
    from radnerf_tpu_torch.scene import build_scene

    t0 = time.perf_counter()
    net, rc, state, b, auds = build_scene(512, 512, device="cuda", arch="ernerf")

    def frame(i):
        with torch.no_grad():
            return render_rays(net, rc, state, b["rays_o"], b["rays_d"],
                               auds[i % auds.shape[0]], b["bg_coords"], b["poses"], b["eye"],
                               b["index"], b["bg_color"], poses_matrix=b["poses_matrix"])[0]

    with recorded_calls([(tri, "triplane_encode")]) as calls:
        frame(0)
    if len(calls) != 1:
        raise RuntimeError(f"ernerf: an eager frame called A-tri {len(calls)} times")
    x, tables, spec, bound = calls[0][1]
    got = triplane_encode(x, tables, spec, bound)
    plain = triplane_encode_plain(x, tables, spec, bound)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, plain))

    torch.cuda.synchronize()
    _kernels.reset_launches()
    reset_graph_stats()
    for i in range(ERNERF_FRAMES):
        res = frame(i)
    torch.cuda.synchronize()
    launches, graphs = {k: v for k, v in _kernels.launches().items() if v}, graph_stats()
    ran = {"triplane_encode": launches.get("triplane_encode", 0),
           "grid_encode": launches.get("grid_encode", 0),
           **{k: frames_ran(k, launches, graphs, 3) for k in ("march_rays", "composite_rays")}}

    nb, nf = triplane_work(x, spec, bound)
    bms, by = bound_ms(nb, nf)
    entry = {"name": "triplane_encode", "route": "cuda",
             "source": "radnerf_tpu_torch/csrc/grid_encode.cu",
             "replaces": REPLACES["triplane_encode"], "launches": launches.get("triplane_encode"),
             "max_abs_err": float((got - plain).abs().max()),
             "ms": cuda_ms(lambda: triplane_encode(x, tables, spec, bound), 20),
             "device_ms": device_ms(lambda: triplane_encode(x, tables, spec, bound), 20),
             "plain_ms": cuda_ms(lambda: triplane_encode_plain(x, tables, spec, bound), 3),
             "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf, "library_ms": None}
    report["ernerf"] = {
        "points": int(x.shape[0]), "features": list(got.shape), "bit_for_bit": equal,
        "frames": ERNERF_FRAMES, "launches": launches, "graphs": graphs, "frames_ran": ran,
        "image_finite": bool(torch.isfinite(res["image"]).all()),
        "weights_sum_max": float(res["weights_sum"].max()),
        "torso_alpha_max": float(res["torso_alpha"].max()),
        "seconds": time.perf_counter() - t0,
        **{k: entry[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}}
    emit({"phase": "ernerf", **report["ernerf"]})
    if not equal:
        raise RuntimeError(f"ernerf: A-tri differs from its plain twin by "
                           f"{entry['max_abs_err']} on {x.shape[0]} points")
    if ran != {k: ERNERF_FRAMES for k in ran} or set(launches) - set(ran):
        raise RuntimeError(f"ernerf: {ERNERF_FRAMES} frames launched {launches}, "
                           f"graphs {graphs}")
    if not report["ernerf"]["image_finite"] or not report["ernerf"]["weights_sum_max"] > 0.05:
        raise RuntimeError(f"ernerf: the frame is not finite or the head is invisible: "
                           f"{report['ernerf']}")
    return entry


def frames_ran(name, launches, graphs, segments):
    """The frames that ran kernel ``name`` (B, B-grouped or C, which a
    captured frame replays from its segments) since ``launches`` and
    ``graphs`` (``graph_stats()``) were zeroed: the host's launches count an
    eager frame's once and a capturing frame's twice (its warm-up, and the
    capture, which records them), and each frame replayed from its
    ``segments`` graphs launches none."""
    return launches.get(name, 0) + (graphs["replays"] - 2 * graphs["captures"]) // segments


@contextlib.contextmanager
def recorded_calls(bindings):
    """While the block runs, each (module, name) of ``bindings`` records its
    calls into the yielded list as (name, args, kwargs), tensors cloned as
    passed (a module's own binding: the model modules bind the wrappers at
    import). Frames render eagerly meanwhile: a replayed frame graph makes
    no Python call, and a capture's calls hold no values yet (the graphed
    frame is held to the eager one by tests/test_torch_frame_graph.py)."""
    from radnerf_tpu_torch.models import frame_graph

    def clone(v):
        if torch.is_tensor(v):
            return v.detach().clone()
        return tuple(clone(x) for x in v) if isinstance(v, tuple) else v

    calls = []
    bindings = [*bindings, (frame_graph, "engages")]
    originals = [getattr(mod, name) for mod, name in bindings]
    for (mod, name), fn in zip(bindings[:-1], originals):
        def recording(*args, _name=name, _fn=fn, **kw):
            calls.append((_name, clone(args), {k: clone(v) for k, v in kw.items()}))
            return _fn(*args, **kw)
        setattr(mod, name, recording)
    frame_graph.engages = lambda rays_o: False
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(bindings, originals):
            setattr(mod, name, fn)


def bf16_ulp_err(got, want):
    """(largest |got - want| in bf16 ulps of the larger magnitude, the count
    of elements that differ)."""
    a, b = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs())
                                            .clamp_min(2.0**-126))) - 7)
    return float(((a - b).abs() / ulp).max()), int((a != b).sum())


def in_turns(fns, reps=20):
    """``device_ms`` of each fn in the order a, b, b, a: {name: mean}."""
    names = list(fns)
    got = {n: [] for n in names}
    for n in names + names[::-1]:
        got[n].append(device_ms(fns[n], reps))
    return {n: float(np.mean(v)) for n, v in got.items()}


def kernel_class_ms(events, reps, needle):
    """Device ms per rep of the profiled kernels whose name holds ``needle``."""
    return sum(e.self_device_time_total for e in events if needle in e.key) / reps / 1e3


def bf16_frame_phase(report, out_dir, scene, auds):
    """bf16_frame: phase 3's 512x512 head+torso frame under -O (the same
    weights in a ``compute_dtype="bfloat16"`` network) with launch counts
    from 0: A-bf16 three times, the float32 A never; its PSNR against the
    float32 frame; both frames fenced (15 each, in turns) and profiled (3
    each): device ms, by class (GEMMs, `cat`, kernel A). Returns the bf16
    frame's recorded grid-encode calls."""
    import radnerf_tpu_torch.models.network as network_mod
    from radnerf_tpu_torch.models import NeRFNetwork, render_rays
    from radnerf_tpu_torch.ops import _kernels

    net, rc, state, b = scene
    net16 = NeRFNetwork(dataclasses.replace(net.cfg, compute_dtype="bfloat16"),
                        device=b["rays_o"].device)
    net16.load_state_dict(net.state_dict())

    def frame(n, aud):
        return render_rays(n, rc, state, b["rays_o"], b["rays_d"], aud, b["bg_coords"],
                           b["poses"], b["eye"], b["index"], b["bg_color"])[0]

    ref = frame(net, auds[0])
    torch.cuda.synchronize()
    _kernels.reset_launches()
    with recorded_calls([(network_mod, "grid_encode")]) as calls:
        res = frame(net16, auds[0])
    torch.cuda.synchronize()
    launches = _kernels.launches()
    fenced = {"float32": [], "bfloat16": []}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        n = net if name == "float32" else net16
        fenced[name] += fenced_ms(lambda i: frame(n, auds[i % auds.shape[0]]), 15)
    prof = {}
    for name, n in (("float32", net), ("bfloat16", net16)):
        p, events = device_profile(lambda i: frame(n, auds[i]), 3)
        prof[name] = {"device_ms": sum(e.self_device_time_total for e in events) / 3e3,
                      "ms_by_class": ms_by_class(events, 3),
                      "grid_encode_ms": kernel_class_ms(events, 3, "grid_encode_kernel")}
        if name == "bfloat16":
            with open(os.path.join(out_dir, "chip_smoke_bf16_profile.txt"), "w") as f:
                f.write(p.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    bf = {"launches": launches, "psnr_vs_fp32_frame_db": psnr(res["image"], ref["image"]),
          "max_abs_err_vs_fp32": float((res["image"] - ref["image"]).abs().max()),
          "weights_sum_max": float(res["weights_sum"].max()),
          "telemetry": {k: int(v) for k, v in res.items() if k.startswith("n_")},
          "telemetry_fp32": {k: int(v) for k, v in ref.items() if k.startswith("n_")},
          "frame_ms_median": {k: float(np.median(v)) for k, v in fenced.items()},
          "frame_ms": fenced, "profile": prof}
    report["bf16_frame"] = bf
    emit({"phase": "bf16_frame", **{k: v for k, v in bf.items() if k != "frame_ms"}})
    # a fresh network: its three tables packed once each
    if launches["grid_encode_bf16"] != 3 or launches["grid_pack_bf16"] != 3 or \
            launches["grid_encode"] != 0 or launches["march_rays"] != 1 or \
            launches["composite_rays"] != 1:
        raise RuntimeError(f"the -O frame's launches: {launches}")
    # the PSNR against float32 is the policy's own error on this scene, not a
    # check: its U(-4, 4) tables make the density exp() of large values, where
    # bf16 roundings move whole samples (the CPU tests hold -O to JAX's)
    if not bool(torch.isfinite(res["image"]).all()) or bf["telemetry"] != bf["telemetry_fp32"] \
            or not bf["weights_sum_max"] > 0.05:
        raise RuntimeError(f"the -O frame: {bf}")
    return calls


def bf16_train_phase(report, out_dir, root):
    """bf16_train: the head stage under -O (``Options(...).apply_O()``, full
    width, 65,536 rays) on the written directory, the untrained cells
    marked, launch counts from 0: ``Trainer.step`` fenced call by call over
    29 steps (upkeep steps apart), a 3-step profile and its busy share; A-
    and A'-bf16 launched, the float32 A and A' never; every loss finite.
    Returns one more step's recorded A-bf16 and A'-bf16 calls."""
    import radnerf_tpu_torch.models.network as network_mod
    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.models import mark_untrained_grid
    from radnerf_tpu_torch.ops import _kernels
    from radnerf_tpu_torch.train import Trainer

    opt = Options(path=root, preload=2).apply_O()
    ds = TalkingHeadDataset(opt, split="train", device="cuda")
    tr = Trainer(opt, device=ds.device)
    tr.state = mark_untrained_grid(tr.render_cfg, tr.state, ds.poses, tuple(ds.intrinsics))
    interval, order = opt.update_extra_interval, ds.epoch_indices()
    torch.cuda.synchronize()
    _kernels.reset_launches()
    step_ms, upkeep_step_ms, losses = [], [], []
    for n in range(2 * interval - PROFILED_STEPS):
        upkeep = tr.global_step % interval == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.step(ds, order[n % len(order)]))
        torch.cuda.synchronize()
        (upkeep_step_ms if upkeep else step_ms).append((time.perf_counter() - t0) * 1e3)
    launches = _kernels.launches()
    if any((tr.global_step + i) % interval == 0 for i in range(PROFILED_STEPS)):
        raise RuntimeError("a profiled -O step would run the upkeep")
    prof, events = device_profile(lambda i: tr.step(ds, order[i % len(order)]), PROFILED_STEPS)
    with open(os.path.join(out_dir, "chip_smoke_bf16_train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    busy_ms = sum(e.self_device_time_total for e in events) / PROFILED_STEPS / 1e3
    if tr.global_step % interval == 0:  # the recorded step runs no upkeep
        tr.step(ds, order[1])
    # the module itself (the package's name grid_encode is the function)
    grid_mod = sys.modules["radnerf_tpu_torch.ops.grid_encode"]
    with recorded_calls([(network_mod, "grid_encode"),
                         (grid_mod, "grid_encode_backward")]) as calls:
        tr.step(ds, order[0])
    torch.cuda.synchronize()
    losses = torch.stack(losses).tolist()
    med = float(np.median(step_ms))
    bt = {"steps": len(losses), "launches": launches, "loss_first": losses[0],
          "loss_last": losses[-1], "train_step_ms_median": med, "train_step_ms": step_ms,
          "upkeep_step_ms": upkeep_step_ms,
          "phase10_train_step_ms_median": report["train_timing"]["train_step_ms_median"],
          "telemetry_last_step": {k: int(v) for k, v in tr.telemetry.items()},
          "profile": {"steps": PROFILED_STEPS, "device_busy_ms_per_step": busy_ms,
                      "device_busy_share": busy_ms / med,
                      "ms_per_step_by_class": ms_by_class(events, PROFILED_STEPS),
                      "grid_encode_ms": kernel_class_ms(events, PROFILED_STEPS,
                                                        "grid_encode_kernel"),
                      "grid_encode_backward_ms": kernel_class_ms(events, PROFILED_STEPS,
                                                                 "grid_encode_bwd"),
                      "phase10_device_busy_ms_per_step":
                          report["train_timing"]["profile"]["device_busy_ms_per_step"],
                      "phase10_ms_per_step_by_class":
                          report["train_timing"]["profile"]["ms_per_step_by_class"]},
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    report["bf16_train"] = bt
    emit({"phase": "bf16_train", **{k: v for k, v in bt.items() if k != "train_step_ms"}})
    if launches["grid_encode"] or launches["grid_encode_backward"] or \
            not all(launches[k] > 0 for k in BF16_KERNELS + ("march_rays", "composite_rays",
                                                             "composite_rays_backward")):
        raise RuntimeError(f"the -O steps' launches: {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"-O losses: {losses}")
    del tr, ds
    return calls


def bf16_kernel_checks(report, frame_calls, step_calls):
    """bf16_kernel_checks: A-bf16 on the -O frame's D = 3 and D = 2 inputs
    (each reading its table's kept packed copy, as the frame does) and on
    the -O step's (~1.05M samples, packing its table in the call, as the
    step does), and on as many points spread uniformly over each step
    call's box; its packing pass on each of those tables; A'-bf16 on the
    step's bf16 upstream gradients and on the spread points with the same
    gradients; against their plain versions on the card: A's largest error
    in bf16 ulps (at most 1) and its count of differing elements; the
    packing pass bit for bit; A''s table gradient within 2 (n - 1) 2^-24 of
    each row's sum of |terms| (n the row's terms: two orders of a float32
    sum), its x gradient within 1e-5 of the largest; each beside the float32
    variant on the same points (its table and grad_out widened) in turns,
    its bound with bf16 bytes, its plain version's ms; A' also beside its
    reduction floor (the float4 reductions it issues, replayed alone:
    ``studies.grid_bf16.reduction_floor``). Returns the kernels line's
    A-bf16 (the frame's three calls), A'-bf16 (the step's two) and packing
    (the frame's three tables) entries, launches left to the caller."""
    from radnerf_tpu_torch.ops import (
        grid_encode, grid_encode_backward, grid_encode_backward_plain, grid_encode_plain,
        pack_table, pack_table_plain,
    )
    from radnerf_tpu_torch.studies.grid_bf16 import reduction_floor, spread, study_library

    bf16 = torch.bfloat16
    fwd, bwd = [], []
    for where, calls in (("frame", frame_calls), ("step", step_calls)):
        for name, args, kw in calls:
            if name == "grid_encode":
                x, table, spec, bound = args
                fwd.append((where, x, table.to(bf16), spec, bound, kw.get("packed")))
            else:
                x, table, grad_out, spec, bound = args
                bwd.append((where, x, table, grad_out, spec, bound, kw["need_x"]))
    fwd += [("spread", spread(x, bound, 10 + i), tb, spec, bound, None)
            for i, (where, x, tb, spec, bound, _) in enumerate(list(fwd)) if where == "step"]
    bwd += [("spread", spread(x, bound, 20 + i), tb, go, spec, bound, need_x)
            for i, (where, x, tb, go, spec, bound, need_x) in enumerate(list(bwd))
            if where == "step"]
    a_rows, pack_rows = [], []
    for where, x, tb, spec, bound, packed in fwd:
        # the path's own form: the frame reads its kept packed copy, the
        # step (and the spread points) pack in the call
        def call(x=x, tb=tb, spec=spec, bound=bound, packed=packed):
            return grid_encode(x, tb, spec, bound, packed=packed)
        got, want = call(), grid_encode_plain(x, tb, spec, bound)
        torch.cuda.synchronize()
        ulps, n_diff = bf16_ulp_err(got, want)
        t32 = tb.float()
        turns = in_turns({"bf16": call, "fp32": lambda: grid_encode(x, t32, spec, bound)})
        nb, nf = grid_work(x, spec, bound, elem=2)
        bms, by = bound_ms(nb, nf)
        a_rows.append({"where": where, "D": spec.input_dim, "n_points": int(x.shape[0]),
                       "packs_in_call": packed is None,
                       "max_err_ulps": ulps, "elements_differing": n_diff,
                       "max_abs_err": float((got.float() - want.float()).abs().max()),
                       "ms": cuda_ms(call, 20), "device_ms": turns["bf16"],
                       "fp32_device_ms": turns["fp32"],
                       "plain_ms": cuda_ms(lambda: grid_encode_plain(x, tb, spec, bound), 3),
                       "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf})
        if where == "spread":
            continue
        pk, pp = pack_table(tb, spec), pack_table_plain(tb, spec)
        torch.cuda.synchronize()
        # the bf16 table read, the packed copy (2^D rows of 4 bytes a row) written
        nb = tb.numel() * 2 * (1 + (1 << spec.input_dim))
        pack_rows.append({"where": where, "D": spec.input_dim, "rows": int(tb.shape[0]),
                          "bit_for_bit": bool(torch.equal(pk.view(torch.int16),
                                                          pp.view(torch.int16))),
                          "max_abs_err": float((pk.float() - pp.float()).abs().max()),
                          "ms": cuda_ms(lambda: pack_table(tb, spec), 20),
                          "device_ms": device_ms(lambda: pack_table(tb, spec), 20),
                          "plain_ms": cuda_ms(lambda: pack_table_plain(tb, spec), 3),
                          "bound_ms": bound_ms(nb, 0)[0], "bound_by": "bytes", "bytes": nb,
                          "flops": 0})
    rates = study_library("reduction_rates")
    b_rows = []
    for where, x, tb, go, spec, bound, need_x in bwd:
        gk = grid_encode_backward(x, tb, go, spec, bound, need_x=need_x)
        gp = grid_encode_backward_plain(x, tb, go, spec, bound, need_x=need_x)
        # each order of a row's float32 sum of n terms is within (n - 1)
        # 2^-24 of the sum of the terms' magnitudes of the exact sum
        # (recursive summation's bound), so two orders are within twice
        # that: per row, since the step's real gradients cancel within a
        # row, and linear in n, since the collapsed ambient points add
        # nearly equal terms to one row and the roundings do not cancel
        # (a sqrt(n) bound failed by 3.2x there on an NVIDIA H100 80GB
        # HBM3, 700.00 W)
        counts = row_counts(x, spec, bound)[0]
        abs_rows = grid_encode_backward_plain(x, tb, go.abs(), spec, bound, need_x=False)[0]
        row_bound = 2.0 * (counts.double() - 1).clamp_min(1)[:, None] * 2.0**-24 \
            * abs_rows.double()
        over = float(((gk[0] - gp[0]).abs().double() / row_bound.clamp_min(1e-300)).max())
        torch.cuda.synchronize()
        n_busy = int(counts.max())
        t32, g32 = tb.float(), go.float()
        turns = in_turns({
            "bf16": lambda: grid_encode_backward(x, tb, go, spec, bound, need_x=need_x),
            "fp32": lambda: grid_encode_backward(x, t32, g32, spec, bound, need_x=need_x)})
        nb, nf = grid_backward_work(x, spec, bound, need_x, elem=2)
        bms, by = bound_ms(nb, nf)
        n_red, floor_ms = reduction_floor(rates, x, spec, bound, device_ms)
        row = {"where": where, "D": spec.input_dim, "n_points": int(x.shape[0]),
               "x_grad": need_x, "busiest_row_contributions": n_busy,
               "table_err_over_row_bound": over, "table_rel_err": rel_err(gk[0], gp[0]),
               "max_abs_err": float((gk[0] - gp[0]).abs().max()),
               "ms": cuda_ms(lambda: grid_encode_backward(x, tb, go, spec, bound,
                                                          need_x=need_x), 20),
               "device_ms": turns["bf16"], "fp32_device_ms": turns["fp32"],
               "plain_ms": cuda_ms(lambda: grid_encode_backward_plain(
                   x, tb, go, spec, bound, need_x=need_x), 3),
               "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
               "reductions": n_red, "reduction_floor_ms": floor_ms}
        if need_x:
            row.update(x_rel_err=rel_err(gk[1], gp[1]), x_tol_rel=TOL_BACKWARD_REL,
                       max_abs_err=max(row["max_abs_err"],
                                       float((gk[1] - gp[1]).abs().max())))
        b_rows.append(row)
    checks = {"grid_encode_bf16": a_rows, "grid_pack_bf16": pack_rows,
              "grid_encode_backward_bf16": b_rows}
    report["bf16_kernel_checks"] = checks
    emit({"phase": "bf16_kernel_checks", **checks})
    for r in a_rows:
        if not r["max_err_ulps"] <= 1.0:
            raise RuntimeError(f"A-bf16 differs from its plain version by more than 1 ulp: {r}")
    for r in pack_rows:
        if not r["bit_for_bit"]:
            raise RuntimeError(f"A-bf16's packing pass differs from its plain version: {r}")
    for r in b_rows:
        if not (r["table_err_over_row_bound"] <= 1.0
                and r.get("x_rel_err", 0.0) <= TOL_BACKWARD_REL):
            raise RuntimeError(f"A'-bf16 differs from its plain version: {r}")
    if [r["where"] for r in a_rows].count("frame") != 3 or \
            [r["where"] for r in b_rows].count("step") != 2:
        raise RuntimeError("the -O frame and step made other grid calls than A x 3, A' x 2")

    entries = []
    for name, rows, where in (("grid_encode_bf16", a_rows, "frame"),
                              ("grid_encode_backward_bf16", b_rows, "step"),
                              ("grid_pack_bf16", pack_rows, "frame")):
        rows = [r for r in rows if r["where"] == where]
        bms, by = bound_ms(sum(r["bytes"] for r in rows), sum(r["flops"] for r in rows))
        entry = {
            "name": name, "route": "cuda", "source": "radnerf_tpu_torch/csrc/" + (
                "grid_encode_backward.cu" if "backward" in name else "grid_encode.cu"),
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "device_ms": sum(r["device_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": bms, "bound_by": by,
            "library_ms": None, "calls": rows}
        if name != "grid_pack_bf16":
            entry["fp32_device_ms"] = sum(r["fp32_device_ms"] for r in rows)
        if "backward" in name:
            entry["reduction_floor_ms"] = sum(r["reduction_floor_ms"] for r in rows)
        entries.append(entry)
    return entries


def bf16_variants_phase(report, out_dir, root):
    """bf16_variants: the -O policy at the JAX bench's 8x4 grid through the
    port's entry points on the written directory, each command with launch
    counts from 0: ``main -O --exp_eye --grid_levels 8 --grid_ch 4`` at the
    defaults otherwise (bound 1, max_steps 16, 65,536 rays, full-width bf16
    MLPs; BF16_VARIANT_STEPS steps, the evaluation, the test split), the
    loss on a fixed batch before (the seeded init on an upkept grid) and
    after; ``--test`` from its checkpoint; ``--torso`` from its ngp.npz
    (BF16_VARIANT_TORSO_STEPS steps; the torso's 2-D grid at 4 channels
    too); ``infer -O --torso`` on INFER_FRAMES audio rows. Every grid at 4
    channels; A-bf16, its packing pass and A'-bf16 launched, the float32 A
    and A' never. Then the head trainer's ``Trainer.step`` fenced
    (VARIANT_TIMED_STEPS, upkeep apart) and a 3-step profile, beside
    bf16_train's C = 2 step. Returns (one step's recorded A-bf16 and
    A'-bf16 calls, the phase's summed launches)."""
    import radnerf_tpu_torch.models.network as network_mod
    from radnerf_tpu_torch import infer
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.main import build_parser, options_from_args
    from radnerf_tpu_torch.main import main as port_main
    from radnerf_tpu_torch.models import RendererState, mark_untrained_grid, update_density_grid
    from radnerf_tpu_torch.ops import _kernels
    from radnerf_tpu_torch.train import Trainer

    ws, ws_t = os.path.join(root, "bf16_variants"), os.path.join(root, "bf16_variants_torso")
    common = ["-O", "--exp_eye", "--preload", "2", "--ema_update_interval", "1",
              *BF16_VARIANT_FLAGS]
    argv = [root, "--workspace", ws, *common, "--ckpt", "scratch",
            "--iters", str(BF16_VARIANT_STEPS)]
    opt = options_from_args(build_parser().parse_args(argv))
    ds = TalkingHeadDataset(opt, split="train", device="cuda")
    dev = ds.device
    tr0 = Trainer(opt, device=dev)
    cfg, rc = tr0.net.cfg, tr0.render_cfg
    if cfg.table_dtype != torch.bfloat16 or \
            {cfg.grid_spec.level_dim, cfg.ambient_spec.level_dim} != {4}:
        raise RuntimeError(f"the flags do not give the -O 8x4 grids: {cfg}")
    # the fixed batch's loss at the seeded init (main's own draw), on a grid
    # upkept as the first upkeep does
    fixed = tr0.next_batch(ds, 0)
    fixed_noises = torch.rand(opt.num_rays, generator=torch.Generator(dev).manual_seed(124),
                              device=dev)
    with torch.no_grad():
        probe = update_density_grid(
            tr0.net, rc, mark_untrained_grid(rc, RendererState.create(rc, device=dev),
                                             ds.poses, ds.intrinsics),
            tr0.net.encode_audio(ds.audio_window(0)), fixed["eye"],
            generator=torch.Generator(dev).manual_seed(7))
        loss_0 = float(tr0.loss(fixed, fixed_noises, 0, state=probe)[0])
    del tr0, probe
    torch.cuda.empty_cache()

    runs = {}

    def run(name, fn, args):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn(args)
        torch.cuda.synchronize()
        runs[name] = {"argv": args, "seconds": time.perf_counter() - t0,
                      "launches": _kernels.launches()}
        return out

    tr = run("head", port_main, argv)
    with torch.no_grad():
        loss_end = float(tr.loss(fixed, fixed_noises, 0)[0])
    runs["head"].update(steps=tr.global_step, step_losses=tr.stats["step_loss"],
                        eval_psnr=tr.stats["results"],
                        checkpoints=sorted(os.listdir(tr.ckpt_path)),
                        validation=len(os.listdir(os.path.join(ws, "validation"))))
    test = run("test", port_main, [root, "--workspace", ws, *common, "--test"])
    runs["test"].update(eval_psnr=test.stats["results"],
                        results=sorted(os.listdir(os.path.join(ws, "results"))))
    del test
    torso = run("torso", port_main, [root, "--workspace", ws_t, *common, "--torso",
                                     "--head_ckpt", os.path.join(ws, "checkpoints", "ngp.npz"),
                                     "--ckpt", "scratch",
                                     "--iters", str(BF16_VARIANT_TORSO_STEPS)])
    torso_c = torso.net.cfg.torso_spec.level_dim
    runs["torso"].update(steps=torso.global_step, step_losses=torso.stats["step_loss"],
                         eval_psnr=torso.stats["results"], torso_grid_channels=torso_c,
                         checkpoints=sorted(os.listdir(torso.ckpt_path)))
    del torso
    out = os.path.join(root, "bf16_variants_infer")
    fps = run("infer", infer.main, ["--pose", os.path.join(root, "pose.json"), "--aud",
                                    os.path.join(root, "novel.npy"), "--workspace", out,
                                    "-O", "--exp_eye", "--torso", *BF16_VARIANT_FLAGS, "--ckpt",
                                    os.path.join(ws_t, "checkpoints", "ngp.npz")])
    runs["infer"].update(fps=fps, files=len(os.listdir(os.path.join(out, "results"))))
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in _kernels.KERNELS}

    # the head step, fenced (upkeep steps apart) and profiled; one more
    # step's grid calls recorded
    interval, order = opt.update_extra_interval, ds.epoch_indices()
    step_ms, upkeep_step_ms = [], []
    for n in range(VARIANT_TIMED_STEPS):
        upkeep = tr.global_step % interval == 0
        (upkeep_step_ms if upkeep else step_ms).extend(
            fenced_ms(lambda i: tr.step(ds, order[n % len(order)]), 1))
    if any((tr.global_step + i) % interval == 0 for i in range(PROFILED_STEPS + 1)):
        raise RuntimeError("a profiled or recorded -O 8x4 step would run the upkeep")
    prof, events = device_profile(lambda i: tr.step(ds, order[i % len(order)]), PROFILED_STEPS)
    with open(os.path.join(out_dir, "chip_smoke_bf16_variants_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    busy_ms = sum(e.self_device_time_total for e in events) / PROFILED_STEPS / 1e3
    grid_mod = sys.modules["radnerf_tpu_torch.ops.grid_encode"]
    with recorded_calls([(network_mod, "grid_encode"),
                         (grid_mod, "grid_encode_backward")]) as step_calls:
        tr.step(ds, order[0])
    torch.cuda.synchronize()
    med = float(np.median(step_ms))
    c2 = report["bf16_train"]
    bv = {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "step_losses"}
                   for k, v in runs.items()},
          "launches": launches, "grids": {"spatial": str(cfg.grid_spec),
                                           "ambient": str(cfg.ambient_spec)},
          "fixed_batch_loss_step0": loss_0, "fixed_batch_loss_end": loss_end,
          "train_step_ms_median": med, "train_step_ms": step_ms,
          "upkeep_step_ms": upkeep_step_ms,
          "profile": {"steps": PROFILED_STEPS, "device_busy_ms_per_step": busy_ms,
                      "device_busy_share": busy_ms / med,
                      "ms_per_step_by_class": ms_by_class(events, PROFILED_STEPS),
                      "grid_encode_ms": kernel_class_ms(events, PROFILED_STEPS,
                                                        "grid_encode_kernel"),
                      "grid_encode_backward_ms": kernel_class_ms(events, PROFILED_STEPS,
                                                                 "grid_encode_bwd"),
                      "pack_ms": kernel_class_ms(events, PROFILED_STEPS, "pack_kernel")},
          "c2_train_step_ms_median": c2["train_step_ms_median"],
          "c2_device_busy_ms_per_step": c2["profile"]["device_busy_ms_per_step"],
          "c2_device_busy_share": c2["profile"]["device_busy_share"],
          "model": "NetworkConfig(torso=False, exp_eye=True, compute_dtype='bfloat16') full "
                   "width, grids 8x4 (3-D and 2-D), the CLI's defaults otherwise"}
    report["bf16_variants"] = {**bv, "step_losses": {k: runs[k].get("step_losses")
                                                     for k in runs}}
    emit({"phase": "bf16_variants", **{k: v for k, v in bv.items() if k != "train_step_ms"}})

    problems = []
    for name, need in (("head", BF16_KERNELS + ("march_rays", "composite_rays",
                                                "composite_rays_backward")),
                       ("test", ("grid_encode_bf16", "grid_pack_bf16")),
                       ("torso", BF16_KERNELS + ("march_rays", "composite_rays")),
                       ("infer", ("grid_encode_bf16", "grid_pack_bf16", "march_rays",
                                  "composite_rays"))):
        la = runs[name]["launches"]
        if any(la[k] <= 0 for k in need) or la["grid_encode"] or la["grid_encode_backward"]:
            problems.append(f"{name} launches {la}")
    for name, steps in (("head", BF16_VARIANT_STEPS), ("torso", BF16_VARIANT_TORSO_STEPS)):
        r = runs[name]
        if r["steps"] != steps or len(r["step_losses"]) != steps or \
                not all(math.isfinite(float(v)) for v in r["step_losses"]) or \
                not r["eval_psnr"] or not all(math.isfinite(v) for v in r["eval_psnr"]):
            problems.append(f"{name}: {r['steps']} steps, losses {r['step_losses']}, "
                            f"eval {r['eval_psnr']}")
        if "ngp.npz" not in r["checkpoints"]:
            problems.append(f"{name} wrote {r['checkpoints']}")
    if not loss_end < loss_0:
        problems.append(f"the fixed batch's loss did not fall: {loss_0} -> {loss_end}")
    if torso_c != 4:
        problems.append(f"the torso grid has {torso_c} channels")
    if runs["head"]["validation"] != 2 * VAL_FRAMES or not runs["test"]["results"] or \
            runs["infer"]["files"] not in (1, INFER_FRAMES) or not runs["infer"]["fps"] > 0:
        problems.append(f"files: {runs}")
    if [n for n, _, _ in step_calls] != ["grid_encode", "grid_encode",
                                         "grid_encode_backward", "grid_encode_backward"]:
        problems.append(f"the step's calls {[n for n, _, _ in step_calls]}")
    if problems:
        raise RuntimeError(f"bf16_variants: {problems}")
    del tr, ds, prof, events
    torch.cuda.empty_cache()
    return step_calls, launches


def bf16_variant_kernel_checks(report, step_calls, launches):
    """bf16_variant_kernel_checks: the bf16 kernels at the grids the -O
    policy now takes, against their plain versions on the card, on the
    bf16_variants step's recorded 4-channel calls and on VARIANT_POINTS
    seeded points (a few outside the box, a seeded bf16 upstream gradient)
    on BF16_VARIANT_GRIDS (1, 8, 3 and 16 channels, smoothstep at D = 2,
    align_corners at D = 3): A-bf16 (packing in the call, as the step does)
    and its packing pass bit for bit, A'-bf16 with the table gradient per
    row within 2 (n - 1) 2^-24 of its sum of |terms| and x within 1e-5 of
    the largest; float32 A bit for bit and A' per row (variant_kernel_checks'
    bound) at 3 and 16 channels on the same points. Each beside its ms,
    device ms, plain ms and bound (bf16 bytes). Returns the kernels line's
    entries, one per kernel and variant: the step's carry the bf16_variants
    phase's launches, the others their check's."""
    from radnerf_tpu_torch.ops import GridSpec

    bf16 = torch.bfloat16
    dev = step_calls[0][1][0].device
    gen = torch.Generator(dev).manual_seed(41)
    rows = {"grid_encode_bf16": [], "grid_pack_bf16": [], "grid_encode_backward_bf16": [],
            "grid_encode": [], "grid_encode_backward": []}
    # each backward call carries its forward's points and table: A-bf16
    # (packing in the call, as the step does), the packing pass and A'-bf16
    # are held on it
    for name, args, kw in step_calls:
        if name == "grid_encode_backward":
            x, table, go, spec, bound = args
            grid_kernel_rows(rows, "c4_path", "step", x, table.to(bf16), go, spec, bound,
                             kw["need_x"])
    for variant, kw in BF16_VARIANT_GRIDS.items():
        spec = GridSpec.create(num_levels=16, desired_resolution=2048, **kw)
        D, C = spec.input_dim, spec.level_dim
        x = torch.rand((VARIANT_POINTS, D), generator=gen, device=dev) * 2.04 - 1.02
        table = torch.randn((spec.n_embeddings, C), generator=gen, device=dev)
        go = torch.randn((VARIANT_POINTS, spec.output_dim), generator=gen, device=dev)
        grid_kernel_rows(rows, variant, "spread", x, table.to(bf16), go.to(bf16), spec, 1.0,
                         True)
        if C in (3, 16):
            grid_kernel_rows(rows, variant, "spread", x, table, go, spec, 1.0, True)
    report["bf16_variant_kernel_checks"] = rows
    emit({"phase": "bf16_variant_kernel_checks", **rows})
    bad = grid_rows_wrong(rows)
    if bad:
        raise RuntimeError(f"the -O variant kernels differ from their plain versions: {bad}")
    if [r["variant"] for r in rows["grid_encode_bf16"]].count("c4_path") != 2 or \
            [r["variant"] for r in rows["grid_encode_backward_bf16"]].count("c4_path") != 2:
        raise RuntimeError("the -O 8x4 step made other grid calls than A-bf16 x 2, A' x 2")

    entries = []
    for name, kernel_rows in rows.items():
        source = "grid_encode_backward.cu" if "backward" in name else "grid_encode.cu"
        for variant in dict.fromkeys(r["variant"] for r in kernel_rows):
            mine = [r for r in kernel_rows if r["variant"] == variant]
            bms, by = bound_ms(sum(r["bytes"] for r in mine), sum(r["flops"] for r in mine))
            on_path = variant == "c4_path"
            entries.append({
                "name": f"{name}:{variant}", "route": "cuda",
                "source": f"radnerf_tpu_torch/csrc/{source}", "replaces": REPLACES[name],
                "launches": launches[name] if on_path else sum(r["check_launches"]
                                                               for r in mine),
                "launches_in": "the bf16_variants run" if on_path else "its check only",
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": sum(r["ms"] for r in mine),
                "device_ms": sum(r["device_ms"] for r in mine),
                "plain_ms": sum(r["plain_ms"] for r in mine), "bound_ms": bms,
                "bound_by": by, "library_ms": None, "calls": mine})
    return entries


def timed_call(fn):
    """(fn(), ms of that one call between CUDA events, fenced before)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def abs_term_rows(x, spec, bound, g_abs, bf16):
    """Each table row's sum of |terms| w |g| of a grid-encode backward (the
    scale of its row bound), in plain ops: the corners' rows and weights of
    the port's ``_level_corners`` (under the bf16 policy the weights rounded
    to bf16), one ``index_add_`` a (level, corner) -- where autograd through
    the plain encode on |g| takes 10-20 s at D = 7 on 2^20 points."""
    from radnerf_tpu_torch.ops.grid_encode import _level_corners

    L, C = spec.num_levels, spec.level_dim
    x01 = (x.float() + bound) / (2.0 * bound)
    live = ((x01 >= 0.0) & (x01 <= 1.0)).all(dim=-1)
    x01, g = x01[live], g_abs[live].float().reshape(-1, L, C)
    out = torch.zeros((spec.n_embeddings, C), dtype=torch.float32, device=x.device)
    for level in range(L):
        for rows, w in _level_corners(x01, spec, level)[0]:
            w = w.to(torch.bfloat16).float() if bf16 else w
            out.index_add_(0, rows, w[:, None] * g[:, level])
    return out


def grid_kernel_rows(rows, variant, where, x, table, go, spec, bound, need_x, floor=False,
                     chunk=None):
    """Kernel A and, unless ``go`` is None, A' (on a bf16 table A-bf16, its
    packing pass and A'-bf16) on one call's inputs against their plain
    versions, appended to ``rows`` (kernel name -> list): the encodes and
    the packing bit for bit; the table gradient per row within 2 (n - 1)
    2^-24 of its sum of |terms| (``abs_term_rows``; with ``floor``, or
    TOL_STEP_GRAD of the largest, as variant_kernel_checks holds float32),
    x within 1e-5 of the largest; each with its check's launches, ms and
    device ms (20 calls each), the plain version's ms (one call; the
    backward in ``chunk`` points at a time where given) and its bound."""
    from radnerf_tpu_torch.ops import (
        grid_encode, grid_encode_backward, grid_encode_backward_plain, grid_encode_plain,
        pack_table, pack_table_plain,
    )

    bf16 = table.dtype == torch.bfloat16
    elem = 2 if bf16 else 4
    fwd_name, bwd_name = (("grid_encode_bf16", "grid_encode_backward_bf16") if bf16
                          else ("grid_encode", "grid_encode_backward"))
    counts = row_counts(x, spec, bound)
    base = {"variant": variant, "where": where, "spec": str(spec), "n_points": int(x.shape[0])}

    def timing(call, plain_ms, nb, nf):
        bms, by = bound_ms(nb, nf)
        return {"ms": cuda_ms(call, 20), "device_ms": device_ms(call, 20),
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "bytes": nb,
                "flops": nf}

    def fwd():
        return grid_encode(x, table, spec, bound)

    got, n_launch = counted(fwd_name, fwd)
    want, plain_ms = timed_call(lambda: grid_encode_plain(x, table, spec, bound))
    same = torch.equal(got.view(torch.int16), want.view(torch.int16)) if bf16 else \
        torch.equal(got, want)
    rows[fwd_name].append({
        **base, "check_launches": n_launch, "packs_in_call": bf16, "bit_for_bit": bool(same),
        "elements_differing": int((got != want).sum()),
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        **timing(fwd, plain_ms, *grid_work(x, spec, bound, elem, counts))})
    del got, want
    if bf16:
        def pack():
            return pack_table(table, spec)
        pk, n_launch = counted("grid_pack_bf16", pack)
        pp, plain_ms = timed_call(lambda: pack_table_plain(table, spec))
        rows["grid_pack_bf16"].append({
            **base, "rows": int(table.shape[0]), "check_launches": n_launch,
            "bit_for_bit": bool(torch.equal(pk.view(torch.int16), pp.view(torch.int16))),
            "max_abs_err": float((pk.float() - pp.float()).abs().max()),
            # the bf16 table read, the packed copy (2^D rows of it) written
            **timing(pack, plain_ms, table.numel() * 2 * (1 + (1 << spec.input_dim)), 0)})
        del pk, pp
    if go is None:
        return

    def bwd():
        return grid_encode_backward(x, table, go, spec, bound, need_x=need_x)

    def plain_bwd():
        """grid_encode_backward_plain in ``chunk`` points at a time."""
        step = chunk or x.shape[0]
        parts = [grid_encode_backward_plain(x[i:i + step], table, go[i:i + step], spec, bound,
                                            need_x=need_x) for i in range(0, x.shape[0], step)]
        return (sum(t for t, _ in parts),
                torch.cat([gx for _, gx in parts]) if need_x else None)

    gk, n_launch = counted(bwd_name, bwd)
    gp, plain_ms = timed_call(plain_bwd)
    abs_rows = abs_term_rows(x, spec, bound, go.abs(), bf16)
    allowed = 2.0 * (counts[0].double() - 1).clamp_min(1)[:, None] * 2.0**-24 * abs_rows.double()
    allowed = torch.maximum(allowed, torch.full_like(
        allowed, TOL_STEP_GRAD * float(gp[0].abs().max()) if floor else 1e-300))
    row = {**base, "x_grad": need_x, "check_launches": n_launch,
           "busiest_row_contributions": int(counts[0].max()),
           "table_err_over_allowed": float(((gk[0] - gp[0]).abs().double() / allowed).max()),
           "table_rel_err": rel_err(gk[0], gp[0]),
           "max_abs_err": float((gk[0] - gp[0]).abs().max()),
           **timing(bwd, plain_ms, *grid_backward_work(x, spec, bound, need_x, elem, counts))}
    if need_x:
        row.update(x_rel_err=rel_err(gk[1], gp[1]), x_tol_rel=TOL_BACKWARD_REL,
                   max_abs_err=max(row["max_abs_err"], float((gk[1] - gp[1]).abs().max())))
    rows[bwd_name].append(row)


def grid_rows_wrong(rows):
    """The rows of ``grid_kernel_rows`` that disagree with their plain
    versions (empty where every kernel agrees)."""
    bad = [r for k in ("grid_encode", "grid_encode_bf16", "grid_pack_bf16")
           for r in rows.get(k, ()) if not r["bit_for_bit"]]
    return bad + [r for k in ("grid_encode_backward", "grid_encode_backward_bf16")
                  for r in rows.get(k, ()) if not (r["table_err_over_allowed"] <= 1.0
                                                   and r.get("x_rel_err", 0.0) <= TOL_BACKWARD_REL)]


def lifted_cli(root, name, flags):
    """One lifted CLI run through the port's entry points on the written
    directory, each command with launch counts from 0: ``main <flags>``
    (LIFTED_STEPS head steps: one epoch of the 8 frames, the evaluation, the
    test split), ``--test`` from its checkpoint, ``--torso`` from its
    ngp.npz (LIFTED_TORSO_STEPS steps), ``infer --torso`` on INFER_FRAMES
    audio rows; the loss on a fixed batch before (the seeded init on an
    upkept grid) and after. Returns (its report, one more head step's
    recorded grid calls, the grid kernels the run must launch)."""
    import radnerf_tpu_torch.models.network as network_mod
    from radnerf_tpu_torch import infer
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.main import build_parser, options_from_args
    from radnerf_tpu_torch.main import main as port_main
    from radnerf_tpu_torch.models import RendererState, mark_untrained_grid, update_density_grid
    from radnerf_tpu_torch.ops import _kernels
    from radnerf_tpu_torch.train import Trainer

    ws, ws_t = os.path.join(root, f"lifted_{name}"), os.path.join(root, f"lifted_{name}_torso")
    common = ["--preload", "2", "--ema_update_interval", "1", *flags]
    argv = [root, "--workspace", ws, *common, "--ckpt", "scratch", "--iters", str(LIFTED_STEPS)]
    opt = options_from_args(build_parser().parse_args(argv))
    ds = TalkingHeadDataset(opt, split="train", device="cuda")
    dev = ds.device
    tr0 = Trainer(opt, device=dev)
    cfg, rc = tr0.net.cfg, tr0.render_cfg
    specs = {"spatial": cfg.grid_spec, "ambient": cfg.ambient_spec, "torso": cfg.torso_spec}
    fixed = tr0.next_batch(ds, 0)
    fixed_noises = torch.rand(opt.num_rays, generator=torch.Generator(dev).manual_seed(125),
                              device=dev)
    with torch.no_grad():
        probe = update_density_grid(
            tr0.net, rc, mark_untrained_grid(rc, RendererState.create(rc, device=dev),
                                             ds.poses, ds.intrinsics),
            tr0.net.encode_audio(ds.audio_window(0)), fixed["eye"],
            generator=torch.Generator(dev).manual_seed(7))
        loss_0 = float(tr0.loss(fixed, fixed_noises, 0, state=probe)[0])
    del tr0, probe
    torch.cuda.empty_cache()

    runs = {}

    def run(cmd, fn, args):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn(args)
        torch.cuda.synchronize()
        runs[cmd] = {"argv": args, "seconds": time.perf_counter() - t0,
                     "launches": _kernels.launches()}
        return out

    tr = run("head", port_main, argv)
    with torch.no_grad():
        loss_end = float(tr.loss(fixed, fixed_noises, 0)[0])
    runs["head"].update(steps=tr.global_step, step_losses=tr.stats["step_loss"],
                        eval_psnr=tr.stats["results"],
                        checkpoints=sorted(os.listdir(tr.ckpt_path)),
                        validation=len(os.listdir(os.path.join(ws, "validation"))))
    test = run("test", port_main, [root, "--workspace", ws, *common, "--test"])
    runs["test"].update(eval_psnr=test.stats["results"],
                        results=sorted(os.listdir(os.path.join(ws, "results"))))
    del test
    torso = run("torso", port_main, [root, "--workspace", ws_t, *common, "--torso",
                                     "--head_ckpt", os.path.join(ws, "checkpoints", "ngp.npz"),
                                     "--ckpt", "scratch", "--iters", str(LIFTED_TORSO_STEPS)])
    runs["torso"].update(steps=torso.global_step, step_losses=torso.stats["step_loss"],
                         eval_psnr=torso.stats["results"],
                         checkpoints=sorted(os.listdir(torso.ckpt_path)))
    del torso
    out = os.path.join(root, f"lifted_{name}_infer")
    fps = run("infer", infer.main, ["--pose", os.path.join(root, "pose.json"), "--aud",
                                    os.path.join(root, "novel.npy"), "--workspace", out,
                                    *flags, "--torso", "--ckpt",
                                    os.path.join(ws_t, "checkpoints", "ngp.npz")])
    runs["infer"].update(fps=fps, files=len(os.listdir(os.path.join(out, "results"))))

    grid_mod = sys.modules["radnerf_tpu_torch.ops.grid_encode"]
    with recorded_calls([(network_mod, "grid_encode"),
                         (grid_mod, "grid_encode_backward")]) as step_calls:
        tr.step(ds, ds.epoch_indices()[0])
    torch.cuda.synchronize()
    bf16 = cfg.table_dtype == torch.bfloat16
    fwd, bwd = (("grid_encode_bf16", "grid_encode_backward_bf16") if bf16
                else ("grid_encode", "grid_encode_backward"))
    others = ("grid_encode", "grid_encode_backward") if bf16 else BF16_KERNELS
    packs = ("grid_pack_bf16",) if bf16 else ()
    rep = {"flags": flags, "runs": {k: {kk: vv for kk, vv in v.items() if kk != "step_losses"}
                                    for k, v in runs.items()},
           "grids": {k: str(v) for k, v in specs.items()},
           # past the specialised kernels' D, levels or channels
           "general_path": {k: v.input_dim not in (2, 3)
                            or v.num_levels > _kernels.GRID_MAX_LEVELS
                            or v.level_dim > _kernels.GRID_MAX_CHANNELS
                            for k, v in specs.items()},
           "fixed_batch_loss_step0": loss_0, "fixed_batch_loss_end": loss_end,
           "step_losses": {k: runs[k].get("step_losses") for k in runs}}

    problems = []
    for cmd, need in (("head", (fwd, bwd, *packs, "march_rays", "composite_rays",
                                "composite_rays_backward")),
                      ("test", (fwd, *packs)),
                      ("torso", (fwd, bwd, *packs, "march_rays", "composite_rays")),
                      ("infer", (fwd, *packs, "march_rays", "composite_rays"))):
        la = runs[cmd]["launches"]
        if any(la[k] <= 0 for k in need) or any(la[k] for k in others):
            problems.append(f"{cmd} launches {la}")
    for cmd, steps in (("head", LIFTED_STEPS), ("torso", LIFTED_TORSO_STEPS)):
        r = runs[cmd]
        if r["steps"] != steps or len(r["step_losses"]) != steps or \
                not all(math.isfinite(float(v)) for v in r["step_losses"]) or \
                not r["eval_psnr"] or not all(math.isfinite(v) for v in r["eval_psnr"]):
            problems.append(f"{cmd}: {r['steps']} steps, losses {r['step_losses']}, "
                            f"eval {r['eval_psnr']}")
        if "ngp.npz" not in r["checkpoints"]:
            problems.append(f"{cmd} wrote {r['checkpoints']}")
    if not loss_end < loss_0:
        problems.append(f"the fixed batch's loss did not fall: {loss_0} -> {loss_end}")
    if not all(rep["general_path"].values()):
        problems.append(f"a grid of {flags} is not on the general path: {rep['grids']}")
    # the epoch's evaluation and main's last one
    if runs["head"]["validation"] != 2 * VAL_FRAMES or \
            not runs["test"]["results"] or runs["infer"]["files"] not in (1, INFER_FRAMES) or \
            not runs["infer"]["fps"] > 0:
        problems.append(f"files: {runs}")
    if [n for n, _, _ in step_calls] != ["grid_encode", "grid_encode",
                                         "grid_encode_backward", "grid_encode_backward"]:
        problems.append(f"the step's calls {[n for n, _, _ in step_calls]}")
    if problems:
        raise RuntimeError(f"lifted {name}: {problems}")
    del tr, ds
    torch.cuda.empty_cache()
    return rep, step_calls, (fwd, bwd, *packs)


def lifted_phase(report, root):
    """lifted: the grids past RAD-NeRF's (D outside {2, 3}, more than 32
    levels or 16 channels), which kernels A, A', A-bf16, its packing pass
    and A'-bf16 run on their general path. The two CLI runs of LIFTED_RUNS
    (``lifted_cli``), and each run's recorded head-step grid calls held to
    their plain versions (``grid_kernel_rows``); then LIFTED_POINTS seeded
    points (a few outside the box) and a seeded upstream gradient a grid of
    LIFTED_GRIDS through A and A' with x and, on the tiled grids, A-bf16, its
    packing pass and A'-bf16, each held to its plain version. Returns the
    kernels line's entries: per run, each kernel it launched with the run's
    launches and its recorded calls' times; per kernel, the spread points'
    calls summed, with their check's launches."""
    from radnerf_tpu_torch.ops import GridSpec

    t0 = time.perf_counter()
    kernel_names = ("grid_encode", "grid_encode_backward", "grid_encode_bf16",
                    "grid_pack_bf16", "grid_encode_backward_bf16")
    rows = {k: [] for k in kernel_names}
    runs, entries = {}, []
    for name, flags in LIFTED_RUNS.items():
        rep, step_calls, launched = lifted_cli(root, name, flags)
        runs[name] = rep
        # each backward call carries its forward's points and (bf16 under -O)
        # table: the forward, the packing and the backward are held on them
        for call, args, kw in step_calls:
            if call == "grid_encode_backward":
                x, table, go, spec, bound = args
                grid_kernel_rows(rows, f"{name}_path", "step", x, table, go, spec, bound,
                                 kw["need_x"], floor=table.dtype == torch.float32)
        del step_calls
        torch.cuda.empty_cache()
        for k in launched:
            mine = [r for r in rows[k] if r["variant"] == f"{name}_path"]
            bms, by = bound_ms(sum(r["bytes"] for r in mine), sum(r["flops"] for r in mine))
            entries.append({
                "name": f"{k}:lifted_{name}", "route": "cuda",
                "source": "radnerf_tpu_torch/csrc/" + ("grid_encode_backward.cu" if "backward" in k
                                                       else "grid_encode.cu"),
                "replaces": REPLACES[k],
                "launches": sum(r["launches"][k] for r in rep["runs"].values()),
                "launches_in": f"the lifted {name} run",
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": sum(r["ms"] for r in mine), "device_ms": sum(r["device_ms"] for r in mine),
                "plain_ms": sum(r["plain_ms"] for r in mine), "bound_ms": bms,
                "bound_by": by, "library_ms": None, "calls": mine})
    cli_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(51)
    for variant, kw in LIFTED_GRIDS.items():
        spec = GridSpec.create(**{"num_levels": 16, "level_dim": 2,
                                  "desired_resolution": 2048, **kw})
        D, C = spec.input_dim, spec.level_dim
        x = torch.rand((LIFTED_POINTS, D), generator=gen, device=dev) * 2.04 - 1.02
        table = torch.randn((spec.n_embeddings, C), generator=gen, device=dev)
        go = torch.randn((LIFTED_POINTS, spec.output_dim), generator=gen, device=dev)
        grid_kernel_rows(rows, variant, "spread", x, table, go, spec, 1.0, True, floor=True,
                         chunk=LIFTED_PLAIN_CHUNK)
        if spec.gridtype == "tiled":
            grid_kernel_rows(rows, variant, "spread", x, table.to(torch.bfloat16),
                             go.to(torch.bfloat16), spec, 1.0, True, chunk=LIFTED_PLAIN_CHUNK)
        del x, table, go
        torch.cuda.empty_cache()
    for k in kernel_names:
        mine = [r for r in rows[k] if r["where"] == "spread"]
        bms, by = bound_ms(sum(r["bytes"] for r in mine), sum(r["flops"] for r in mine))
        entries.append({
            "name": f"{k}:lifted_spread", "route": "cuda",
            "source": "radnerf_tpu_torch/csrc/" + ("grid_encode_backward.cu" if "backward" in k
                                                   else "grid_encode.cu"),
            "replaces": REPLACES[k], "launches": sum(r["check_launches"] for r in mine),
            "launches_in": "its check only",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine), "device_ms": sum(r["device_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine), "bound_ms": bms, "bound_by": by,
            "library_ms": None, "calls": mine})
    lp = {"runs": runs, "kernel_rows": rows, "cli_seconds": cli_s,
          "seconds": time.perf_counter() - t0}
    report["lifted"] = lp
    emit({"phase": "lifted", "seconds": lp["seconds"], "cli_seconds": cli_s,
          "runs": {k: {kk: vv for kk, vv in v.items() if kk != "step_losses"}
                   for k, v in runs.items()},
          "rows": {k: [{kk: r[kk] for kk in ("variant", "where", "spec", "check_launches",
                                             "max_abs_err", "device_ms", "bound_ms",
                                             "plain_ms")
                        if kk in r} for r in v] for k, v in rows.items()}})
    bad = grid_rows_wrong(rows)
    bad += [r for rs in rows.values() for r in rs if r["check_launches"] != 1]
    if bad:
        raise RuntimeError(f"lifted: kernels differ from their plain versions: {bad}")
    return entries


def recipe_phase(report, root):
    """recipe: the README's -O workflow through the port's entry points on
    the written directory, each command with launch counts from 0: the head
    (RECIPE_HEAD_STEPS steps, the evaluation, ngp.npz), the lips finetune
    from its latest checkpoint (RECIPE_LIPS_STEPS more: rect and full
    batches alternating, a finite non-zero LPIPS term on the rect steps,
    every group's rate base * 0.05 ** (step / iters)), the torso from the
    head's ngp.npz (RECIPE_TORSO_STEPS), --torso --test, and infer -O
    --torso. Returns the summed launches of the bf16 kernels."""
    from radnerf_tpu_torch import infer
    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.main import main as port_main
    from radnerf_tpu_torch.ops import _kernels

    # the lips rects of the written landmarks: alex-LPIPS needs 32 px a side
    rects = TalkingHeadDataset(Options(path=root, finetune_lips=True), split="train",
                               device="cuda").lips_rect
    sides = sorted({min(x1 - x0, y1 - y0) for x0, x1, y0, y1 in rects})
    if sides[0] < 32:
        raise RuntimeError(f"the written landmarks give lips rects of {sides} px")
    ws, ws_t = os.path.join(root, "recipe_head"), os.path.join(root, "recipe_torso")
    common = ["-O", "--preload", "2", "--ema_update_interval", "1"]
    n = DATASET_FRAMES
    runs = {}

    def run(name, fn, argv):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        runs[name] = {"argv": argv, "seconds": time.perf_counter() - t0,
                      "launches": _kernels.launches()}
        return out

    head = run("head", port_main, [root, "--workspace", ws, *common, "--ckpt", "scratch",
                                   "--iters", str(RECIPE_HEAD_STEPS)])
    runs["head"].update(steps=head.global_step, step_losses=head.stats["step_loss"],
                        eval_psnr=head.stats["results"], eval_loss=head.stats["valid_loss"],
                        checkpoints=sorted(os.listdir(head.ckpt_path)))
    del head
    lips = run("lips", port_main, [root, "--workspace", ws, *common, "--finetune_lips",
                                   "--iters", str(RECIPE_HEAD_STEPS + RECIPE_LIPS_STEPS)])
    opt = lips.opt
    base = {"grid": opt.lr, "net": opt.lr_net, "att": 5 * opt.lr_net}
    rates = {g["name"]: g["lr"] for g in lips.optimizer.param_groups}
    runs["lips"].update(
        steps=lips.global_step, loss_mode=lips.stats["loss_mode"],
        lpips_term=lips.stats["lpips_term"], step_losses=lips.stats["step_loss"],
        eval_psnr=lips.stats["results"], decay_base=lips.decay_base,
        rates=rates, rates_want={g: base[g] * 0.05 ** (lips.global_step / opt.iters)
                                 for g in rates})
    del lips
    head_ckpt = os.path.join(ws, "checkpoints", "ngp.npz")
    torso = run("torso", port_main, [root, "--workspace", ws_t, *common, "--torso",
                                     "--head_ckpt", head_ckpt, "--ckpt", "scratch",
                                     "--iters", str(RECIPE_TORSO_STEPS)])
    runs["torso"].update(steps=torso.global_step, step_losses=torso.stats["step_loss"],
                         eval_psnr=torso.stats["results"],
                         checkpoints=sorted(os.listdir(torso.ckpt_path)))
    del torso
    test = run("test", port_main, [root, "--workspace", ws_t, "-O", "--torso", "--test",
                                   "--preload", "2"])
    runs["test"].update(eval_psnr=test.stats["results"],
                        results=sorted(os.listdir(os.path.join(ws_t, "results"))))
    del test
    pose_path, aud_path = os.path.join(root, "pose.json"), os.path.join(root, "novel.npy")
    out = os.path.join(root, "recipe_infer")
    fps = run("infer", infer.main, ["--pose", pose_path, "--aud", aud_path, "--workspace", out,
                                    "-O", "--torso", "--ckpt",
                                    os.path.join(ws_t, "checkpoints", "ngp.npz")])
    runs["infer"].update(fps=fps, files=len(os.listdir(os.path.join(out, "results"))))
    report["recipe"] = {"lips_rect_sides": sides, **runs}
    emit({"phase": "recipe", "lips_rect_sides": sides,
          **{k: {kk: vv for kk, vv in v.items() if kk != "step_losses"}
             for k, v in runs.items()}})

    lips = runs["lips"]
    modes = lips["loss_mode"]
    problems = []
    if modes != ["rect", "none"] * (RECIPE_LIPS_STEPS // 2):
        problems.append(f"lips batch kinds {modes}")
    if len(lips["lpips_term"]) != RECIPE_LIPS_STEPS // 2 or not all(
            math.isfinite(v) and v > 0 for _, v in lips["lpips_term"]):
        problems.append(f"lips LPIPS terms {lips['lpips_term']}")
    if lips["decay_base"] != 0.05 or not all(
            abs(lips["rates"][g] - w) <= 1e-9 * w for g, w in lips["rates_want"].items()):
        problems.append(f"lips rates {lips['rates']} vs {lips['rates_want']}")
    for name in ("head", "lips", "torso"):
        r = runs[name]
        if not all(math.isfinite(v) for v in r["step_losses"]) or not r["eval_psnr"] or \
                not all(math.isfinite(v) for v in r["eval_psnr"]):
            problems.append(f"{name}: losses {r['step_losses']}, eval {r['eval_psnr']}")
    want_steps = {"head": RECIPE_HEAD_STEPS, "lips": RECIPE_HEAD_STEPS + RECIPE_LIPS_STEPS,
                  "torso": RECIPE_TORSO_STEPS}
    problems += [f"{k}: {runs[k]['steps']} steps" for k, v in want_steps.items()
                 if runs[k]["steps"] != v]
    for name, need in (("head", BF16_KERNELS + ("march_rays", "composite_rays",
                                                "composite_rays_backward")),
                       ("lips", BF16_KERNELS + ("composite_rays_backward",)),
                       ("torso", BF16_KERNELS + ("march_rays", "composite_rays")),
                       ("test", ("grid_encode_bf16", "grid_pack_bf16", "march_rays",
                                 "composite_rays")),
                       ("infer", ("grid_encode_bf16", "grid_pack_bf16", "march_rays",
                                  "composite_rays"))):
        la = runs[name]["launches"]
        if any(la[k] <= 0 for k in need) or la["grid_encode"] or la["grid_encode_backward"]:
            problems.append(f"{name} launches {la}")
    if runs["torso"]["launches"]["composite_rays_backward"]:
        problems.append("the torso stage launched C'")
    for name, files in (("head", runs["head"]["checkpoints"]),
                        ("torso", runs["torso"]["checkpoints"])):
        if "ngp.npz" not in files:
            problems.append(f"{name} wrote {files}")
    if not os.path.exists(os.path.join(ws, "checkpoints", "ngp_ep0002.npz")):
        problems.append("the lips finetune wrote no epoch checkpoint")
    if not runs["test"]["results"] or runs["infer"]["files"] not in (1, INFER_FRAMES) or \
            not runs["infer"]["fps"] > 0:
        problems.append(f"test results {runs['test']['results']}, infer {runs['infer']}")
    if problems:
        raise RuntimeError(f"the -O recipe: {problems}")
    return {k: sum(r["launches"][k] for r in runs.values()) for k in BF16_KERNELS}


# ---------------------------------------------------------------------------
# camera offsets, the live path, mesh export

@contextlib.contextmanager
def plain_kernels():
    """While the block runs, the model modules' bindings of kernels B, C and
    A are their plain PyTorch versions, on the card (autograd runs through
    their plain ops)."""
    import radnerf_tpu_torch.models.network as network_mod
    import radnerf_tpu_torch.models.renderer as renderer_mod
    from radnerf_tpu_torch.ops import composite_rays_plain, grid_encode_plain, march_rays_plain

    swaps = [(renderer_mod, "march_rays", march_rays_plain),
             (renderer_mod, "composite_rays", composite_rays_plain),
             (network_mod, "grid_encode", grid_encode_plain)]
    originals = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, originals):
            setattr(mod, name, fn)


@contextlib.contextmanager
def captured_apps():
    """While the block runs, ``InteractiveApp.serve`` keeps the app it is
    called on in the yielded list and returns at once."""
    from radnerf_tpu_torch.apps import InteractiveApp

    apps, serve = [], InteractiveApp.serve
    InteractiveApp.serve = lambda self, host="127.0.0.1", port=8965: apps.append(self)
    try:
        yield apps
    finally:
        InteractiveApp.serve = serve


def camera_phase(report, out_dir, root):
    """camera: the head stage with learnt camera offsets at full width, 65,536
    rays, on the written directory. ``python -m radnerf_tpu_torch.main <dir>
    -O --train_camera`` in this process (CAMERA_STEPS steps, the evaluation,
    the test split), launch counts from 0: the offsets of the trained frames
    moved off 0, equal in the epoch checkpoint and in a trainer that loads
    it. Then float32: one train step of a ``train_camera`` trainer against
    the same step of a trainer without offsets (the same seed and batch, in
    turns: fenced ms, a 3-step profile each), its launches; on seeded
    offsets of a few degrees, the step's loss and the gradients of
    ``camera_dR``, ``camera_dT`` and the grid tables through the kernels
    against the plain versions on the card (the same batch and noises), and
    kernel B's xyz against the positions formed again from its t, bit for
    bit. Returns the -O run's epoch checkpoint."""
    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.main import main as port_main
    from radnerf_tpu_torch.models import mark_untrained_grid
    from radnerf_tpu_torch.models.renderer import camera_offsets, march_window, sample_positions
    from radnerf_tpu_torch.ops import (
        _kernels, grid_encode_backward_plain, march_rays, near_far_from_aabb,
    )
    from radnerf_tpu_torch.train import Trainer
    from radnerf_tpu_torch.train import checkpoint as ckpt_lib

    ws = os.path.join(root, "camera")
    argv = [root, "--workspace", ws, "-O", "--train_camera", "--preload", "2", "--ckpt",
            "scratch", "--iters", str(CAMERA_STEPS), "--ema_update_interval", "1"]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    tr = port_main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _kernels.launches()
    cam = {k: getattr(tr.net, k).detach() for k in ("camera_dR", "camera_dT")}
    moved = int(((cam["camera_dR"] != 0).any(1) | (cam["camera_dT"] != 0).any(1)).sum())
    ckpt = os.path.join(tr.ckpt_path, f"ngp_ep{tr.epoch:04d}.npz")
    saved = ckpt_lib.load_checkpoint(ckpt)[0]
    back = Trainer(Options(path=root, train_camera=True).apply_O(), device="cuda",
                   workspace=ws, use_checkpoint=ckpt)
    kept = {"file": all(np.array_equal(saved[k], v.cpu().numpy()) for k, v in cam.items()),
            "loaded": all(torch.equal(getattr(back.net, k), v) for k, v in cam.items())}
    cli = {"argv": argv, "seconds": run_s, "steps": tr.global_step, "launches": launches,
           "step_losses": tr.stats["step_loss"], "eval_psnr": tr.stats["results"],
           "frames_moved": moved, "max_abs_dR_deg": float(cam["camera_dR"].abs().max()),
           "max_abs_dT": float(cam["camera_dT"].abs().max()), "checkpoint_kept": kept}
    del tr, back

    # float32: a step with offsets against the same step without
    opt = Options(path=root, exp_eye=True, preload=2)
    ds = TalkingHeadDataset(opt, split="train", device="cuda")
    dev = ds.device
    trs = {"camera": Trainer(dataclasses.replace(opt, train_camera=True), device=dev),
           "plain": Trainer(opt, device=dev)}
    for t in trs.values():
        t.state = mark_untrained_grid(t.render_cfg, t.state, ds.poses, tuple(ds.intrinsics))
        t.update_extra_state(ds)  # the upkeep of step 0
        t.global_step = 1
    batch = trs["camera"].next_batch(ds, 1)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    trs["camera"].train_step(batch)
    torch.cuda.synchronize()
    step_launches = _kernels.launches()
    fenced = {"camera": [], "plain": []}
    for name in ("camera", "plain", "plain", "camera") * (CAMERA_TIMED_STEPS // 2):
        fenced[name] += fenced_ms(lambda i: trs[name].train_step(batch), 1)
    prof = {}
    for name, t in trs.items():
        p, events = device_profile(lambda i: t.train_step(batch), PROFILED_STEPS)
        with open(os.path.join(out_dir, f"chip_smoke_camera_{name}_profile.txt"), "w") as f:
            f.write(p.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        busy = sum(e.self_device_time_total for e in events) / PROFILED_STEPS / 1e3
        med = float(np.median(fenced[name]))
        prof[name] = {"train_step_ms_median": med, "device_busy_ms_per_step": busy,
                      "device_busy_share": busy / med,
                      "ms_per_step_by_class": ms_by_class(events, PROFILED_STEPS)}

    # the step through the kernels and through the plain versions, on seeded
    # offsets of the batch's frame
    tr = trs["camera"]
    idx, rc = batch["index"], tr.render_cfg
    gen = torch.Generator(dev).manual_seed(17)
    with torch.no_grad():
        tr.net.camera_dR[idx] = (torch.rand(3, generator=gen, device=dev) * 2 - 1) * 3.0
        tr.net.camera_dT[idx] = (torch.rand(3, generator=gen, device=dev) * 2 - 1) * 0.03
    noises = torch.rand(batch["rays_o"].shape[0], generator=gen, device=dev)
    names = ("camera_dR", "camera_dT", "encoder", "encoder_ambient")

    def step_grads():
        tr.optimizer.zero_grad(set_to_none=True)
        loss = tr.loss(batch, noises, tr.global_step)[0]
        loss.backward()
        return float(loss), {k: getattr(tr.net, k).grad.detach().clone() for k in names}

    grid_mod = sys.modules["radnerf_tpu_torch.ops.grid_encode"]
    with recorded_calls([(grid_mod, "grid_encode_backward")]) as bwd_calls:
        loss_k, g_k = step_grads()
    with plain_kernels():
        loss_p, g_p = step_grads()
    tr.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        o, d = camera_offsets(tr.net, idx, batch["rays_o"], batch["rays_d"])
        nears, fars = near_far_from_aabb(o, d, o.new_tensor(rc.aabb), rc.min_near)
        m = march_rays(o, d, nears, fars, tr.state.sigma_bytes, rc.march_config(),
                       march_window(tr.state, o, d, nears, fars), rc.cull_T, noises)
        xyz = sample_positions(o, d, m["t"], rc.bound)
    v = m["valid"]
    grads = {k: {"rel_err": rel_err(g_k[k], g_p[k]), "tol_rel": TOL_STEP_GRAD,
                 "max_abs": float(g_p[k].abs().max())} for k in names}
    # a table row sums its n terms in another order on each path: each
    # order is within (n - 1) 2^-24 of the sum of the terms' magnitudes of
    # the exact sum (bf16_kernel_checks' rule), so a row may differ by twice
    # that, or by the CPU step check's 1e-4 of the largest where more
    for _, (x, table, go, spec, bound), _ in bwd_calls:
        k = "encoder" if spec.input_dim == 3 else "encoder_ambient"
        counts = row_counts(x, spec, bound)[0]
        abs_rows = grid_encode_backward_plain(x, table, go.abs(), spec, bound,
                                              need_x=False)[0]
        allowed = torch.maximum(
            2.0 * (counts.double() - 1).clamp_min(1)[:, None] * 2.0**-24 * abs_rows.double(),
            torch.full_like(abs_rows, TOL_STEP_GRAD * grads[k]["max_abs"], dtype=torch.float64))
        grads[k].update(
            busiest_row_contributions=int(counts.max()),
            err_over_allowed=float(((g_k[k] - g_p[k]).abs().double() / allowed).max()))
    check = {"loss_kernels": loss_k, "loss_plain": loss_p,
             "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p), "loss_tol_rel": TOL_STEP_REL,
             "grads": grads, "backward_calls": len(bwd_calls),
             "xyz_bit_for_bit": bool(torch.equal(xyz[v], m["xyz"][v])),
             "n_samples": int(v.sum()),
             "samples_on_the_bound": int((xyz[v].abs() == rc.bound).sum())}
    cp = {"cli": cli, "step_launches": step_launches, "timing": prof,
          "extra_ms_median": prof["camera"]["train_step_ms_median"]
          - prof["plain"]["train_step_ms_median"],
          "extra_device_ms": prof["camera"]["device_busy_ms_per_step"]
          - prof["plain"]["device_busy_ms_per_step"],
          "train_step_ms": fenced, "step_check": check,
          "model": "NetworkConfig(torso=False, exp_eye=True, train_camera=True) full width, "
                   "65,536 rays; -O through the CLI, float32 for the step"}
    report["camera"] = cp
    emit({"phase": "camera", **{k: v for k, v in cp.items() if k != "train_step_ms"},
          "cli": {k: v for k, v in cli.items() if k != "step_losses"}})
    problems = []
    if cli["steps"] != CAMERA_STEPS or not all(math.isfinite(x) for x in cli["step_losses"]):
        problems.append(f"the CLI run: {cli['steps']} steps, losses {cli['step_losses']}")
    if not all(launches[k] > 0 for k in BF16_KERNELS + ("march_rays", "composite_rays",
                                                        "composite_rays_backward")):
        problems.append(f"the CLI run's launches {launches}")
    if moved < 1 or not all(kept.values()):
        problems.append(f"the offsets: {moved} frames moved, kept {kept}")
    if any(step_launches[k] != n for k, n in (("grid_encode", 2), ("grid_encode_backward", 2),
                                              ("march_rays", 1), ("composite_rays", 1),
                                              ("composite_rays_backward", 1))):
        problems.append(f"the float32 camera step's launches {step_launches}")
    if not check["loss_rel_err"] <= TOL_STEP_REL or len(bwd_calls) != 2 or any(
            not (g["err_over_allowed"] <= 1.0 if "err_over_allowed" in g
                 else g["rel_err"] <= g["tol_rel"]) for g in grads.values()):
        problems.append(f"the camera step, kernels against plain versions: {check}")
    if not check["xyz_bit_for_bit"] or check["n_samples"] == 0:
        problems.append("kernel B's xyz differs from the positions formed from its t")
    if problems:
        raise RuntimeError(f"camera: {problems}")
    del trs, tr, ds
    torch.cuda.empty_cache()
    return ckpt


def stand_in_logits(audio_dim, device, seed=5):
    """The acoustic model's stand-in (no wav2vec2 weights ship with the
    repository): a seeded linear map of each 320-sample chunk to
    ``audio_dim`` logits, on the card."""
    w = torch.randn(320, audio_dim, generator=torch.Generator().manual_seed(seed)).to(device)

    def fn(frame):
        n = len(frame) // 320
        x = torch.from_numpy(np.ascontiguousarray(frame[: n * 320])).to(device)
        return (x.view(n, 320) @ w * 0.1).cpu().numpy()

    return fn


def write_wav(path, seconds, seed=4):
    """A seeded 16 kHz int16 wav: a 220 Hz tone under noise."""
    from scipy.io import wavfile

    t = np.arange(int(16000 * seconds)) / 16000
    wave = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(seed).normal(
        size=t.shape)
    wavfile.write(path, 16000, (np.clip(wave, -1, 1) * 32767).astype(np.int16))
    return path


def read_mjpeg_parts(url, n):
    """The first ``n`` JPEG parts of an MJPEG stream, as bytes."""
    import urllib.request

    parts = []
    with urllib.request.urlopen(url, timeout=120) as r:
        while len(parts) < n:
            if r.readline() != b"--frame\r\n" or \
                    r.readline() != b"Content-Type: image/jpeg\r\n":
                raise RuntimeError("not an MJPEG part")
            size = int(r.readline().split(b":")[1])
            r.readline()
            parts.append(r.read(size))
            r.readline()
    return parts


def live_phase(report, out_dir, root):
    """live: what ``python -m radnerf_tpu_torch.infer -O --torso --gui --asr``
    serves, built by that entry point in this process on the recipe's torso
    checkpoint and the written pose json (512x512), its ``serve`` captured:
    a ``StreamingASR`` in file mode on a seeded 3 s wav with the stand-in
    acoustic model on the card, warmed up. Then LIVE_FRAMES playing frames,
    two ASR steps each, launch counts from 0 (fenced ms, the ASR's share, a
    3-frame profile); A-bf16, B and C against their plain versions on one
    live frame's inputs; 4 static frames accumulated (the buffer the mean of
    the perturbed frames), a downscale 0.5 frame, a depth frame; ``serve``
    on a free port from a thread, two JPEG parts of /stream read; and the
    training app of ``main -O --gui`` (its ``serve`` captured): a 16-step
    ``train_gui`` burst, launch counts from 0."""
    from PIL import Image
    import io
    import threading

    from radnerf_tpu_torch import infer, resolve_device
    from radnerf_tpu_torch.apps import StreamingASR
    from radnerf_tpu_torch.main import main as port_main
    from radnerf_tpu_torch.models import graph_stats, reset_graph_stats
    from radnerf_tpu_torch.ops import _kernels

    dev = resolve_device("cuda")
    wav = write_wav(os.path.join(root, "speech.wav"), LIVE_SECONDS)
    logits_fn = stand_in_logits(44, dev)
    argv = ["--pose", os.path.join(root, "pose.json"), "--workspace",
            os.path.join(root, "live"), "-O", "--torso", "--ckpt",
            os.path.join(root, "recipe_torso", "checkpoints", "ngp.npz"), "--gui", "--asr",
            "--asr_wav", wav]
    t0 = time.perf_counter()
    with captured_apps() as apps:
        infer.main(argv, logits_fn=logits_fn)
    build_s = time.perf_counter() - t0
    app = apps[0]
    asr, tr = app.asr, app.trainer
    fresh = StreamingASR(app.opt, logits_fn=logits_fn, device=dev)
    t0 = time.perf_counter()
    fresh.warm_up()
    warm_s = time.perf_counter() - t0
    del fresh

    asr_s = [0.0]

    def timed(fn):
        def wrapper(*a):
            t = time.perf_counter()
            out = fn(*a)
            asr_s[0] += time.perf_counter() - t
            return out
        return wrapper

    asr.run_step, asr.get_next_feat = timed(asr.run_step), timed(asr.get_next_feat)
    app.playing = True
    torch.cuda.synchronize()
    _kernels.reset_launches()
    reset_graph_stats()
    frame_ms = fenced_ms(lambda i: app.step(), LIVE_FRAMES)
    launches, graphs = _kernels.launches(), graph_stats()
    asr_share = asr_s[0] * 1e3 / sum(frame_ms)
    prof, events = device_profile(lambda i: app.step(), 3)
    with open(os.path.join(out_dir, "chip_smoke_live_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    live_frame = app.render_buffer
    checks = frame_kernel_checks(app.step, {"grid_encode": 3, "march_rays": 1,
                                            "composite_rays": 1})

    # a static view: fresh, then perturbed frames averaged in
    app.playing, app.max_spp, app.need_update = False, 4, True
    static = [app.render_frame() for _ in range(5)]
    spp = app.spp
    eye = app.eye_area if app.eye_area is not None else 0.25
    refs = [tr.test_gui(app.cam.pose, app.cam.intrinsics, app.W, app.H, auds=None, eye=eye,
                        index=app.ind_index, bg_color=app.bg_color, spp=s)["image"]
            for s in (1, 1, 2, 3)]
    spp_err = float(np.abs(app.render_buffer - np.mean(refs, 0)).max())
    app.downscale = 0.5
    t0 = time.perf_counter()
    half = app.render_frame()
    half_ms = (time.perf_counter() - t0) * 1e3
    app.downscale, app.mode = 1.0, "depth"
    depth = app.render_frame()
    app.mode = "image"
    # the depth frame is the frame's depth in its own range, in three channels
    want_depth = tr._normalize_depth(tr.test_gui(
        app.cam.pose, app.cam.intrinsics, app.W, app.H, auds=None, eye=eye,
        index=app.ind_index, bg_color=app.bg_color)["depth"])
    depth_ok = bool(np.array_equal(depth, np.clip(want_depth, 0, 1)[..., None].repeat(3, -1)))

    thread = threading.Thread(target=app.serve, kwargs={"port": 0}, daemon=True)
    thread.start()
    try:
        if not app.serving.wait(60):
            raise RuntimeError("serve did not start")
        parts = read_mjpeg_parts(f"http://127.0.0.1:{app.server.server_address[1]}/stream", 2)
    finally:
        app.stop()
        thread.join(60)
    jpeg_sizes = [Image.open(io.BytesIO(p)).size for p in parts]

    # the training app of main --gui
    with captured_apps() as gui_apps:
        port_main([root, "--workspace", os.path.join(root, "live_train"), "-O", "--preload", "2",
                   "--ckpt", "scratch", "--gui"])
    gapp = gui_apps[0]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    burst = gapp.trainer.train_gui(gapp.dataset, step=16)
    torch.cuda.synchronize()
    burst_ms = (time.perf_counter() - t0) * 1e3
    burst_launches = _kernels.launches()
    trained_frame = gapp.render_frame()

    med = float(np.median(frame_ms))
    busy = sum(e.self_device_time_total for e in events) / 3e3
    lv = {"argv": argv, "build_seconds": build_s, "warm_up_seconds": warm_s,
          "warm_up_steps": asr.warm_up_steps,
          "expected_latency_s": asr.warm_up_steps / asr.fps, "frames": LIVE_FRAMES,
          "launches": launches, "graphs": graphs, "frame_ms_median": med,
          "frame_ms_p90": float(np.percentile(frame_ms, 90)), "fps": 1e3 / med,
          "asr_share": asr_share, "device_busy_ms_per_frame": busy,
          "device_busy_share": busy / med, "ms_per_frame_by_class": ms_by_class(events, 3),
          "kernel_checks": checks, "spp_buffer_max_abs_err": spp_err, "spp": spp,
          "static_repeat_equal": bool(np.array_equal(static[3], static[4])),
          "downscale_shape": list(half.shape), "downscale_ms": half_ms,
          "depth_range": [float(depth.min()), float(depth.max())], "depth_frame_equal": depth_ok,
          "jpeg_parts": [len(p) for p in parts], "jpeg_sizes": jpeg_sizes,
          "train_gui": {"steps": gapp.trainer.global_step, "loss": burst["loss"], "ms": burst_ms,
                        "launches": burst_launches, "training": gapp.training,
                        "frame_finite": bool(np.isfinite(trained_frame).all())},
          "model": "the recipe's -O --torso checkpoint, NetworkConfig(torso=True, exp_eye=True, "
                   "bfloat16) full width, 512x512, white background"}
    report["live"] = {**lv, "frame_ms": frame_ms}
    emit({"phase": "live", **lv})
    problems = []
    # the three tables' packed copies are kept: packed at most once each
    # march, torso, composite: the torso on
    if launches["grid_encode_bf16"] != 3 * LIVE_FRAMES or launches["grid_encode"] or \
            frames_ran("march_rays", launches, graphs, 3) != LIVE_FRAMES or \
            frames_ran("composite_rays", launches, graphs, 3) != LIVE_FRAMES \
            or launches["grid_pack_bf16"] > 3:
        problems.append(f"the playing frames' launches {launches}, graphs {graphs}")
    if not all(r["ok"] for rows in checks.values() for r in rows):
        problems.append(f"a kernel differs from its plain version in a live frame: {checks}")
    if live_frame.shape != (LIVE_SIZE, LIVE_SIZE, 3) or not np.isfinite(live_frame).all():
        problems.append("the live frame is no finite 512x512 image")
    if not spp_err <= 1e-5 or spp != 4 or not lv["static_repeat_equal"]:
        problems.append(f"spp accumulation: buffer error {spp_err}")
    if list(half.shape) != [LIVE_SIZE, LIVE_SIZE, 3] or not np.isfinite(half).all():
        problems.append(f"the downscaled frame {half.shape}")
    if not depth_ok or depth.shape != (LIVE_SIZE, LIVE_SIZE, 3):
        problems.append(f"the depth frame {depth.shape}, range {lv['depth_range']}")
    if len(parts) != 2 or any(s != (LIVE_SIZE, LIVE_SIZE) for s in jpeg_sizes) or \
            thread.is_alive():
        problems.append(f"serve: parts {jpeg_sizes}, thread alive {thread.is_alive()}")
    g = lv["train_gui"]
    if g["steps"] != 16 or not math.isfinite(g["loss"]) or not g["training"] or \
            not g["frame_finite"] or burst_launches["grid_encode_backward_bf16"] != 32:
        problems.append(f"train_gui: {g}")
    if problems:
        raise RuntimeError(f"live: {problems}")


def mesh_phase(report, out_dir, root, head_ckpt):
    """mesh: ``Trainer.save_mesh`` at its defaults (resolution 256, threshold
    10) on the camera phase's head checkpoint (the field in float32), launch
    counts from 0: A 2 a chunk of 262,144 points, 128 in all; then the
    sweep and the tetrahedra timed apart, and ``extract_geometry`` and the
    PLY, whose bytes are the ones save_mesh wrote; A against its plain version on the first
    chunk (both of its calls); the card's tetrahedra on the 64^3 middle of
    the field against the CPU's, at threshold 10 and at that sub-field's
    median."""
    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.ops import _kernels, grid_encode, grid_encode_plain
    from radnerf_tpu_torch.train import Trainer
    from radnerf_tpu_torch.utils.mesh import (
        extract_geometry, lattice_axes, marching_tetrahedra, save_mesh_ply,
    )

    ws = os.path.join(root, "mesh")
    tr = Trainer(Options(exp_eye=True, train_camera=True), device="cuda", workspace=ws,
                 use_checkpoint=head_ckpt)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    path = tr.save_mesh(resolution=MESH_RESOLUTION, threshold=MESH_THRESHOLD)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _kernels.launches()

    dev, res, chunk = tr.device, MESH_RESOLUTION, 128**2 * 16
    aabb = tr.render_cfg.aabb
    axes = [torch.from_numpy(a).to(dev) for a in lattice_axes(aabb[:3], aabb[3:], res)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    e = torch.full((1, 1), 0.25, device=dev)
    with torch.no_grad():
        def sweep():
            return torch.cat([tr.net.field_density(pts[h:h + chunk], None, e)["sigma"]
                              for h in range(0, pts.shape[0], chunk)])
        sweep_ms = fenced_ms(lambda i: sweep(), 1)[0]
        field = sweep().view(res, res, res)
        t0 = time.perf_counter()
        _, tris = marching_tetrahedra(field, MESH_THRESHOLD)
        torch.cuda.synchronize()
        tetra_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        world, faces = extract_geometry(aabb[:3], aabb[3:], res, MESH_THRESHOLD,
                                        lambda p: tr.net.field_density(p, None, e)["sigma"],
                                        device=dev)
        extract_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    save_mesh_ply(os.path.join(ws, "parts.ply"), world, faces)
    ply_ms = (time.perf_counter() - t0) * 1e3
    with open(path, "rb") as a, open(os.path.join(ws, "parts.ply"), "rb") as b:
        same_ply = a.read() == b.read()

    cfg = tr.net.cfg
    x = pts[:chunk]
    a_calls = {"spatial": (x, tr.net.encoder.detach(), cfg.grid_spec, cfg.bound),
               "ambient": (torch.zeros(chunk, cfg.ambient_dim, device=dev),
                           tr.net.encoder_ambient.detach(), cfg.ambient_spec, 1.0)}
    a_rows = {}
    for name, args in a_calls.items():
        gk, gp = grid_encode(*args), grid_encode_plain(*args)
        nb, nf = grid_work(args[0], args[2], args[3])
        bms, by = bound_ms(nb, nf)
        a_rows[name] = {"bit_for_bit": bool(torch.equal(gk, gp)),
                        "max_abs_err": float((gk - gp).abs().max()),
                        "device_ms": device_ms(lambda: grid_encode(*args), 20),
                        "plain_ms": cuda_ms(lambda: grid_encode_plain(*args), 3),
                        "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf}

    mid = res // 2 - TETRA_CHECK // 2
    sub = field[mid:mid + TETRA_CHECK, mid:mid + TETRA_CHECK, mid:mid + TETRA_CHECK]
    tetra = {}
    for thr in (MESH_THRESHOLD, float(sub.median())):
        t0 = time.perf_counter()
        vk, fk = marching_tetrahedra(sub, thr)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        vc, fc = marching_tetrahedra(sub.cpu(), thr)
        tetra[str(thr)] = {"faces": int(fk.shape[0]), "card_ms": card_ms,
                           "cpu_ms": (time.perf_counter() - t0) * 1e3,
                           "faces_equal": bool(torch.equal(fk.cpu(), fc)),
                           "max_abs_vertex_err": float((vk.cpu() - vc).abs().max())
                           if vk.shape[0] else 0.0}
    ms = {"path": os.path.relpath(path, root), "seconds": total_s, "launches": launches,
          "resolution": res, "threshold": MESH_THRESHOLD, "chunks": -(-res**3 // chunk),
          "sweep_ms": sweep_ms, "tetrahedra_ms": tetra_ms, "extract_geometry_ms": extract_ms,
          "ply_ms": ply_ms, "vertices": int(world.shape[0]), "faces": int(faces.shape[0]),
          "tetrahedra_faces": int(tris.shape[0]),
          "ply_bytes": os.path.getsize(path), "parts_ply_equal": same_ply,
          "sigma_range": [float(field.min()), float(field.max())],
          "grid_encode_chunk": a_rows, "tetrahedra_vs_cpu": tetra,
          "model": "the camera phase's -O head checkpoint in a float32 NetworkConfig(torso="
                   "False, exp_eye=True, train_camera=True); the eye input at 0.25"}
    report["mesh"] = ms
    emit({"phase": "mesh", **ms})
    problems = []
    chunks = ms["chunks"]
    if launches["grid_encode"] != 2 * chunks or launches["grid_encode_bf16"]:
        problems.append(f"launches {launches}")
    if not same_ply:
        problems.append("extract_geometry's PLY differs from save_mesh's")
    if not all(r["bit_for_bit"] for r in a_rows.values()):
        problems.append(f"A differs from its plain version on a lattice chunk: {a_rows}")
    if not all(t["faces_equal"] and t["max_abs_vertex_err"] <= 1e-12 for t in tetra.values()) \
            or tetra[str(float(sub.median()))]["faces"] == 0:
        problems.append(f"the card's tetrahedra against the CPU's: {tetra}")
    if problems:
        raise RuntimeError(f"mesh: {problems}")
    del tr, field, pts
    torch.cuda.empty_cache()


def gather_phase(report, dev):
    """Phase 9: the gather study (kernel D), launch counts from 0; returns
    D's kernels-line entry."""
    from radnerf_tpu_torch.ops import _kernels, bench_gather_study, take_rows, take_rows_plain

    torch.cuda.synchronize()
    _kernels.reset_launches()
    study = bench_gather_study(GATHER_ROWS, GATHER_WIDTH, GATHER_TABLES, device=dev)
    torch.cuda.synchronize()
    launches = _kernels.launches()["row_gather"]
    per_t = {}
    for T, r in study.items():
        table, idx = r["table"], r["idx"]
        row_bytes = GATHER_WIDTH * table.element_size()
        n_rows = int(torch.unique(idx).numel())
        nb = GATHER_ROWS * 4 + n_rows * row_bytes + GATHER_ROWS * row_bytes
        bms, by = bound_ms(nb, 0)
        per_t[T] = {"equal": r["equal"], "max_abs_err": r["max_abs_err"],
                    "ms": cuda_ms(lambda: take_rows(table, idx), 20),
                    "device_ms": device_ms(lambda: take_rows(table, idx), 20),
                    "plain_ms": cuda_ms(lambda: take_rows_plain(table, idx), 20),
                    "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx), 20),
                    "bound_ms": bms, "bound_by": by, "bytes": nb}
    report["gather"] = {"rows": GATHER_ROWS, "width_bf16": GATHER_WIDTH,
                        "launches": launches, "tables": per_t}
    emit({"phase": "gather", **report["gather"]})
    if launches <= 0:
        raise RuntimeError("kernel row_gather was not launched by the gather study")
    for T, r in per_t.items():
        if not r["equal"] or r["max_abs_err"] != 0.0:
            raise RuntimeError(f"row_gather differs from table[idx] at T = {T}: {r}")
    # the kernels line carries the study's larger table; both are in the report
    big = per_t[GATHER_TABLES[-1]]
    return {"name": "row_gather", "route": "cuda",
            "source": "radnerf_tpu_torch/csrc/row_gather.cu", "replaces": REPLACES["row_gather"],
            "launches": launches, "max_abs_err": big["max_abs_err"], "ms": big["ms"],
            "device_ms": big["device_ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"]}


# ---------------------------------------------------------------- preprocess
def bisenet_checkpoint(path, seed=0):
    """A seeded BiSeNet checkpoint in the reference's key layout (every key
    of 79999_iter.pth, the auxiliary heads and step counters included):
    He-normal convolutions, batch norm scale U(0.5, 1.5), bias and mean
    N(0, 0.1), variance U(0.5, 1.5)."""
    from radnerf_tpu_torch.preprocess.face_parsing import BiSeNet

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in BiSeNet().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64)
            continue
        if k.endswith("running_var") or (v.dim() == 1 and k.endswith("weight")):
            a = rng.uniform(0.5, 1.5, shape)
        elif v.dim() == 1:
            a = rng.normal(0, 0.1, shape)
        else:
            a = rng.normal(size=shape) * math.sqrt(2.0 / np.prod(shape[1:]))
        sd[k] = torch.from_numpy(a.astype(np.float32))
    torch.save(sd, path)
    return path


def _lattice_uv(gx, gy):
    """The face lattice: u across gx columns, v up gy rows, both in [-1, 1];
    vertex (row i, column j) is i * gx + j; two triangles a cell."""
    u, v = np.meshgrid(np.linspace(-1, 1, gx), np.linspace(1, -1, gy), indexing="xy")
    i, j = np.meshgrid(np.arange(gy - 1), np.arange(gx - 1), indexing="ij")
    a = (i * gx + j).reshape(-1)
    tris = np.concatenate([np.stack([a, a + gx, a + 1], -1),
                           np.stack([a + 1, a + gx, a + gx + 1], -1)]).astype(np.int32)
    return u.reshape(-1), v.reshape(-1), tris


def _landmark_uv():
    """68 points in the reference's landmark order over the lattice face:
    jaw 0-16, brows 17-26, nose 27-35, eyes 36-47 (hexagons), lips 48-67."""
    pts = [(0.8 * math.cos(a), -0.1 + 0.8 * math.sin(a))
           for a in np.linspace(math.pi * 1.05, math.pi * 1.95, 17)]
    for side in (-1, 1):
        pts += [(side * (0.12 + 0.1 * k), 0.45 + 0.04 * math.sin(math.pi * k / 4))
                for k in range(5)][::side]
    pts += [(0.0, 0.3 - 0.1 * k) for k in range(4)]
    pts += [(0.08 * k, -0.08 - 0.02 * abs(k)) for k in range(-2, 3)]
    for cx in (-0.32, 0.32):
        pts += [(cx + 0.1 * math.cos(a), 0.28 + 0.05 * math.sin(a))
                for a in np.linspace(math.pi, -math.pi, 6, endpoint=False)]
    pts += [(0.22 * math.cos(a), -0.42 + 0.1 * math.sin(a))
            for a in np.linspace(math.pi, -math.pi, 12, endpoint=False)]
    pts += [(0.14 * math.cos(a), -0.42 + 0.04 * math.sin(a))
            for a in np.linspace(math.pi, -math.pi, 8, endpoint=False)]
    return np.asarray(pts)


def synthetic_3dmm(root, seed=0, amps=PRE_AMPS):
    """A seeded 3DMM at the BFM's sizes in the reference's files: a face-like
    surface on a 175 x 198 lattice (34,650 vertices, 68,556 triangles; about
    1.5 wide, 2 high and 1.5 deep, in 1e5 units as the BFM's), id 100 and
    exp 79 smooth deformation bases (exp localised at the eyes and mouth), a
    textured albedo with 100 texture bases, 68 landmark vertices and rigid
    vertices. With ``amps`` PRE_AMPS the id and exp bases move a landmark by
    a fraction of a pixel: with stronger ones the fits absorb the perspective
    that tells the sweep's focal candidates apart into id and exp, and the
    sweep's losses no longer single out the true focal (measured on the CPU
    with this generator); IDEXP_AMPS move it by pixels. Writes
    3DMM_info.npy, keys_info.npy and topology_info.npy under root; returns
    their paths."""
    gx, gy = PRE_LATTICE
    n_id, n_exp, n_tex = PRE_DIMS
    rng = np.random.default_rng(seed)
    u, v, tris = _lattice_uv(gx, gy)
    V = u.size
    r2 = (u / 0.95) ** 2 + (v / 1.05) ** 2
    nose = np.exp(-(u**2 + (v + 0.02) ** 2) / 0.015)
    geo = np.stack([0.75 * u, 1.0 * v, 1.3 * np.sqrt(np.clip(1.0 - 0.95 * r2, 0.0, 1.0))
                    + 0.25 * nose], -1)
    # smooth fields: products of low-frequency cosines over the lattice
    phi = np.stack([np.cos(math.pi * a * (u + 1) / 2) * np.cos(math.pi * b * (v + 1) / 2)
                    for a in range(5) for b in range(5)])  # [25, V]
    local = (np.exp(-(u**2 + (v + 0.42) ** 2) / 0.04)
             + np.exp(-((np.abs(u) - 0.3) ** 2 + (v - 0.3) ** 2) / 0.02))

    def bases(n, amp, window=1.0):
        a = rng.normal(size=(n, 3, phi.shape[0])) / math.sqrt(phi.shape[0])
        return (np.einsum("nck,kv->nvc", a, phi) * amp * np.asarray(window)[..., None])

    info = {
        "mu_shape": (geo * 1e5).reshape(-1).astype(np.float32),
        "mu_exp": np.zeros(V * 3, np.float32),
        "b_shape": (bases(n_id, amps[0]) * 1e5).reshape(n_id, -1).astype(np.float32),
        "sig_shape": np.ones(n_id, np.float32),
        "b_exp": (bases(n_exp, amps[1], local) * 1e5).reshape(n_exp, -1).astype(np.float32),
        "sig_exp": np.ones(n_exp, np.float32),
        "mu_tex": np.clip(np.array([190.0, 140.0, 120.0]) + 30 * phi[[1, 5, 6]].T
                          + 25 * (np.cos(12 * math.pi * u) * np.cos(12 * math.pi * v))[:, None],
                          0, 255).reshape(-1).astype(np.float32),
        "b_tex": bases(n_tex, 8.0).reshape(n_tex, -1).astype(np.float32),
        "sig_tex": np.ones(n_tex, np.float32),
    }
    lm = _landmark_uv()
    keyinds = np.argmin((u[None] - lm[:, :1]) ** 2 + (v[None] - lm[:, 1:]) ** 2, axis=1)
    rigid = np.nonzero((v > 0.0) & (r2 < 0.8))[0][::20]
    paths = {k: os.path.join(root, f"{k}_info.npy") for k in ("3DMM", "keys", "topology")}
    np.save(paths["3DMM"], info)
    np.save(paths["keys"], {"keyinds": keyinds.astype(np.int64), "rigid_ids": rigid})
    np.save(paths["topology"], {"tris": tris})
    return paths


def synthetic_truth(rng, n):
    """Seeded true tracking parameters for n frames (smooth in time): id,
    exp, euler, trans (z near -7), SH light (27 per frame) and texture."""
    n_id, n_exp, n_tex = PRE_DIMS
    t = np.arange(n)[:, None] / n

    def wave(k, amp):
        return amp * np.sin(2 * math.pi * (rng.uniform(0.5, 1.5, k) * t + rng.uniform(0, 1, k)))

    light = np.zeros((n, 27))
    light[:, [0, 9, 18]] = 0.3
    light[:, [1, 2, 3, 10, 11, 12, 19, 20, 21]] = rng.normal(0, 0.12, 9)
    light += wave(27, 0.01)
    return {k: np.asarray(v, np.float32) for k, v in {
        "id": rng.normal(0, 0.2, (1, n_id)), "exp": wave(n_exp, 0.2),
        "euler": wave(3, 0.25), "trans": np.concatenate([wave(2, 0.1), -7.0 + wave(1, 0.2)], 1),
        "light": light, "tex": rng.normal(0, 0.5, (1, n_tex))}.items()}


def write_video_inputs(root, paths, dev, seed=1):
    """The processed directory's inputs before preprocessing, as the
    reference's tasks 1, 3 and 7 would leave them, made without a video: 64
    frames of 512x512 (ori_imgs/<i>.jpg, quality 100) of the synthetic 3DMM
    rendered by the port's Render3DMM from seeded true parameters at focal
    1100, over a seeded static background and a neck and torso below the
    face; their .lms landmarks projected from the truth; aud.wav (2.56 s);
    the BiSeNet checkpoint. Returns (truth, background [H, W, 3] uint8 BGR,
    truth masks [N, H, W] uint8: 0 bg, 1 head, 2 neck, 3 torso)."""
    import cv2

    from radnerf_tpu_torch.preprocess.face_tracker import (
        basis_from_file, euler_rot, landmarks_from_params, project,
    )
    from radnerf_tpu_torch.preprocess.render_3dmm import (
        Render3DMM, forward_geo, forward_tex, mesh_basis_from_file,
    )

    N, S = PRE_FRAMES, PRE_SIZE
    rng = np.random.default_rng(seed)
    truth = synthetic_truth(rng, N)
    mesh = mesh_basis_from_file(paths["3DMM"], paths["topology"], paths["keys"]).to(dev)
    lm = basis_from_file(paths["3DMM"], paths["keys"])
    tt = {k: torch.from_numpy(v).to(dev) for k, v in truth.items()}
    with torch.no_grad():
        geo = forward_geo(mesh, tt["id"].expand(N, -1), tt["exp"])
        cam = torch.einsum("nij,nkj->nki", euler_rot(tt["euler"]), geo) + tt["trans"][:, None]
        rgba = Render3DMM(PRE_FOCAL, S, S, mesh.tris)(cam, forward_tex(mesh, tt["tex"].expand(
            N, -1)), tt["light"]).cpu().numpy()
        lms = project(landmarks_from_params(lm, tt["id"].expand(N, -1), tt["exp"]),
                      tt["euler"], tt["trans"], PRE_FOCAL, (S / 2.0, S / 2.0)).cpu().numpy()
    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    bg = np.stack([90 + 60 * np.sin(xx / 70.0) + 20 * np.cos(yy / 45.0),
                   110 + 50 * np.cos(xx / 90.0 + yy / 120.0),
                   140 + 40 * np.sin(yy / 60.0)], -1)
    bg = np.clip(bg + rng.normal(0, 1.0, (1, 1, 3)), 0, 255).astype(np.uint8)  # BGR
    ori = os.path.join(root, "ori_imgs")
    os.makedirs(ori)
    masks = np.zeros((N, S, S), np.uint8)
    for i in range(N):
        head = rgba[i, ..., 3] > 0
        rows = np.nonzero(head.any(1))[0]
        chin, cx = rows.max(), int(round(lms[i, 8, 0]))
        neck = (yy > chin - 30) & (yy <= chin + 40) & (np.abs(xx - cx) < 60) & ~head
        torso = (yy > chin + 40) & (np.abs(xx - cx) < 150 + (yy - chin - 40)) & ~head
        frame = bg.copy()
        frame[neck] = (120, 150, 200)
        frame[torso] = (60, 60, 140)
        frame[head] = np.clip(np.round(rgba[i, ..., 2::-1][head]), 0, 255).astype(np.uint8)
        masks[i][head], masks[i][neck], masks[i][torso] = 1, 2, 3
        cv2.imwrite(os.path.join(ori, f"{i}.jpg"), frame, [cv2.IMWRITE_JPEG_QUALITY, 100])
        np.savetxt(os.path.join(ori, f"{i}.lms"), lms[i], "%f")
    write_wav(os.path.join(root, "aud.wav"), PRE_SECONDS)
    bisenet_checkpoint(os.path.join(root, "79999_iter.pth"))
    return truth, bg, masks


def write_truth_masks(root, masks):
    """The truth masks over parsing/ in task 4's colours (as
    classes_to_colors writes them through cv2)."""
    import cv2

    colors = np.array([(255, 255, 255), (255, 0, 0), (0, 255, 0), (0, 0, 255)], np.uint8)
    for i, m in enumerate(masks):
        cv2.imwrite(os.path.join(root, "parsing", f"{i}.png"), colors[m])


@contextlib.contextmanager
def recorded_losses():
    """Every ``backward()`` called in the block, its tensor recorded
    (detached, in call order): the losses of an optimisation's steps."""
    losses, backward = [], torch.Tensor.backward

    def recording(self, *a, **kw):
        losses.append(self.detach())
        return backward(self, *a, **kw)

    torch.Tensor.backward = recording
    try:
        yield losses
    finally:
        torch.Tensor.backward = backward


def photometric_ms_by_class(events, reps):
    """Device ms per photometric step by kind: kernel E; the index kernels
    and the sorts of their backward (the attribute interpolation's gathers
    and their gradient); GEMMs (the bases); `cat` copies; elementwise
    kernels (copies included); reductions; host copies and memsets; the
    rest."""
    out = {"rasterize_E": 0.0, "index_and_sort": 0.0, "gemm": 0.0, "cat": 0.0,
           "elementwise": 0.0, "reduce": 0.0, "memcpy_memset": 0.0, "other": 0.0}
    for e in events:
        k = e.key.lower()
        kind = ("rasterize_E" if "raster_triangles" in k or "unpack_ids" in k
                else "index_and_sort" if any(w in k for w in ("index", "scatter", "gather",
                                                               "sort"))
                else "gemm" if "gemm" in k else "cat" if "catarraybatchedcopy" in k
                else "elementwise" if "elementwise" in k else "reduce" if "reduce" in k
                else "memcpy_memset" if "memcpy" in k or "memset" in k else "other")
        out[kind] += e.self_device_time_total / reps / 1e3
    return out


def idexp_fit_check(root, dev):
    """The landmark fit's id and exp stage on the card, which the cell's
    bases cannot show (they move a landmark by a fraction of a pixel, so a
    fit that never moved id or exp would still reproject within
    MAX_REPROJ_PX): a synthetic 3DMM whose id and exp bases move a landmark
    by pixels (IDEXP_AMPS), the true parameters' landmarks at the true focal,
    and track_landmarks' coarse fit at that focal (``_fit``, its default
    iterations and smoothing) run twice: pose only, which must miss the
    landmarks by more than MAX_REPROJ_PX, and whole, which must come within
    it."""
    from radnerf_tpu_torch.preprocess import face_tracker

    os.makedirs(os.path.join(root, "idexp"))
    paths = synthetic_3dmm(os.path.join(root, "idexp"), amps=IDEXP_AMPS)
    lm = face_tracker.basis_from_file(paths["3DMM"], paths["keys"]).to(dev)
    N, cxy = PRE_FRAMES, (PRE_SIZE / 2.0, PRE_SIZE / 2.0)
    truth = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_truth(np.random.default_rng(1), N).items()}

    def landmarks(p, pose):
        with torch.no_grad():
            return face_tracker.project(
                face_tracker.landmarks_from_params(lm, p["id"].expand(N, -1), p["exp"]),
                pose["euler"], pose["trans"], PRE_FOCAL, cxy)

    lms = landmarks(truth, truth)
    out = {"amps": IDEXP_AMPS, "idexp_part_px_mean": float(
        (lms - landmarks({"id": 0 * truth["id"], "exp": 0 * truth["exp"]}, truth))
        .norm(dim=-1).mean())}
    n_pose, n_joint = inspect.signature(face_tracker.track_landmarks).parameters[
        "coarse_iters"].default
    for name, joint in (("pose_only", 0), ("joint", n_joint)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, _ = face_tracker._fit(lm, lms, PRE_FOCAL, cxy, n_pose, joint, smooth_weight=0.01)
        torch.cuda.synchronize()
        out[name] = {"steps": n_pose + joint, "seconds": time.perf_counter() - t,
                     "reprojection_px_mean": float((landmarks(p, p) - lms).norm(dim=-1).mean())}
    # the fit's id/exp part at the true pose against the truth's (reported)
    out["joint"]["idexp_part_err_px_mean"] = float(
        (landmarks(p, truth) - lms).norm(dim=-1).mean())
    if not (out["pose_only"]["reprojection_px_mean"] > MAX_REPROJ_PX
            > out["joint"]["reprojection_px_mean"]):
        raise RuntimeError(f"the landmark fit's id and exp stage on pixel-sized bases: {out}")
    return out


def photometric_card_vs_cpu(refine, args, dev):
    """photometric_refine on the card against the same call on the CPU
    (rasterize_plain there), on the cell's own inputs cut to PHOTO_CHECK's
    frames and steps: losses, parameters and projected landmarks held to
    TOL_PHOTO_*. Returns the differences."""
    from radnerf_tpu_torch.preprocess import face_tracker

    track, lms, images, mesh, lm_basis, h, w = args
    N, n = len(lms), PHOTO_CHECK["frames"]
    track = {k: np.asarray(v)[:n] if np.asarray(v).shape[0] == N else v
             for k, v in track.items()}
    kw = {k: v for k, v in PHOTO_CHECK.items() if k != "frames"}
    runs = {}
    for d in (dev, "cpu"):
        with recorded_losses() as losses:
            out = refine(track, lms[:n], images[:n], mesh, lm_basis, h, w, device=d, **kw)
        runs[d] = (out, np.array([float(v) for v in losses]))

    def landmarks(p):
        t = {k: torch.from_numpy(np.asarray(p[k], np.float32)) for k in p}
        return face_tracker.project(
            face_tracker.landmarks_from_params(lm_basis.to("cpu"), t["id"].expand(n, -1),
                                               t["exp"]),
            t["euler"], t["trans"], float(np.asarray(p["focal"]).reshape(-1)[0]),
            (w / 2.0, h / 2.0)).numpy()

    (got, l_got), (want, l_want) = runs[dev], runs["cpu"]
    res = {**PHOTO_CHECK, "steps": len(l_got),
           "loss_rel_err": float(np.abs(l_got / l_want - 1).max()),
           "param_rel_err": {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                             for k in ("id", "exp", "euler", "trans", "tex", "light")},
           "landmarks_px_err": float(np.abs(landmarks(got) - landmarks(want)).max()),
           "tol": [TOL_PHOTO_LOSS_REL, TOL_PHOTO_PARAM_REL, TOL_PHOTO_LMS_PX]}
    if not (len(l_got) == len(l_want) and res["loss_rel_err"] <= TOL_PHOTO_LOSS_REL
            and max(res["param_rel_err"].values()) <= TOL_PHOTO_PARAM_REL
            and res["landmarks_px_err"] <= TOL_PHOTO_LMS_PX):
        raise RuntimeError(f"photometric_refine on the card against the CPU: {res}")
    return res


def preprocess_phase(report, out_dir, dev):
    """preprocess: ``python -m radnerf_tpu_torch.process`` in this process on
    the reference's inputs at full size, made in a temporary place (the
    BFM-size synthetic 3DMM, 64 frames of 512x512, landmarks, a 2.56 s wav, a
    seeded BiSeNet), launch counts from 0 just before task 2 and read after
    task 9: task 2 (a seeded stand-in acoustic model on the card), task 4
    (the BiSeNet over all 64 frames), tasks 5-6 on the truth masks written
    over parsing/, task 8 with the photometric stage (kernel E), task 9;
    tasks 1 and 3 on a video made by ffmpeg where it is installed. Checks:
    E launched; E against rasterize_plain on a photometric step's own
    inputs; task 4's masks; the BiSeNet on the card against the CPU; the
    focal and the reprojection error; the photometric loss falling in both
    stages; the landmark fit's id and exp stage on pixel-sized bases; the
    photometric refinement on the card against the CPU; bc.jpg; the torso
    alpha; ``radnerf_tpu_torch.main`` training on the directory. Then
    timing: per task, the BiSeNet, the tracker's steps a second, the
    photometric step fenced and profiled, E against its bound and its
    layout floor. Returns E's kernels-line entry."""
    import shutil

    import cv2

    from radnerf_tpu_torch import process
    from radnerf_tpu_torch.main import main as port_main
    from radnerf_tpu_torch.ops import _kernels, rasterize, rasterize_plain
    from radnerf_tpu_torch.ops.rasterize import _covered_pairs, _live_ranges, _trimmed_ranges
    from radnerf_tpu_torch.preprocess import face_parsing, face_tracker, render_3dmm

    smi = nvidia_smi_line()
    ph = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = synthetic_3dmm(root)
        truth, bg, masks = write_video_inputs(root, paths, dev)
        ph["inputs_seconds"] = time.perf_counter() - t0
        video = os.path.join(root, "video.mp4")
        ffmpeg = shutil.which("ffmpeg")

        # what the main path calls, recorded: the tracker's fits, the
        # photometric refinement (its inputs and its steps' losses) and E's
        # inputs
        fits, photo, raster_calls = [], {}, []
        fit_batched, refine = face_tracker._fit_batched, face_tracker.photometric_refine
        raster = render_3dmm.rasterize

        def timed_fit(basis, lms, focals, cxy, n_pose, n_joint, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fit_batched(basis, lms, focals, cxy, n_pose, n_joint, *a, **kw)
            torch.cuda.synchronize()
            fits.append({"candidates": len(focals), "frames": int(lms.shape[0]),
                         "steps": n_pose + n_joint, "seconds": time.perf_counter() - t})
            return out

        def recorded_refine(track, lms, images, mesh, lm_basis, h, w, **kw):
            photo["args"] = (track, lms, images, mesh, lm_basis, h, w)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with recorded_losses() as photo["losses"]:
                out = refine(track, lms, images, mesh, lm_basis, h, w, **kw)
            torch.cuda.synchronize()
            photo["seconds"] = time.perf_counter() - t
            return out

        def recorded_raster(xy, z, tris, H, W):
            raster_calls[:] = [(xy, z, tris, H, W)]  # the last call's inputs
            return raster(xy, z, tris, H, W)

        face_tracker._fit_batched = timed_fit
        face_tracker.photometric_refine = recorded_refine
        render_3dmm.rasterize = recorded_raster
        tasks = [(2, []), (4, ["--parsing_weights", os.path.join(root, "79999_iter.pth")]),
                 (5, []), (6, []),
                 (8, ["--basis_path", paths["3DMM"], "--keys_path", paths["keys"],
                      "--topology_path", paths["topology"]]), (9, [])]
        task_ms, launches = {}, {}
        try:
            torch.cuda.synchronize()
            _kernels.reset_launches()
            for task, extra in tasks:
                if task == 5:
                    # task 4 checked, the truth masks go over parsing/ so that
                    # the plates of tasks 5-6 can be held to the truth
                    parsed = [cv2.imread(os.path.join(root, "parsing", f"{i}.png"))
                              for i in range(PRE_FRAMES)]
                    write_truth_masks(root, masks)
                t = time.perf_counter()
                process.main([video, "--task", str(task), *extra], device=dev,
                             logits_fn=stand_in_logits(44, dev) if task == 2 else None)
                torch.cuda.synchronize()
                task_ms[task] = (time.perf_counter() - t) * 1e3
            launches = _kernels.launches()
            if ffmpeg:
                # tasks 1 and 3 on a video of the frames, in a directory of their own
                vdir = os.path.join(root, "ffmpeg")
                os.makedirs(vdir)
                subprocess.run([ffmpeg, "-y", "-loglevel", "error", "-framerate", "25", "-i",
                                os.path.join(root, "ori_imgs", "%d.jpg"), "-i",
                                os.path.join(root, "aud.wav"), "-shortest",
                                os.path.join(vdir, "video.mp4")], check=True, timeout=120)
                for task in (1, 3):
                    t = time.perf_counter()
                    process.main([os.path.join(vdir, "video.mp4"), "--task", str(task)],
                                 device=dev)
                    task_ms[task] = (time.perf_counter() - t) * 1e3
                n_jpg = len(os.listdir(os.path.join(vdir, "ori_imgs")))
                if not os.path.exists(os.path.join(vdir, "aud.wav")) or n_jpg == 0:
                    raise RuntimeError(f"tasks 1 and 3 wrote {n_jpg} frames and "
                                       f"{os.listdir(vdir)}")
        finally:
            face_tracker._fit_batched, face_tracker.photometric_refine = fit_batched, refine
            render_3dmm.rasterize = raster
        ph.update(task_ms=task_ms, launches=launches,
                  tasks_run=sorted(task_ms), ffmpeg=bool(ffmpeg),
                  tasks_1_3="run on an ffmpeg-made video" if ffmpeg
                  else "not run: no ffmpeg on this machine (the frames and wav are written)",
                  iterations="the tracker's defaults: focal_iters (2000, 2500), coarse_iters "
                             "(1000, 2500), light_iters 71, fine_iters 50; no cut")
        if launches.get("rasterize", 0) <= 0:
            raise RuntimeError(f"kernel E was not launched by the preprocessing run: {launches}")

        # task 4: the four colours at frame size; the BiSeNet on the card
        # against the same module on the CPU (TF32 off) on one frame
        colours = set()
        for m in parsed:
            if m is None or m.shape != (PRE_SIZE, PRE_SIZE, 3):
                raise RuntimeError("task 4 wrote no mask of the frame's size")
            colours |= {tuple(int(c) for c in row) for row in np.unique(m.reshape(-1, 3), axis=0)}
        net = face_parsing.load_torch_weights(os.path.join(root, "79999_iter.pth"), dev)
        frames = [cv2.cvtColor(cv2.imread(os.path.join(root, "ori_imgs", f"{i}.jpg")),
                               cv2.COLOR_BGR2RGB)
                  for i in range(min(face_parsing.BATCH, PRE_FRAMES))]
        x = torch.from_numpy(np.stack([face_parsing.normalize_frame(f) for f in frames])).to(dev)
        with torch.no_grad():
            logit_gpu = net(x[:1]).cpu()
            logit_cpu = copy.deepcopy(net).cpu()(x[:1].cpu())
            bise_ms = cuda_ms(lambda: net(x), 5) / len(frames)
            bise_dms = device_ms(lambda: net(x), 5) / len(frames)
        bise_err = float((logit_gpu - logit_cpu).abs().max() / logit_cpu.abs().max())
        ph["bisenet"] = {"colours": sorted(colours), "frames": PRE_FRAMES,
                         "logits_rel_err_vs_cpu": bise_err, "tol": TOL_BISENET_REL,
                         "ms_per_frame": bise_ms, "device_ms_per_frame": bise_dms,
                         "batch": len(frames)}
        if not colours <= {(255, 255, 255), (255, 0, 0), (0, 255, 0), (0, 0, 255)}:
            raise RuntimeError(f"task 4's masks hold other colours: {sorted(colours)}")
        if not bise_err <= TOL_BISENET_REL:
            raise RuntimeError(f"BiSeNet on the card vs the CPU: {bise_err}")

        # task 8: the focal, the reprojection errors of the landmark fit and
        # of the photometric refinement's output, the photometric loss
        lm = face_tracker.basis_from_file(paths["3DMM"], paths["keys"])
        lms = np.stack([np.loadtxt(os.path.join(root, "ori_imgs", f"{i}.lms"))
                        for i in range(PRE_FRAMES)]).astype(np.float32)

        def reprojection(p):
            with torch.no_grad():
                t = {k: torch.from_numpy(np.asarray(p[k], np.float32)).to(dev)
                     for k in ("id", "exp", "euler", "trans")}
                proj = face_tracker.project(
                    face_tracker.landmarks_from_params(lm, t["id"].expand(PRE_FRAMES, -1),
                                                       t["exp"]),
                    t["euler"], t["trans"], float(np.asarray(p["focal"]).reshape(-1)[0]),
                    (PRE_SIZE / 2.0, PRE_SIZE / 2.0)).cpu().numpy()
            return float(np.linalg.norm(proj - lms, axis=-1).mean())

        track = dict(np.load(os.path.join(root, "track_params.npz")))
        landmark_fit = photo["args"][0]
        reproj = reprojection(landmark_fit)
        # the run's steps: light_iters of stage 1, then those of stage 2
        n_light = inspect.signature(refine).parameters["light_iters"].default
        light = [float(v) for v in photo["losses"][:n_light]]
        fine = [float(v) for v in photo["losses"][n_light:]]
        sweep, coarse = fits[0], fits[1]
        ph["tracker"] = {
            "focal": float(track["focal"][0]), "true_focal": PRE_FOCAL,
            "landmark_fit_reprojection_px_mean": reproj, "max_reprojection_px": MAX_REPROJ_PX,
            "refined_reprojection_px_mean": reprojection(track),
            "sweep": {**sweep, "steps_per_s": sweep["steps"] / sweep["seconds"]},
            "coarse": {**coarse, "steps_per_s": coarse["steps"] / coarse["seconds"]},
            "photometric_seconds": photo["seconds"],
            "light_loss_first_last": [light[0], light[-1]],
            "fine_loss_first_last": [fine[0], fine[-1]],
            "photometric_steps": len(photo["losses"]),
            "pose_err_vs_truth": {f"{k}_{name}": float(np.abs(p[k] - truth[k]).mean())
                                  for k in ("euler", "trans")
                                  for name, p in (("landmark_fit", landmark_fit),
                                                  ("refined", track))}}
        if ph["tracker"]["focal"] != PRE_FOCAL:
            raise RuntimeError(f"the tracker picked focal {ph['tracker']['focal']}")
        if not reproj < MAX_REPROJ_PX:
            raise RuntimeError(f"the landmark fit's mean reprojection error: {reproj} px")
        if not (light[-1] < light[0] and fine[-1] < fine[0]):
            raise RuntimeError(f"photometric loss: light {light[0]} -> {light[-1]}, "
                               f"fine {fine[0]} -> {fine[-1]}")
        # id and exp: the landmark fit on pixel-sized bases; the photometric
        # refinement held to the CPU's
        ph["tracker"]["idexp_fit"] = idexp_fit_check(root, dev)
        ph["tracker"]["photometric_vs_cpu"] = photometric_card_vs_cpu(refine, photo["args"], dev)

        # tasks 5-6: the plate where the background was seen, the torso alpha
        from scipy.ndimage import binary_dilation, distance_transform_edt

        seen = np.zeros((PRE_SIZE, PRE_SIZE), bool)
        for i in range(0, PRE_FRAMES, 20):
            seen |= distance_transform_edt(masks[i] == 0) > 5.0
        plate = cv2.imread(os.path.join(root, "bc.jpg")).astype(np.float64)
        err = np.abs(plate - bg)[seen]
        alpha_ok, alpha_vals = True, set()
        for i in range(PRE_FRAMES):
            a = cv2.imread(os.path.join(root, "torso_imgs", f"{i}.png"), cv2.IMREAD_UNCHANGED)
            alpha_vals |= set(np.unique(a[..., 3]).tolist())
            # opaque on the neck and torso; transparent on the background but
            # for the neck's 3-pixel vertical dilation and the columns task 6
            # paints upward from the neck and torso (53 rows from 4 below
            # the neck's top, 9 from the torso's)
            body = masks[i] >= 2
            reach = binary_dilation(masks[i] == 2, np.ones((3, 1), bool), iterations=3)
            for k in range(1, 58):
                reach[:-k] |= body[k:]
            alpha_ok &= bool((a[..., 3][body] == 255).all()
                             and (a[..., 3][(masks[i] == 0) & ~reach] == 0).all())
        ph["plates"] = {"bg_seen_share": float(seen.mean()),
                        "bg_abs_err_mean": float(err.mean()),
                        "bg_abs_err_p99": float(np.percentile(err, 99)),
                        "tol_mean": TOL_BG_MEAN, "tol_p99": TOL_BG_P99,
                        "torso_alpha_matches_truth": alpha_ok,
                        "alpha_values": sorted(alpha_vals)}
        if not (err.mean() <= TOL_BG_MEAN and np.percentile(err, 99) <= TOL_BG_P99):
            raise RuntimeError(f"bc.jpg vs the background: {ph['plates']}")
        if not alpha_ok or not alpha_vals <= {0, 255}:
            raise RuntimeError(f"torso plates' alpha vs the truth masks: {ph['plates']}")

        # the directory the pipeline wrote trains
        ws = os.path.join(root, "workspace")
        t = time.perf_counter()
        trainer = port_main([root, "--workspace", ws, "--preload", "2", "--data_range", "0",
                             str(PRE_TRAIN_STEPS), "--iters", str(PRE_TRAIN_STEPS)])
        torch.cuda.synchronize()
        losses = trainer.stats["step_loss"]
        ph["train"] = {"steps": trainer.global_step, "loss_first": losses[0],
                       "loss_last": losses[-1], "seconds": time.perf_counter() - t,
                       "files": sorted(f for f in os.listdir(root) if "." in f)}
        if trainer.global_step < PRE_TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"main on the written directory: {ph['train']}")
        del trainer

        # E against its plain version on a photometric step's own inputs
        xy, z, tris, H, W = raster_calls[0]
        got, want = rasterize(xy, z, tris, H, W), rasterize_plain(xy, z, tris, H, W)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        # the bound: the function's own bytes (xy, z and tris read, tri_id
        # written) and ~20 float32 operations for each covered (pixel,
        # triangle) pair, the depth tests any rasterizer makes; the z-buffer's
        # layout floor adds this design's scratch bytes (the u64 buffer set
        # and read, 8 bytes an update at each covered pair); the centres
        # within one pixel of the live triangles' boxes, and those E tests
        # after its trim
        covered = sum(pix.numel() for _, pix, _ in _covered_pairs(xy, z, tris, H, W))
        i0, i1, j0, j1, live = _live_ranges(xy, tris, H, W)
        tested = int(((i1 - i0 + 1) * (j1 - j0 + 1))[live].sum())
        i0, i1, j0, j1 = _trimmed_ranges(xy, tris, H, W)
        trimmed = int(((i1 - i0 + 1).clamp_min(0) * (j1 - j0 + 1).clamp_min(0))[live].sum())
        B, V, T = xy.shape[0], xy.shape[1], tris.shape[0]
        nb = B * V * 12 + T * 12 + B * H * W * 4
        floor_b = nb + B * H * W * (8 + 8) + covered * 8
        bms, by = bound_ms(nb, covered * 20)
        e = {"name": "rasterize", "route": "cuda", "source": "radnerf_tpu_torch/csrc/rasterize.cu",
             "replaces": REPLACES["rasterize"], "launches": launches["rasterize"],
             "max_abs_err": float((got - want).abs().max()), "pixels_differing": n_diff,
             "ms": cuda_ms(lambda: rasterize(xy, z, tris, H, W), 20),
             "device_ms": device_ms(lambda: rasterize(xy, z, tris, H, W), 20),
             "plain_ms": cuda_ms(lambda: rasterize_plain(xy, z, tris, H, W), 2),
             "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": covered * 20,
             "layout_floor_ms": bound_ms(floor_b, 0)[0], "layout_floor_bytes": floor_b,
             "pairs_covered": covered, "pairs_tested": tested, "pairs_tested_after_trim": trimmed,
             "covered_share": float((got >= 0).float().mean()),
             "shapes": {"frames": B, "vertices": V, "triangles": T, "H": H, "W": W},
             "library_ms": None}
        if n_diff:
            raise RuntimeError(f"kernel E differs from rasterize_plain at {n_diff} pixels")

        # the photometric step: fenced (one window of 64 frames, stage 2
        # only: 12 steps less 2, so the window's set-up cancels), profiled
        track_in, lms_in, imgs_in, mesh_in, lm_in, h, w = photo["args"]

        def refine_steps(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            refine(track_in, lms_in, imgs_in, mesh_in, lm_in, h, w, light_iters=0,
                   fine_iters=n, device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        refine_steps(2)
        step_ms = (refine_steps(12) - refine_steps(2)) / 10 * 1e3
        # by class: a profile of the window with 4 steps less one with 1
        profiles = [device_profile(lambda i, n=n: refine(
            track_in, lms_in, imgs_in, mesh_in, lm_in, h, w, light_iters=0, fine_iters=n,
            device=dev), 1) for n in (1, 4)]
        one, four = (photometric_ms_by_class(events, 1) for _, events in profiles)
        by_class = {k: (four[k] - one[k]) / 3 for k in one}
        with open(os.path.join(out_dir, "chip_smoke_preprocess_profile.txt"), "w") as f:
            f.write(profiles[1][0].key_averages().table(sort_by="self_device_time_total",
                                                        row_limit=40))
        ph["photometric_step"] = {
            "fenced_ms": step_ms, "frames": int(imgs_in.shape[0]),
            "fenced": "one stage-2 window of 12 steps less one of 2, over 10",
            "profile": "one stage-2 window of 4 steps less one of 1, over 3",
            "device_ms_by_class": by_class, "device_ms": sum(by_class.values()),
            "device_busy_share": sum(by_class.values()) / step_ms}
        ph["kernel_E"] = {k: e[k] for k in ("device_ms", "ms", "plain_ms", "bound_ms", "bound_by",
                                            "bytes", "layout_floor_ms", "layout_floor_bytes",
                                            "launches", "pixels_differing", "pairs_covered",
                                            "pairs_tested", "pairs_tested_after_trim",
                                            "covered_share", "shapes")}
    report["preprocess"] = ph
    emit({"phase": "preprocess", **ph})
    return e


def _digest(t) -> str:
    """sha256 of a tensor's bytes."""
    import hashlib

    return hashlib.sha256(t.detach().reshape(-1).contiguous().view(torch.uint8)
                          .cpu().numpy().tobytes()).hexdigest()


def _digests(tr) -> dict:
    """sha256 of every array the data-parallel ranks must hold alike: the
    parameters, Adam's moments, the renderer state."""
    arrays = {f"param/{k}": p for k, p in tr.net.named_parameters()}
    names = {id(p): k for k, p in tr.net.named_parameters()}
    for p, st in tr.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            arrays[f"adam/{names[id(p)]}/{k}"] = st[k]
    for f in dataclasses.fields(tr.state):
        arrays[f"state/{f.name}"] = getattr(tr.state, f.name)
    return {k: _digest(v) for k, v in arrays.items()}


def dp_rank(rank, init_file, tmp, root):
    """One rank of the data_parallel phase, in a spawned process: DP_STEPS
    float32 head steps on the directory's dataset with every launch count
    set to 0 just before and read just after (the first step's gradients
    saved by rank 0), DP_BF16_STEPS -O steps, and the 512x512 bench frame
    through ``render_frame_dp``; the ranks' arrays digested. Writes
    ``<tmp>/rank<r>.pt``, or ``<tmp>/rank<r>.err`` with the traceback."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        from radnerf_tpu_torch.config import Options
        from radnerf_tpu_torch.data import TalkingHeadDataset
        from radnerf_tpu_torch.main import float32_matmuls
        from radnerf_tpu_torch.models import mark_untrained_grid
        from radnerf_tpu_torch.ops import _kernels
        from radnerf_tpu_torch.parallel import render_frame_dp
        from radnerf_tpu_torch.scene import build_scene
        from radnerf_tpu_torch.train import Trainer

        float32_matmuls()
        # both ranks load the libraries the parent built; nothing rebuilds
        missing = sorted({k.source.name for k in _kernels.KERNELS.values()
                          if not k.library_path().exists()})
        if missing:
            raise RuntimeError(f"kernel libraries not built: {missing}")
        # NCCL refuses two ranks on one device: the two ranks share cuda:0
        # over gloo, which takes all_reduce and broadcast on CUDA tensors
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=DP_WORLD,
                                timeout=datetime.timedelta(seconds=DP_COLLECTIVE_S))
        dev = torch.device("cuda", 0)
        out = {}
        opt = Options(path=root, exp_eye=True, preload=2, data_parallel=True)
        ds = TalkingHeadDataset(opt, split="train", device=dev)
        tr = Trainer(opt, device=dev)
        out["world"] = tr.world
        tr.state = mark_untrained_grid(tr.render_cfg, tr.state, ds.poses, tuple(ds.intrinsics))
        order = ds.epoch_indices()
        losses, step_ms = [], []
        torch.cuda.synchronize()
        _kernels.reset_launches()
        for i, idx in enumerate(order[:DP_STEPS]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(tr.step(ds, idx)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                out["first_telemetry"] = {k: int(v) for k, v in tr.telemetry.items()}
                if rank == 0:
                    torch.save({k: p.grad.cpu() for k, p in tr.net.named_parameters()
                                if p.grad is not None}, os.path.join(tmp, "grads.pt"))
        out["launches"] = _kernels.launches()
        out.update(losses=losses, step_ms=step_ms, digests=_digests(tr),
                   mean_density=float(tr.state.mean_density))
        del tr, ds
        torch.cuda.empty_cache()

        opt_o = Options(path=root, preload=2, data_parallel=True).apply_O()
        ds = TalkingHeadDataset(opt_o, split="train", device=dev)
        tr = Trainer(opt_o, device=dev)
        tr.state = mark_untrained_grid(tr.render_cfg, tr.state, ds.poses, tuple(ds.intrinsics))
        _kernels.reset_launches()
        losses_o = [float(tr.step(ds, idx)) for idx in ds.epoch_indices()[:DP_BF16_STEPS]]
        torch.cuda.synchronize()
        out["bf16"] = {"losses": losses_o, "launches": _kernels.launches(),
                       "digests": _digests(tr)}
        del tr, ds
        torch.cuda.empty_cache()

        net, rc, state, b, auds = build_scene(512, 512, device=dev)
        batch = dict(b, auds=auds[0])
        render_frame_dp(net, rc, state, batch)  # warm
        torch.cuda.synchronize()
        _kernels.reset_launches()
        res, _ = render_frame_dp(net, rc, state, batch)
        torch.cuda.synchronize()
        frame_launches = _kernels.launches()
        frame_ms = fenced_ms(lambda i: render_frame_dp(net, rc, state, batch), 5)
        out["frame"] = {"telemetry": {k: int(v) for k, v in res.items() if k.startswith("n_")},
                        "launches": frame_launches, "fenced_ms": frame_ms,
                        "image_sha256": _digest(res["image"])}
        if rank == 0:
            torch.save({"image": res["image"].cpu(), "depth": res["depth"].cpu()},
                       os.path.join(tmp, "frame.pt"))
        dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def run_ranks(target, args, n, timeout_s):
    """Run ``target(rank, *args)`` in n spawned processes (the parent holds a
    CUDA context: fork would break it); raise with a rank's traceback (from
    ``<args[1]>/rank<r>.err``), on a nonzero exit or after timeout_s, having
    ended every rank still running."""
    from multiprocessing.connection import wait

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        running = list(procs)
        while running and time.monotonic() < deadline:
            wait([p.sentinel for p in running], timeout=max(deadline - time.monotonic(), 0))
            for p in [p for p in running if not p.is_alive()]:
                p.join()
                running.remove(p)
                if p.exitcode != 0:
                    running = []  # the others may wait on it in a collective
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    errs = {r: open(os.path.join(args[1], f"rank{r}.err")).read() for r in range(n)
            if os.path.exists(os.path.join(args[1], f"rank{r}.err"))}
    codes = [p.exitcode for p in procs]
    if errs or any(c != 0 for c in codes):
        raise RuntimeError(f"data-parallel ranks failed: exit codes {codes}, ended after a "
                           f"failure or the {timeout_s} s timeout: {hung}; {errs}")


def data_parallel_phase(report, root):
    """The data_parallel phase: the port's data parallelism
    (``Options(data_parallel=True)``, ``radnerf_tpu_torch/parallel``) on
    two gloo ranks spawned on this card (``dp_rank``), against this
    process's 1-rank trainer on the same directory: the first step's loss
    and gradients, the ranks' arrays bit for bit alike after DP_STEPS float32
    steps and after DP_BF16_STEPS -O steps, each rank's launches of the
    kernels, and the 512x512 bench frame by ``render_frame_dp`` against the
    1-rank frame (PSNR, summed n_hit). The step ms of two processes sharing
    one card over gloo is no scaling figure."""
    from radnerf_tpu_torch.config import Options
    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.models import mark_untrained_grid, render_rays
    from radnerf_tpu_torch.scene import build_scene
    from radnerf_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # the 1-rank reference: a fresh trainer on a fresh dataset draws the
    # ranks' batches, noises and upkeep jitter
    opt = Options(path=root, exp_eye=True, preload=2)
    ds = TalkingHeadDataset(opt, split="train", device=dev)
    tr = Trainer(opt, device=dev)
    tr.state = mark_untrained_grid(tr.render_cfg, tr.state, ds.poses, tuple(ds.intrinsics))
    order = ds.epoch_indices()
    loss_1 = float(tr.step(ds, order[0]))
    tel_1 = {k: int(v) for k, v in tr.telemetry.items()}
    grads_1 = {k: p.grad.detach().clone() for k, p in tr.net.named_parameters()
               if p.grad is not None}
    step_ms_1 = fenced_ms(lambda i: tr.step(ds, order[1 + i]), DP_STEPS - 1)
    # the 1-rank gradient's own spread: one batch's gradients taken twice
    # (A' adds with float atomics, in another order on each run)
    fixed = tr.next_batch(ds, order[0])
    fixed_noises = torch.rand(opt.num_rays, generator=torch.Generator(dev).manual_seed(9),
                              device=dev)
    twice = []
    for _ in range(2):
        tr.optimizer.zero_grad(set_to_none=True)
        tr.loss(fixed, fixed_noises, tr.global_step)[0].backward()
        twice.append({k: p.grad.detach().clone() for k, p in tr.net.named_parameters()
                      if p.grad is not None})
    spread = {k: rel_err(twice[1][k], g) for k, g in twice[0].items()}
    del tr, ds, twice
    net, rc, state, b, auds = build_scene(512, 512, device=dev)
    with torch.no_grad():
        frame_1 = render_rays(net, rc, state, b["rays_o"], b["rays_d"], auds[0], b["bg_coords"],
                              b["poses"], b["eye"], b["index"], b["bg_color"])[0]
    del net, state, b, auds
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run_ranks(dp_rank, (os.path.join(tmp, "store"), tmp, root), DP_WORLD, DP_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
        grads = torch.load(os.path.join(tmp, "grads.pt"), weights_only=False)
        frame = torch.load(os.path.join(tmp, "frame.pt"), weights_only=False)

    # each gradient within 1e-4 of its largest value plus 1e-7, as the CPU
    # parity tests hold the port's step to JAX's
    grad_err = {}
    for k, g1 in grads_1.items():
        err = float((grads[k].to(dev) - g1).abs().max())
        grad_err[k] = {"max_abs_err": err, "max_abs": float(g1.abs().max()),
                       "err_over_tol": err / (TOL_STEP_GRAD * float(g1.abs().max()) + 1e-7),
                       "spread_1rank_of_largest": spread[k]}
    worst = max(grad_err, key=lambda k: grad_err[k]["err_over_tol"])
    r0 = ranks[0]
    loss_rel = abs(r0["losses"][0] - loss_1) / abs(loss_1)
    differ = sorted({k for r in ranks[1:] for k in r0["digests"]
                     if r["digests"][k] != r0["digests"][k]})
    differ_o = sorted({k for r in ranks[1:] for k in r0["bf16"]["digests"]
                       if r["bf16"]["digests"][k] != r0["bf16"]["digests"][k]})
    frame_psnr = psnr(frame["image"], frame_1["image"].cpu())
    n_hit_1 = int(frame_1["n_hit"])
    ph = {
        "ranks": DP_WORLD, "backend": "gloo, both ranks on cuda:0",
        "world": [r["world"] for r in ranks],
        "steps": DP_STEPS, "bf16_steps": DP_BF16_STEPS,
        "num_rays_global": Options().num_rays,
        "launches_per_rank": [r["launches"] for r in ranks],
        "bf16_launches_per_rank": [r["bf16"]["launches"] for r in ranks],
        "frame_launches_per_rank": [r["frame"]["launches"] for r in ranks],
        "first_step": {"loss_2ranks": r0["losses"][0], "loss_1rank": loss_1,
                       "loss_rel_err": loss_rel, "tol_rel": TOL_STEP_REL,
                       "grad_worst": worst, **grad_err[worst],
                       "tol_grad": f"{TOL_STEP_GRAD} x max|g| + 1e-7",
                       "spread_1rank_worst": max(spread, key=spread.get),
                       "spread_1rank_of_largest": max(spread.values()),
                       "telemetry_2ranks": r0["first_telemetry"],
                       "telemetry_1rank": tel_1},
        "losses_per_rank": [r["losses"] for r in ranks],
        "bf16_losses_per_rank": [r["bf16"]["losses"] for r in ranks],
        "arrays_compared": len(r0["digests"]), "arrays_differing": differ,
        "bf16_arrays_compared": len(r0["bf16"]["digests"]), "bf16_arrays_differing": differ_o,
        "mean_density_per_rank": [r["mean_density"] for r in ranks],
        "frame": {"psnr_vs_1rank_db": frame_psnr, "psnr_min_db": MIN_FRAME_PSNR_DB,
                  "max_abs_err": float((frame["image"] - frame_1["image"].cpu()).abs().max()),
                  "n_hit_2ranks": r0["frame"]["telemetry"]["n_hit"], "n_hit_1rank": n_hit_1,
                  "same_image_on_every_rank": len({r["frame"]["image_sha256"]
                                                   for r in ranks}) == 1,
                  "fenced_ms_per_rank": [r["frame"]["fenced_ms"] for r in ranks]},
        "step_ms_median_2ranks_sharing_one_card_gloo": [
            float(np.median(r["step_ms"][1:])) for r in ranks],
        "step_ms_1rank_median": float(np.median(step_ms_1)),
        "step_ms_note": "two processes sharing one card, gradients all-reduced through "
                        "the host by gloo: not a scaling figure",
        "ranks_seconds": ranks_s, "seconds": time.perf_counter() - t_phase,
    }
    report["data_parallel"] = ph
    emit({"phase": "data_parallel", **ph})
    for r, rk in enumerate(ranks):
        missing = [k for k in TRAIN_KERNELS if rk["launches"][k] <= 0]
        missing += [k for k in BF16_KERNELS if rk["bf16"]["launches"][k] <= 0]
        missing += [k for k in FRAME_KERNELS if rk["frame"]["launches"][k] <= 0]
        if missing:
            raise RuntimeError(f"data parallel rank {r} did not launch {missing}")
        if rk["world"] != (r, DP_WORLD):
            raise RuntimeError(f"rank {r} ran in world {rk['world']}")
        if not all(math.isfinite(v) for v in rk["losses"] + rk["bf16"]["losses"]):
            raise RuntimeError(f"rank {r} losses {rk['losses']} {rk['bf16']['losses']}")
    if not loss_rel <= TOL_STEP_REL or not grad_err[worst]["err_over_tol"] <= 1.0:
        raise RuntimeError(f"the 2-rank step is not the 1-rank step: {ph['first_step']}")
    if r0["first_telemetry"] != tel_1:
        raise RuntimeError(f"2-rank telemetry {r0['first_telemetry']} != 1-rank {tel_1}")
    if differ or differ_o or any(r["losses"] != r0["losses"] for r in ranks):
        raise RuntimeError(f"the ranks diverged: {differ[:8]} {differ_o[:8]}")
    if not frame_psnr >= MIN_FRAME_PSNR_DB or ph["frame"]["n_hit_2ranks"] != n_hit_1 \
            or not ph["frame"]["same_image_on_every_rank"]:
        raise RuntimeError(f"the data-parallel frame: {ph['frame']}")


if __name__ == "__main__":
    main()
