#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (radnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three paths through the hand-written CUDA kernels: one
512x512 head+torso inference frame of the bench scene
(radnerf_tpu_torch/scene.py, a copy of bench.py's) at the shipped model
widths in float32 (kernels A, B, C); a head-stage training run from scratch
at full width (A, B, C and the backward kernels A', C'); and the gather
study at the Pallas row-loop kernel's shapes (kernel D).

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

Training (``NetworkConfig(torso=False, exp_eye=True)``, ``Options``
defaults: 65,536 rays, grid 128, max_steps 16, upkeep every 16 steps):
  7. train: an in-memory dataset of 512x512 targets rendered by the frame
     path, the trainer started as main.py starts it (seeded init, empty
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
     due, batch, step) fenced call by call, so the step's ms and the
     upkeep's; a torch.profiler breakdown of 3 steps; the batch preparation
     alone; and the kernels beside their bounds, plain versions and (for
     D) ``index_select``: A' on the step's points and on the spread ones; A
     on the step's D = 3 points (held bit for bit to its twin); B (with
     noises) and C on phase 8's inputs, with their launches in the run.

Each kernel's ``ms`` comes from ``cuda_ms``, whose events bracket the
calls as the host enqueues them (a kernel shorter than its wrapper's Python
reads the host); ``device_ms`` times the same calls queued on the card.
Kernel C's entries also carry its layout floor: the bytes the [N, S]
lattice makes any compositor move (whole valid rows, whole 32-byte sectors
around each processed step), which its bound does not count.

Each phase prints one JSON line; then the kernels line, the nvidia-smi line,
and last the device line. Any failed check raises, and the script exits
non-zero. It exits non-zero without a CUDA device, and outside the
repository (the port is imported from the checkout). A full report goes to
chiprun_out/chip_smoke.json, the profiler's tables to
chiprun_out/chip_smoke_profile.txt and chiprun_out/chip_smoke_train_profile.txt.
"""

import copy
import json
import math
import os
import subprocess
import sys
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

# the frame's kernels, the training run's, the gather study's
FRAME_KERNELS = ("grid_encode", "march_rays", "composite_rays")
TRAIN_KERNELS = FRAME_KERNELS + ("grid_encode_backward", "composite_rays_backward")
REPLACES = {
    "grid_encode": "radnerf_tpu/ops/grid_encode.py:168",
    "grid_encode_backward": "radnerf_tpu/ops/grid_encode.py:168",
    "march_rays": "radnerf_tpu/ops/marching.py:374",
    "composite_rays": "radnerf_tpu/ops/marching.py:731",
    "composite_rays_backward": "radnerf_tpu/ops/marching.py:731",
    "row_gather": "scripts/bench_gather.py:79",
}
TRAIN_STEPS = 48
TRAIN_FRAMES = 4
TRAIN_SIZE = 512  # the targets' height and width
PROFILED_STEPS = 3
GATHER_ROWS, GATHER_WIDTH, GATHER_TABLES = 2 * 1024 * 1024, 16, (4096, 65536)


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
        pg = torch.floor(x01 * spec.level_scale(level) + 0.5).long()
        for corner in range(1 << D):
            bits = torch.tensor([(corner >> d) & 1 for d in range(D)], device=x.device)
            rows = _corner_index(spec, level, pg + bits) + spec.offsets[level]
            counts += torch.bincount(rows, minlength=spec.n_embeddings)
    return counts, int(inb.sum())


def grid_work(x, spec, bound):
    """Bytes and flops one grid encode needs for these points: the points,
    the output, and each table row the in-bounds points touch, read once;
    per in-bounds (point, level) 3D flops for the position, 2D per corner
    weight and 2C per corner accumulation."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    counts, n_in = row_counts(x, spec, bound)
    n_rows = int((counts > 0).sum())
    n_bytes = x.numel() * 4 + x.shape[0] * L * C * 4 + n_rows * C * 4
    n_flops = n_in * L * (3 * D + (1 << D) * (2 * D + 2 * C))
    return n_bytes, n_flops


def grid_backward_work(x, spec, bound, need_x):
    """Bytes and flops the grid-encode backward needs: the points and
    grad_out read once, each touched row of the table gradient written once
    (and, for the x gradient, each touched table row read once and grad_x
    written); per in-bounds (point, level) 3D flops for the position, per
    corner 2D for the weight and C for the weighted gradient, and with the x
    gradient 2C for the dot with the row, 2D for its weight derivatives and
    2D to scale the position gradient."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    counts, n_in = row_counts(x, spec, bound)
    n_rows = int((counts > 0).sum())
    n_bytes = x.numel() * 4 + x.shape[0] * L * C * 4 + n_rows * C * 4
    per_corner = 2 * D + C
    if need_x:
        n_bytes += n_rows * C * 4 + x.numel() * 4
        per_corner += 2 * C + 2 * D
    n_flops = n_in * L * (3 * D + (1 << D) * per_corner + (2 * D if need_x else 0))
    return n_bytes, n_flops


def march_work(rays_o, rays_d, nears, fars, window, mcfg, noises=None):
    """Bytes and flops the march needs: the ray geometry, window and noises,
    the distinct sigma bytes its steps look up, the [N, S] outputs; ~20
    flops per step walked (position, clamp, cell). The walk is the kernel's:
    the orbit starts at ``nears + dt * noises`` where noises are given, and
    a cell is ``floor(0.5 * (p / mip_bound + 1) * H)``."""
    from radnerf_tpu_torch.ops import morton3d

    N, S, K, H = rays_o.shape[0], mcfg.n_sample_slots, mcfg.n_march_iters, mcfg.grid_size
    dt = float(np.float32(mcfg.dt_min))
    mip_bound = float(np.float32(min(1.0, mcfg.bound)))
    t_lo, t_hi = window
    t0 = nears if noises is None else nears + dt * noises
    k0 = torch.clamp(torch.floor((t_lo - t0) / torch.full_like(t0, dt)), min=0.0)
    t_end = torch.minimum(fars, t_hi)
    cells, steps = [], 0
    for k in range(K):
        t = t0 + (k0 + k) * dt
        walk = t < t_end
        if not bool(walk.any()):
            break
        steps += int(walk.sum())
        p = torch.clamp(rays_o[walk] + t[walk, None] * rays_d[walk], -mcfg.bound, mcfg.bound)
        c = torch.clamp(torch.floor(0.5 * (p / mip_bound + 1.0) * H), 0, H - 1).long()
        cells.append(morton3d(c))
    n_cells = int(torch.unique(torch.cat(cells)).numel()) if cells else 0
    n_in = 24 + 16 + (4 if noises is not None else 0)
    n_bytes = N * n_in + n_cells + N * S * (4 + 4 + 1 + 12) + N * 4
    return n_bytes, 20 * steps


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


class FrameDataset:
    """In-memory head-stage dataset: ``n_frames`` targets rendered by the
    port's frame path from the bench camera, each with its own audio window
    (numpy seed-1 features); the torso-over-background layer of the same
    render is the background plate, as the head stage's torso plate is; a
    central face rect; eye 0.25. Numpy, with what the trainer reads."""

    def __init__(self, net, rc, state, batch, n_frames, H, W, num_rays, seed=1):
        from radnerf_tpu_torch.data import get_audio_features, get_bg_coords
        from radnerf_tpu_torch.models import render_rays

        self.H, self.W, self.num_rays = H, W, num_rays
        self.rng = np.random.default_rng(seed)
        self.auds = self.rng.normal(size=(n_frames, 44, 16)).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.0, 0.0, -3.3]
        focal = 1200.0 * H / 450.0  # the bench camera (scene.build_scene)
        self.poses = np.stack([pose] * n_frames)
        self.intrinsics = np.array([focal, focal, W / 2, H / 2])
        self.eye_area = np.full((n_frames, 1), 0.25, np.float32)
        self.face_rect = (H // 4, 3 * H // 4, W // 4, 3 * W // 4)
        self.bg_coords = get_bg_coords(H, W)
        self.images, self.plates = [], []
        dev = batch["rays_o"].device
        for i in range(n_frames):
            aud = torch.from_numpy(get_audio_features(self.auds, 2, i)).to(dev)
            res, _ = render_rays(net, rc, state, batch["rays_o"], batch["rays_d"], aud,
                                 batch["bg_coords"], batch["poses"], batch["eye"],
                                 batch["index"], batch["bg_color"])
            self.images.append(res["image"].cpu().numpy())
            self.plates.append(res["torso_color"].cpu().numpy())

    def __len__(self):
        return len(self.images)

    def epoch_indices(self):
        return self.rng.permutation(len(self))

    def collate(self, i):
        from radnerf_tpu_torch.data import convert_poses, get_audio_features, get_rays

        rays = get_rays(self.poses[i], self.intrinsics, self.H, self.W, self.num_rays,
                        rng=self.rng)
        inds = rays["inds"]
        xmin, xmax, ymin, ymax = self.face_rect
        return {
            "auds": get_audio_features(self.auds, 2, i), "index": i,
            "H": self.H, "W": self.W, "rays_o": rays["rays_o"], "rays_d": rays["rays_d"],
            "face_mask": ((rays["j"] >= xmin) & (rays["j"] < xmax)
                          & (rays["i"] >= ymin) & (rays["i"] < ymax)),
            "eye": self.eye_area[i].reshape(1, 1),
            "bg_color": self.plates[i][inds], "images": self.images[i][inds],
            "bg_coords": self.bg_coords[inds], "poses": convert_poses(self.poses[i][None]),
        }


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

    report = {}
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")

    # ---- 1. device
    smi = nvidia_smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
        "ptxas": {k: [l.strip() for l in v.splitlines() if "registers" in l or "spill" in l]
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

    from radnerf_tpu_torch.config import Options

    kernels += train_phases(report, out_dir, (net, rc, state, b), Options(exp_eye=True))
    kernels.append(gather_phase(report, dev))

    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: kern[k] for k in keys} for kern in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def train_phases(report, out_dir, scene, opt):
    """Phases 7, 8 and 10 (training) on the scene's device: ``scene`` is
    (net, render config, state, batch) of the frame, which renders the
    targets; ``opt`` the trainer's options. Returns the kernels-line
    entries of A' and C'."""
    from radnerf_tpu_torch.data import get_audio_features
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

    dev = scene[3]["rays_o"].device
    t0 = time.perf_counter()
    ds = FrameDataset(*scene, TRAIN_FRAMES, TRAIN_SIZE, TRAIN_SIZE, opt.num_rays)
    data_s = time.perf_counter() - t0
    tr = Trainer(opt, device=dev)
    rc, net = tr.render_cfg, tr.net

    # the fixed batch, and the model at step 0 on a grid upkept as the
    # trainer's first upkeep does (its own jitter), for the loss check
    fixed = tr.next_batch(ds, 0)
    fixed_noises = torch.rand(opt.num_rays, generator=torch.Generator(dev).manual_seed(123),
                              device=dev)
    with torch.no_grad():
        aud0 = torch.from_numpy(get_audio_features(ds.auds, opt.att, 0)).to(dev)
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
                   "seeded init (torch.Generator seed 0)"}
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
            call["plain_ms"] = cuda_ms(lambda: grid_encode_backward_plain(
                x, emb, go, spec, bound, need_x=need_x), 3)
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
    return kernels


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


if __name__ == "__main__":
    main()
