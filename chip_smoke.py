#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (radnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- one 512x512 head+torso inference frame of the
bench scene (radnerf_tpu_torch/scene.py, a copy of bench.py's) at the
shipped model widths in float32 -- through the hand-written CUDA kernels:

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
     one exists) a single PyTorch call.

Each phase prints one JSON line; then the kernels line, the nvidia-smi line,
and last the device line. Any failed check raises, and the script exits
non-zero. It exits non-zero without a CUDA device, and outside the
repository (the port is imported from the checkout). A full report goes to
chiprun_out/chip_smoke.json, the profiler's table to
chiprun_out/chip_smoke_profile.txt.
"""

import copy
import json
import math
import os
import subprocess
import sys
import time

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

REPLACES = {
    "grid_encode": "radnerf_tpu/ops/grid_encode.py:168",
    "march_rays": "radnerf_tpu/ops/marching.py:374",
    "composite_rays": "radnerf_tpu/ops/marching.py:731",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the current stream, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
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


def grid_work(x, spec, bound):
    """Bytes and flops one grid encode needs for these points: the points,
    the output, and each table row the in-bounds points touch, read once;
    per in-bounds (point, level) 3D flops for the position, 2D per corner
    weight and 2C per corner accumulation."""
    from radnerf_tpu_torch.ops.grid_encode import _corner_index

    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    x01 = (x + bound) / (2.0 * bound)
    inb = ((x01 >= 0) & (x01 <= 1)).all(dim=-1)
    x01 = x01[inb]
    rows = []
    for level in range(L):
        pg = torch.floor(x01 * spec.level_scale(level) + 0.5).long()
        for corner in range(1 << D):
            bits = torch.tensor([(corner >> d) & 1 for d in range(D)], device=x.device)
            rows.append(_corner_index(spec, level, pg + bits) + spec.offsets[level])
    n_rows = int(torch.unique(torch.cat(rows)).numel())
    n_in = int(inb.sum())
    n_bytes = x.numel() * 4 + x.shape[0] * L * C * 4 + n_rows * C * 4
    n_flops = n_in * L * (3 * D + (1 << D) * (2 * D + 2 * C))
    return n_bytes, n_flops


def march_work(rays_o, rays_d, nears, fars, window, sigma_bytes, mcfg):
    """Bytes and flops the march needs: the ray geometry and window, the
    distinct sigma bytes its steps look up, the [N, S] outputs; ~20 flops
    per step walked (position, clamp, cell)."""
    from radnerf_tpu_torch.ops import morton3d

    N, S, K, H = rays_o.shape[0], mcfg.n_sample_slots, mcfg.n_march_iters, mcfg.grid_size
    dt = mcfg.dt_min
    t_lo, t_hi = window
    k0 = torch.clamp(torch.floor((t_lo - nears) / dt), min=0.0)
    t_end = torch.minimum(fars, t_hi)
    cells, steps = [], 0
    for k in range(K):
        t = nears + (k0 + k) * dt
        walk = t < t_end
        if not bool(walk.any()):
            break
        steps += int(walk.sum())
        p = torch.clamp(rays_o[walk] + t[walk, None] * rays_d[walk], -mcfg.bound, mcfg.bound)
        c = torch.clamp(torch.floor(0.5 * (p + 1.0) * H), 0, H - 1).long()
        cells.append(morton3d(c))
    n_cells = int(torch.unique(torch.cat(cells)).numel()) if cells else 0
    n_bytes = N * (24 + 16) + n_cells + N * S * (4 + 4 + 1 + 12) + N * 4
    return n_bytes, 20 * steps


def composite_work(sig, dts, valid, T_thresh):
    """Bytes and flops compositing needs: the valid byte of each step up to
    the early stop, 28 B (sigma, dt, t, rgb, ambient) and ~15 flops for each
    valid step it processes, 24 B out per ray."""
    N, S = sig.shape
    T = torch.ones(N, device=sig.device)
    alive = torch.ones(N, dtype=torch.bool, device=sig.device)
    examined = processed = 0
    for s in range(S):
        examined += int(alive.sum())
        v = alive & valid[:, s]
        processed += int(v.sum())
        T = torch.where(v, T * torch.exp(-sig[:, s] * dts[:, s]), T)
        alive = alive & (T >= T_thresh)
    return examined + processed * 28 + N * 24, processed * 15


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
        "ptxas": {k: [l.strip() for l in v.splitlines() if "registers" in l]
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
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")

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
    g = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "calls": {}}
    for name, args in grid_calls.items():
        ms = cuda_ms(lambda: grid_encode(*args), 20)
        pms = cuda_ms(lambda: grid_encode_plain(*args), 3)
        nb, nf = grid_work(args[0], args[2], args[3])
        bms, by = bound_ms(nb, nf)
        g["calls"][name] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                            "bytes": nb, "flops": nf, "n_points": int(args[0].shape[0])}
        g["ms"] += ms
        g["plain_ms"] += pms
        g["bytes"] += nb
        g["flops"] += nf
    bms, by = bound_ms(g["bytes"], g["flops"])
    kernels.append({"name": "grid_encode", "ms": g["ms"], "plain_ms": g["plain_ms"],
                    "bound_ms": bms, "bound_by": by,
                    "max_abs_err": checks["grid_encode"]["max_abs_err"],
                    "calls": g["calls"]})

    nb, nf = march_work(o, d, nears, fars, window, state.sigma_bytes, mcfg)
    bms, by = bound_ms(nb, nf)
    kernels.append({"name": "march_rays", "ms": cuda_ms(lambda: march_rays(*m_args), 20),
                    "plain_ms": cuda_ms(lambda: march_rays_plain(*m_args), 3),
                    "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
                    "max_abs_err": march_err})

    nb, nf = composite_work(c_args[0], c_args[2], c_args[4], rc.T_thresh)
    bms, by = bound_ms(nb, nf)
    kernels.append({"name": "composite_rays",
                    "ms": cuda_ms(lambda: composite_rays(*c_args, **c_kw), 20),
                    "plain_ms": cuda_ms(lambda: composite_rays_plain(*c_args, **c_kw), 3),
                    "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": nf,
                    "max_abs_err": checks["composite_rays"]["max_abs_err"]})
    for k in kernels:
        # no single PyTorch call computes any of the three functions
        k.update(route="cuda", source=f"radnerf_tpu_torch/csrc/{k['name']}.cu",
                 replaces=REPLACES[k["name"]], launches=launches[k["name"]],
                 library_ms=None)
    report["timing"]["kernels"] = kernels
    emit({"phase": "timing", "frame_ms": frame_ms, "fps": report["timing"]["fps"],
          "kernel_ms": {k["name"]: k["ms"] for k in kernels}})

    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: kern[k] for k in keys} for kern in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
