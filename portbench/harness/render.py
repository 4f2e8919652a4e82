"""Traffic of kind ``render``: offline video of a trained avatar, frames back
to back through ``Trainer.next_batch`` and ``Trainer.test_step`` as
``Trainer.test`` renders them, each ending with its uint8 image on the
host.

The avatar (the bench scene's recipe, ``reference/scene.py``) and its
weights are made from the seed on the device and handed to the program's
trainer as a loaded checkpoint would leave it: the parameters copied in,
the renderer state made from the grids. The pose track (a fixed smooth
motion from the mix's parameters), the eye values and the audio features
are written as the pose json and the feature file that ``infer`` reads;
the seed chooses the weights, the audio and the eye values. Every run
renders the same number of frames (``common.window_count``) from the
track's first frame, so every seed's window holds the same poses in the
same order. After the window the frames at positions drawn from the seed
are rendered again by the plain reference and compared (``check``)."""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..reference import data as rdata
from ..reference import field as fld
from ..reference import render as rrender
from ..reference import scene as rscene
from . import common
from . import trace as tr
from .program import configs, load_params, record_calls


def _write_inputs(root, traffic, audio_in_dim, seed):
    """The pose json and the audio features of the track; returns (pose path,
    audio path, transform matrices, eye values, audio [T, K, 16])."""
    T, H, W = traffic["track_frames"], traffic["H"], traffic["W"]
    mats = rscene.track(T, traffic["amp_deg"], traffic["amp_t"], traffic["cycles"],
                        traffic["options"]["scale"])
    rng = np.random.default_rng(seed)
    lo, hi = traffic["eye_range"]
    eye = rng.uniform(lo, hi, T)
    feats = rng.normal(size=(T, 16, audio_in_dim)).astype(np.float32)
    pose_path, aud_path = os.path.join(root, "track.json"), os.path.join(root, "track_eo.npy")
    with open(pose_path, "w") as f:
        json.dump({"focal_len": 1200.0 * H / 450.0, "cx": W / 2, "cy": H / 2,
                   "frames": [{"transform_matrix": m.tolist(), "eye_ratio": float(e)}
                              for m, e in zip(mats, eye)]}, f)
    np.save(aud_path, feats)
    return pose_path, aud_path, mats, eye, feats.transpose(0, 2, 1).copy()


def run(ctx: dict, seed: int, seconds: float, trace: bool) -> dict:
    import torch

    from radnerf_tpu_torch.data import PoseAudioDataset
    from radnerf_tpu_torch.models import make_state
    from radnerf_tpu_torch.train import Trainer

    cfg, traffic = ctx["config"], ctx["traffic"]
    dev = common.device()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    H, W, T = traffic["H"], traffic["W"], traffic["track_frames"]
    r = cfg["render"]
    root = tempfile.mkdtemp(prefix="portbench_render_")
    try:
        pose_path, aud_path, mats, eye, auds = _write_inputs(
            root, traffic, cfg["model"]["audio_in_dim"], seed)
        opt, net_cfg, render_cfg = configs(cfg, traffic, pose=pose_path, aud=aud_path, seed=seed)
        arch = fld.Arch(cfg["model"], torso=opt.torso)
        params = fld.draw_params(arch, "avatar", seed, dev)
        occ, torso = rscene.avatar_grids(dev, r["grid_size"])
        if traffic.get("occupancy") == "full":
            occ = torch.full_like(occ, 300.0)
        trainer = Trainer(opt, net_cfg, render_cfg, device=dev, name="ngp", workspace=None,
                          mute=True)
        load_params(trainer.net, params)
        trainer.state = make_state(trainer.render_cfg, occ.clone(), torso.clone(),
                                   float(occ.mean()), float(torso.mean()))
        ds = PoseAudioDataset(opt, device=dev)
        rng = np.random.default_rng(seed)
        n_first = traffic["check_within"]
        positions = sorted({int(v) for v in rng.integers(0, n_first, traffic["sample_frames"])})
        seq, kept, parts = [], {}, []

        def frame(k, window_pos=None):
            idx = k % T
            seq.append(idx)
            t0 = time.perf_counter()
            with tr.span("portbench.batch"):
                batch = trainer.next_batch(ds, idx)
            t1 = time.perf_counter()
            with tr.span("portbench.render"):
                pred, _depth = trainer.test_step(batch)
            t2 = time.perf_counter()
            img = (np.clip(pred, 0, 1) * 255).astype(np.uint8)
            parts.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
            if window_pos in positions:
                kept[window_pos] = (len(seq) - 1, pred.copy(), img)

        for k in range(traffic["warmup_frames"]):
            frame(k)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_done = time.time()
        k0, times, counts, trace_out = len(seq), [], {}, {}
        n = (traffic["trace_frames"] if trace
             else common.window_count(traffic, seconds, n_first))
        probe = common.host_probe()
        if trace:
            with record_calls(counts), tr.profiled(trace_out):
                for i in range(n):
                    t0 = time.perf_counter()
                    frame(k0 + i, i)
                    times.append(time.perf_counter() - t0)
            window_s = trace_out["window_s"]
        else:
            t_start = time.perf_counter()
            for i in range(n):
                t0 = time.perf_counter()
                frame(k0 + i, i)
                times.append(time.perf_counter() - t0)
            window_s = time.perf_counter() - t_start
        host = common.host_share(probe, common.host_probe())
        memory = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        del trainer, ds
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"frames": n, "window_s": window_s, "setup_done": setup_done, "memory": memory,
           "precision": cfg["precision"], "arch": arch, "trace": trace_out, "counts": counts,
           "pixels": H * W, "host": host,
           "replay": {"params": params, "occ": occ, "torso": torso, "mats": mats, "eye": eye,
                      "auds": auds, "seq": seq, "kept": kept}}
    if not trace:
        out["metrics"] = {"render_fps": n / window_s,
                          "frame_ms_p95": common.percentile([t * 1e3 for t in times], 95)}
    out["fifths_ms"] = fifths([t * 1e3 for t in times])
    w = parts[-n:]
    out["parts_fifths_ms"] = {name: fifths([p[i] * 1e3 for p in w])
                              for i, name in enumerate(("batch", "render", "u8"))}
    if counts.get("samples"):
        out["samples_range"] = [min(s for s, _, _ in counts["samples"]),
                                max(s for s, _, _ in counts["samples"])]
    return out


def fifths(values) -> list:
    """The mean of each fifth of a run's values, in order (drift within a
    window shows here)."""
    n = len(values)
    cuts = [round(n * i / 5) for i in range(6)]
    return [sum(values[a:b]) / max(b - a, 1) for a, b in zip(cuts[:-1], cuts[1:])]


def check(ctx: dict, res: dict) -> dict:
    """The program's kept frames against the reference's, in the
    configuration's precision."""
    rp = res["replay"]
    ref = reference_frames(ctx, res, ctx["config"]["precision"])
    mine = {pos: rp["kept"][pos][1] for pos in ref}
    return dict(gaps(mine, ref), frames_compared=len(ref))


def controls(ctx: dict, res: dict) -> dict:
    """The same gaps, of the reference computed in the control's precision
    put in the program's place."""
    ref = reference_frames(ctx, res, ctx["config"]["precision"])
    low = reference_frames(ctx, res, ctx["config"]["control"])
    return {f"control.{k}": v for k, v in gaps(low, ref).items()}


def gaps(frames: dict, ref: dict) -> dict:
    """The worst and the root-mean-square gap between two sets of float
    images [H, W, 3] (numpy or tensors), position by position."""
    import torch

    worst, sq, count = 0.0, 0.0, 0
    for pos, r in ref.items():
        gap = (torch.as_tensor(frames[pos]).to(r.device).reshape(-1, 3).double()
               - r.reshape(-1, 3).double()).abs()
        worst = max(worst, float(gap.max()))
        sq += float((gap * gap).sum())
        count += gap.numel()
    return {"frame_max_abs": worst, "frame_rmse": (sq / max(count, 1)) ** 0.5}


def reference_inputs(mats, eye, options):
    """The poses and eye values the dataset derives in test mode: NGP poses
    smoothed over the path window, the eye values over 3."""
    poses = np.stack([rdata.nerf_matrix_to_ngp(np.asarray(m, np.float32), options["scale"])
                      for m in mats])
    if options.get("smooth_path"):
        poses = rdata.smooth_camera_path(poses, options["smooth_path_window"])
    eye = np.asarray(eye, np.float32)
    return poses, (rdata.smooth_1d(eye) if options.get("smooth_eye") else eye)


def audio_codes(params, arch, auds, seq, dev, smooth: bool):
    """The audio code at each rendered frame: with ``smooth``, the EMA over
    every frame rendered since the state was made, in order."""
    import torch

    auds_t = torch.from_numpy(auds).to(dev)
    with torch.no_grad():
        enc = {i: fld.encode_audio(params, arch, rdata.audio_window(auds_t, i))
               for i in sorted(set(seq))}
        codes, code = [], None
        for i in seq:
            code = enc[i] if code is None or not smooth else 0.35 * code + (1 - 0.35) * enc[i]
            codes.append(code)
    return codes


def reference_frames(ctx: dict, res: dict, precision: str) -> dict:
    """The plain reference's float image at each kept window position,
    computed in ``precision`` (the configuration's, or its control's)."""
    import torch

    cfg, traffic, rp = ctx["config"], ctx["traffic"], res["replay"]
    options, r = traffic["options"], cfg["render"]
    H, W = traffic["H"], traffic["W"]
    arch, dev = res["arch"], rp["occ"].device
    rs = rrender.RenderSettings(r, torso=options["torso"],
                                smooth_lips=options.get("smooth_lips", False))
    mean = float(rp["occ"].mean())
    state = rrender.make_state(rs, rp["occ"], rp["torso"], mean, float(rp["torso"].mean()),
                               min(mean, r["density_thresh"]), arch.audio_dim)
    poses, eyes = reference_inputs(rp["mats"], rp["eye"], options)
    codes = audio_codes(rp["params"], arch, rp["auds"], rp["seq"], dev, rs.smooth_lips)
    fl = 1200.0 * H / 450.0
    intr = (fl, fl, W / 2, H / 2)
    pix = torch.arange(H * W, device=dev)
    bg_coords = torch.from_numpy(rdata.get_bg_coords(H, W)).to(dev)
    out = {}
    with torch.no_grad(), fld.lower_precision(precision):
        for pos in sorted(rp["kept"]):
            k = rp["kept"][pos][0]
            idx = rp["seq"][k]
            ro, rd = rdata.rays_from_pixels(torch.from_numpy(poses[idx]).to(dev), intr, pix, W)
            batch = {"rays_o": ro, "rays_d": rd, "bg_coords": bg_coords,
                     "poses": torch.from_numpy(rdata.convert_poses(poses[idx][None])).to(dev),
                     "eye": torch.tensor([[float(eyes[idx])]], device=dev),
                     "bg_color": torch.ones((H * W, 3), device=dev), "index": idx}
            out[pos] = rrender.render(rp["params"], arch, rs, state, batch,
                                      fld.rounding(precision), enc_a=codes[k])["image"]
    return out
