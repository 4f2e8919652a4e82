"""Traffic of kind ``render_triplane``: offline video of a trained ER-NeRF
avatar (``--arch ernerf``), frames back to back through
``Trainer.next_batch`` and ``Trainer.test_step`` to the uint8 image on the
host, as the ``render`` kind drives RAD-NeRF's (``render.py``, whose inputs,
timing and comparison helpers this uses as they are).

The avatar is ER-NeRF's field drawn from the seed (``field_triplane``'s
``avatar`` recipe) on the avatar occupancy of ``scene.py``, handed to the
program's trainer as a loaded checkpoint would leave it. After the window
the frames at positions drawn from the seed are rendered again by the plain
reference (``render_triplane.py``) and compared (``check``).

A traced run profiles ``trace_frames`` frames and records, beside what
``program.record_calls`` records, the points of each call of kernel A-tri
(``ops.triplane_encode``, at the network's entry point) and the device
seconds of the kernels launched inside the program's ``radnerf.render.field``
range and its children (``field_device_s``: each launch's correlation id ties
it to its kernel), which ``metrics/*.render_triplane.py`` read."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..reference import field_triplane as ftri
from ..reference import data as rdata
from ..reference import render as rrender
from ..reference import render_triplane as rtri
from ..reference import scene as rscene
from . import common
from . import heap
from . import render as hrender
from . import trace as tr
from .program import configs, load_params, record_calls

FIELD_SPAN = "radnerf.render.field"


@contextlib.contextmanager
def record_triplane(out: dict):
    """While the block runs, ``out["triplane"]`` gets each A-tri call's
    points (detached), spec and bound."""
    import radnerf_tpu_torch.models.network_triplane as tri

    enc0 = tri.triplane_encode
    out["triplane"] = []

    def encode(x, tables, spec, bound=1.0):
        out["triplane"].append({"x": x.detach(), "spec": spec, "bound": bound})
        return enc0(x, tables, spec, bound)

    tri.triplane_encode = encode
    try:
        yield
    finally:
        tri.triplane_encode = enc0


def field_device_seconds(events: list) -> float:
    """Device seconds of the kernels and copies whose launches lie inside
    the program's field range (``radnerf.render.field`` and its children):
    the host's launch events in the range give correlation ids, the device's
    events of those ids their times."""
    spans = tr._union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                       if e.get("cat", "").lower() == "user_annotation"
                       and (e.get("name") == FIELD_SPAN
                            or e.get("name", "").startswith(FIELD_SPAN + "."))])
    if not spans:
        return 0.0
    starts = np.array([s for s, _ in spans])
    ends = np.array([t for _, t in spans])
    ids = set()
    for e in events:
        if e.get("cat", "").lower() not in ("cuda_runtime", "cuda_driver") or "ts" not in e:
            continue
        corr = (e.get("args") or {}).get("correlation")
        k = int(np.searchsorted(starts, float(e["ts"]), side="right")) - 1
        if corr is not None and k >= 0 and float(e["ts"]) <= ends[k]:
            ids.add(corr)
    return sum(float(e["dur"]) * 1e-6 for e in events
               if e.get("cat", "").lower() in tr.DEVICE_CATS and "dur" in e
               and (e.get("args") or {}).get("correlation") in ids)


@contextlib.contextmanager
def profiled(out: dict):
    """``trace.profiled``'s window (its summary in ``out``), with the field's
    device seconds (``field_device_seconds``) read from the same events."""
    import torch

    act = torch.profiler.ProfilerActivity
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    prof = torch.profiler.profile(activities=[act.CPU, act.CUDA] if cuda else [act.CPU])
    prof.__enter__()
    t0 = time.perf_counter()
    try:
        with tr.span("portbench.window"):
            yield
            sync()
        out["window_s"] = time.perf_counter() - t0
    finally:
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.update(tr.summarise(events))
    out["field_device_s"] = field_device_seconds(events)


def run(ctx: dict, seed: int, seconds: float, trace: bool) -> dict:
    import torch

    from radnerf_tpu_torch.data import PoseAudioDataset
    from radnerf_tpu_torch.models import make_state
    from radnerf_tpu_torch.train import Trainer

    cfg, traffic = ctx["config"], ctx["traffic"]
    heap.keep_host_heap()
    dev = common.device()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    H, W, T = traffic["H"], traffic["W"], traffic["track_frames"]
    r = cfg["render"]
    root = tempfile.mkdtemp(prefix="portbench_render_triplane_")
    try:
        pose_path, aud_path, mats, eye, auds = hrender._write_inputs(
            root, traffic, cfg["model"]["audio_in_dim"], seed)
        opt, net_cfg, render_cfg = configs(cfg, traffic, pose=pose_path, aud=aud_path, seed=seed)
        if net_cfg.arch != "ernerf":
            raise common.Refused(f"traffic render_triplane drives ER-NeRF's field, not "
                                 f"{net_cfg.arch!r}")
        arch = ftri.Arch(cfg["model"], torso=opt.torso)
        params = ftri.draw_params(arch, "avatar", seed, dev)
        occ, torso = rscene.avatar_grids(dev, r["grid_size"])
        trainer = Trainer(opt, net_cfg, render_cfg, device=dev, name="ngp", workspace=None,
                          mute=True)
        load_params(trainer.net, params)
        trainer.state = make_state(trainer.render_cfg, occ.clone(), torso.clone(),
                                   float(occ.mean()), float(torso.mean()),
                                   audio_dim=net_cfg.audio_dim)
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
            with record_calls(counts), record_triplane(counts), profiled(trace_out):
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
    out["fifths_ms"] = hrender.fifths([t * 1e3 for t in times])
    w = parts[-n:]
    out["parts_fifths_ms"] = {name: hrender.fifths([p[i] * 1e3 for p in w])
                              for i, name in enumerate(("batch", "render", "u8"))}
    if counts.get("samples"):
        out["samples_range"] = [min(s for s, _, _ in counts["samples"]),
                                max(s for s, _, _ in counts["samples"])]
    return out


def check(ctx: dict, res: dict) -> dict:
    """The program's kept frames against the reference's, in float32."""
    rp = res["replay"]
    ref = reference_frames(ctx, res, ctx["config"]["precision"])
    mine = {pos: rp["kept"][pos][1] for pos in ref}
    return dict(hrender.gaps(mine, ref), frames_compared=len(ref))


def controls(ctx: dict, res: dict) -> dict:
    """The same gaps, of the reference computed in the control's precision
    (TF32 GEMMs) put in the program's place."""
    ref = reference_frames(ctx, res, ctx["config"]["precision"])
    low = reference_frames(ctx, res, ctx["config"]["control"])
    return {f"control.{k}": v for k, v in hrender.gaps(low, ref).items()}


def reference_frames(ctx: dict, res: dict, precision: str) -> dict:
    """The plain reference's float image at each kept window position, with
    TF32 GEMMs where ``precision`` is the ``tf32`` control."""
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
    poses, eyes = hrender.reference_inputs(rp["mats"], rp["eye"], options)
    codes = hrender.audio_codes(rp["params"], arch, rp["auds"], rp["seq"], dev, rs.smooth_lips)
    fl = 1200.0 * H / 450.0
    intr = (fl, fl, W / 2, H / 2)
    pix = torch.arange(H * W, device=dev)
    bg_coords = torch.from_numpy(rdata.get_bg_coords(H, W)).to(dev)
    out = {}
    with torch.no_grad(), ftri.lower_precision(precision):
        for pos in sorted(rp["kept"]):
            k = rp["kept"][pos][0]
            idx = rp["seq"][k]
            pose = torch.from_numpy(poses[idx]).to(dev)
            ro, rd = rdata.rays_from_pixels(pose, intr, pix, W)
            batch = {"rays_o": ro, "rays_d": rd, "bg_coords": bg_coords,
                     "poses_matrix": pose[None],
                     "eye": torch.tensor([[float(eyes[idx])]], device=dev),
                     "bg_color": torch.ones((H * W, 3), device=dev)}
            out[pos] = rtri.render(rp["params"], arch, rs, state, batch, codes[k])["image"]
    return out
