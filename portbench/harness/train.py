"""Traffic of kind ``train``: the head stage of a new identity, as ``main``
runs it from its first step, on a processed-video directory the benchmark
writes in set-up.

Set-up writes the frames, torso plates, landmarks, background, audio
features and transforms (every image PNG content under the format's own
names: lossless, so the program's decoded frames are the benchmark's
arrays), draws the initial weights from the seed on the device, builds the
program's trainer and dataset, marks the untrained cells as
``Trainer.train`` does, and drives ``Trainer.step`` in
``train_one_epoch``'s order (the upkeep when due, the batch, the step;
each epoch's losses read back once at its end) through the first upkeeps
and adaptations. The window goes on with the same loop for a fixed number
of steps (``common.window_count``), the same on every commit, so that
every side trains alike. It opens on an upkeep that adapts the capacities
(``warmup_steps`` a multiple of the upkeep interval, inside an epoch).

``check`` holds two stretches of the program to the plain reference: the
first steps from the seed (the start), and the window's first steps from
a snapshot of the program's state taken as the window opens (parameters,
Adam's moments, the density grid, the capacities and the last step's
telemetry), through the window's upkeep and adaptation. Inside the window
the program's state is copied, by the device, after its first step and
after the last compared one; nothing is read back until it closes."""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import time
import zlib

import numpy as np

from ..reference import field as fld
from ..reference import render as rrender
from ..reference import scene as rscene
from ..reference import train as rtrain
from . import common
from . import trace as tr
from .program import configs, load_params, record_calls
from .render import fifths

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the telemetry the adaptation reads
TELEMETRY = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span")


def write_png(path: str, img: np.ndarray):
    """uint8 [H, W, 3 or 4] as an 8-bit PNG, rows unfiltered, zlib level 1."""
    H, W, C = img.shape

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8,
                                                         {3: 2, 4: 6}[C], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_dataset(root, traffic, audio_in_dim, seed, dev):
    """The processed-video directory; returns the reference's ``Inputs``."""
    n, H, W = traffic["frames"], traffic["H"], traffic["W"]
    scale = traffic["options"]["scale"]
    frames, plates, bg = rscene.procedural_frames(n, H, W, seed, dev)
    lms = rscene.landmarks(n, H, seed)
    mats = rscene.track(n, traffic["amp_deg"], traffic["amp_t"], traffic["cycles"], scale)
    auds = np.random.default_rng(seed + 1).normal(size=(n, 16, audio_in_dim)).astype(np.float32)
    for sub in ("gt_imgs", "torso_imgs", "ori_imgs"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        write_png(os.path.join(root, "gt_imgs", f"{i}.jpg"), frames[i])
        write_png(os.path.join(root, "torso_imgs", f"{i}.png"), plates[i])
        np.savetxt(os.path.join(root, "ori_imgs", f"{i}.lms"), lms[i])
    write_png(os.path.join(root, "bc.jpg"), bg)
    np.save(os.path.join(root, "aud_eo.npy"), auds)
    camera = {"focal_len": 1200.0 * H / 450.0, "cx": W / 2, "cy": H / 2}
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({**camera, "frames": [{"img_id": i, "aud_id": i,
                                         "transform_matrix": m.tolist()}
                                        for i, m in enumerate(mats)]}, f)
    return rtrain.Inputs(frames, plates, bg, {**camera, "matrices": mats}, lms,
                         auds.transpose(0, 2, 1).copy(), H, W, scale)


class Loop:
    """``train_one_epoch``'s order over epochs: ``step()`` runs one
    ``Trainer.step``, starting a new epoch (and reading the last one's
    losses back) when the order is used up."""

    def __init__(self, trainer, ds):
        self.trainer, self.ds = trainer, ds
        self.order, self.pos, self.losses = [], 0, []

    def step(self):
        import torch

        if self.pos == len(self.order):
            if self.losses:
                torch.stack(self.losses).tolist()
            self.order, self.pos, self.losses = self.ds.epoch_indices(), 0, []
        t = self.trainer
        loss = t.step(self.ds, self.order[self.pos], t.telemetry if self.pos else None)
        self.losses.append(loss)
        self.pos += 1
        return loss




def _moments(trainer, key: str) -> list:
    """Adam's ``key`` moment of every parameter, in the network's order (a
    zero tensor where it has none yet)."""
    import torch

    st = trainer.optimizer.state
    return [st[p][key] if key in st.get(p, {}) else torch.zeros_like(p)
            for p in trainer.net.parameters()]


def run(ctx: dict, seed: int, seconds: float, trace: bool) -> dict:
    import torch

    from radnerf_tpu_torch.data import TalkingHeadDataset
    from radnerf_tpu_torch.models import mark_untrained_grid
    from radnerf_tpu_torch.train import Trainer

    cfg, traffic = ctx["config"], ctx["traffic"]
    dev = common.device()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    root = tempfile.mkdtemp(prefix="portbench_train_")
    try:
        inputs = write_dataset(root, traffic, cfg["model"]["audio_in_dim"], seed, dev)
        opt, net_cfg, render_cfg = configs(cfg, traffic, path=root, seed=seed)
        n_check, warm = traffic["check_steps"], traffic["warmup_steps"]
        if opt.torso:
            raise common.Refused("the training reference has the head stage only: a train "
                                 "traffic's options.torso is false")
        if (warm % opt.update_extra_interval or warm % traffic["frames"] == 0
                or n_check > opt.update_extra_interval):
            raise common.Refused("warmup_steps has to end where an upkeep adapts the "
                                 "capacities: a multiple of the upkeep interval inside an epoch")
        arch = fld.Arch(cfg["model"], torso=False)
        p0 = fld.draw_params(arch, "fresh", seed, dev)
        trainer = Trainer(opt, net_cfg, render_cfg, device=dev, name="ngp", workspace=None,
                          mute=True)
        load_params(trainer.net, p0)
        ds = TalkingHeadDataset(opt, split="train", device=dev)
        trainer.state = mark_untrained_grid(trainer.render_cfg, trainer.state, ds.poses,
                                            tuple(ds.intrinsics))
        loop = Loop(trainer, ds)
        names = [n for n, _ in trainer.net.named_parameters()]
        params = [p.detach() for p in trainer.net.parameters()]
        # the start: the first steps from the seed
        start = {"losses": []}
        for k in range(n_check):
            start["losses"].append(loop.step())
            if k == 0:
                start["m1"] = [t.clone() for t in _moments(trainer, "exp_avg")]
        start["params"] = [p.clone() for p in params]
        for _ in range(warm - n_check):
            loop.step()
        # the program's state as the window opens, which the reference
        # replays the window's first steps from
        rc = trainer.render_cfg
        snap = {"step": trainer.global_step, "params": [p.clone() for p in params],
                "m": [t.clone() for t in _moments(trainer, "exp_avg")],
                "v": [t.clone() for t in _moments(trainer, "exp_avg_sq")],
                "grid": trainer.state.density_grid.clone(),
                "caps": rtrain.Caps(rc.ray_capacity_frac, rc.sample_capacity_mult,
                                    rc.march_iters, rc.sample_slots, trainer._adapt_count),
                "telemetry": {k: int(trainer.telemetry[k]) for k in TELEMETRY}}
        win = {"losses": [], "m1": [torch.empty_like(t) for t in snap["m"]],
               "params": [torch.empty_like(p) for p in params],
               "grid": torch.empty_like(snap["grid"])}
        # the window's copies made once here: their kernels load in set-up
        torch._foreach_copy_(win["m1"], _moments(trainer, "exp_avg"))
        torch._foreach_copy_(win["params"], params)
        win["grid"].copy_(trainer.state.density_grid)
        sync()
        setup_done = time.time()
        n = traffic["trace_steps"] if trace else common.window_count(traffic, seconds, n_check)
        marks = []

        def window():
            for i in range(n):
                loss = loop.step()
                if i < n_check:
                    win["losses"].append(loss)
                if i == 0:
                    torch._foreach_copy_(win["m1"], _moments(trainer, "exp_avg"))
                    win["grid"].copy_(trainer.state.density_grid)
                    win["caps"] = (trainer.render_cfg.march_iters,
                                   trainer.render_cfg.sample_slots)
                if i == n_check - 1:
                    torch._foreach_copy_(win["params"], params)
                marks.append(time.perf_counter())

        counts, trace_out = {}, {}
        probe = common.host_probe()
        if trace:
            trainer.next_batch = _spanned(trainer.next_batch)
            with record_calls(counts), tr.profiled(trace_out):
                window()
            window_s = trace_out["window_s"]
        else:
            t_start = time.perf_counter()
            window()
            sync()
            window_s = time.perf_counter() - t_start
        host = common.host_share(probe, common.host_probe())
        samples_end = int(trainer.telemetry["n_samples_needed"])
        memory = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        n_rays = opt.num_rays
        del trainer, ds, loop, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def named(ts):
        return dict(zip(names, ts))

    p_snap, m_snap = named(snap["params"]), named(snap["m"])
    program = {
        "start": {"losses": [float(v) for v in start["losses"]],
                  "grad": {k: rtrain.norm(v) for k, v in
                           rtrain.first_gradient(named(start["m1"]), None).items()},
                  "change": {k: rtrain.norm(v - p0[k]) for k, v in
                             named(start["params"]).items()}},
        "window": {"losses": [float(v) for v in win["losses"]],
                   "grad": {k: rtrain.norm(v) for k, v in
                            rtrain.first_gradient(named(win["m1"]), m_snap).items()},
                   "change": {k: rtrain.norm(v - p_snap[k]) for k, v in
                              named(win["params"]).items()},
                   "grid": win["grid"]}}
    out = {"steps": n, "window_s": window_s, "setup_done": setup_done, "memory": memory,
           "precision": cfg["precision"], "arch": arch, "trace": trace_out, "counts": counts,
           "rays": n_rays, "samples_start": snap["telemetry"]["n_samples_needed"],
           "samples_end": samples_end, "host": host, "caps_after_upkeep": win["caps"],
           "replay": {"inputs": inputs, "p0": p0, "program": program, "n_rays": n_rays,
                      "seed": seed, "snap": dict(snap, params=p_snap, m=m_snap,
                                                 v=named(snap["v"]))}}
    if not trace:
        out["metrics"] = {"train_rays_per_s": n * n_rays / window_s}
        out["fifths_ms"] = fifths([1e3 * (b - a) for a, b in zip([t_start] + marks, marks)])
    return out


def _reference(ctx: dict, res: dict, precision: str, fault=None) -> dict:
    """The reference's two stretches in ``precision``: the first steps from
    the seed, and the window's first steps from the snapshot."""
    cfg, traffic, rp = ctx["config"], ctx["traffic"], res["replay"]
    opts = traffic.get("options", {})
    ropt = {**cfg["train"], **{k: v for k, v in opts.items() if k in cfg["train"]}}
    rs = rrender.RenderSettings(cfg["render"], torso=False, smooth_lips=False)
    q, n, dev = fld.rounding(precision), traffic["check_steps"], rp["p0"]["encoder"].device
    snap = rp["snap"]
    new = {"step": 0, "params": rp["p0"], "m": None, "v": None, "grid": None,
           "caps": rtrain.Caps(), "telemetry": None}
    with fld.lower_precision(precision):
        return {"start": rtrain.replay(new, res["arch"], rs, rp["inputs"], ropt, rp["seed"], n,
                                       dev, q, fault),
                "window": rtrain.replay(snap, res["arch"], rs, rp["inputs"], ropt, rp["seed"],
                                        n, dev, q, fault)}


def _compared(mine: dict, ref: dict, res: dict) -> dict:
    """The numbers compared, of both stretches (``window.`` before the
    second's), ``mine`` the program's or a replay's in its place."""
    rp = res["replay"]
    out = compare(mine["start"], ref["start"], rp["p0"])
    w = compare(mine["window"], ref["window"], rp["snap"]["params"])
    w["grid_gap"] = rtrain.grid_gap(mine["window"]["grid"], ref["window"]["grid"])
    out.update({f"window.{k}": v for k, v in w.items()})
    return out


def check(ctx: dict, res: dict) -> dict:
    ref = _reference(ctx, res, ctx["config"]["precision"])
    out = _compared(res["replay"]["program"], ref, res)
    out["samples_first_step"] = ref["start"]["samples"][0]
    out["samples_window_step"] = ref["window"]["samples"][0]
    out["caps_window"] = [ref["window"]["caps"].march_iters, ref["window"]["caps"].sample_slots]
    return out


def controls(ctx: dict, res: dict) -> dict:
    """The numbers compared, read off the reference computed in the control's
    precision and off the reference with half of each batch left out (the
    mean over the rest), each put in the program's place; and the window's
    grid gap were its upkeep left out."""
    cfg, rp = ctx["config"], res["replay"]
    ref = _reference(ctx, res, cfg["precision"])
    out = {}
    for tag, run_ in (("control", _reference(ctx, res, cfg["control"])),
                      ("half_batch", _reference(ctx, res, cfg["precision"], fault="half"))):
        starts = {"start": rp["p0"], "window": rp["snap"]["params"]}
        mine = {s: {"losses": r["losses"],
                    "grad": {k: rtrain.norm(v) for k, v in r["grads"].items()},
                    "change": {k: rtrain.norm(v - starts[s][k]) for k, v in r["params"].items()},
                    "grid": r["grid"]}
                for s, r in run_.items()}
        got = _compared(mine, ref, res)
        out.update({f"{tag}.{k}": v for k, v in got.items() if isinstance(v, float)})
    # the window's upkeep left out: the grid as the snapshot holds it
    out["no_upkeep.window.grid_gap"] = rtrain.grid_gap(rp["snap"]["grid"],
                                                       ref["window"]["grid"])
    return out


def _spanned(fn):
    def call(*args, **kw):
        with tr.span("portbench.batch"):
            return fn(*args, **kw)
    return call


def compare(mine: dict, ref: dict, p_start: dict) -> dict:
    """A stretch of steps against the reference's, from the parameters
    ``p_start``; ``mine`` holds the losses and, by leaf, the norms of the
    first step's gradient and of the change over the steps:

    - ``loss_rel``: the largest relative gap of a step's loss;
    - ``grad_gap``: over the leaves, the largest gap between the first
      gradient's norms (the program's from Adam's first moment before and
      after the step), over the larger of the leaf's reference norm and the
      median leaf's;
    - ``change_gap``: the same for the norm of each leaf's change over the
      steps, leaving out the leaves whose reference gradient is under a
      thousandth of the median leaf's (round-off alone moves them under
      Adam);
    - ``change_med``: the median over those leaves of the same gap, steady
      where the worst leaf's swings with the float atomics of one table's
      gradient."""
    ref_g = {n: rtrain.norm(v) for n, v in ref["grads"].items()}
    ref_c = {n: rtrain.norm(ref["params"][n] - p_start[n]) for n in p_start}
    med_g = float(np.median(list(ref_g.values())))
    live = [n for n in p_start if ref_g[n] >= 1e-3 * med_g]
    med_c = float(np.median([ref_c[n] for n in live]))

    def g_gap(n):
        return abs(mine["grad"][n] - ref_g[n]) / max(ref_g[n], med_g)

    def c_gap(n):
        return abs(mine["change"][n] - ref_c[n]) / max(ref_c[n], med_c)

    worst_g, worst_c = max(p_start, key=g_gap), max(live, key=c_gap)
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(mine["losses"], ref["losses"])),
            "grad_gap": g_gap(worst_g), "change_gap": c_gap(worst_c),
            "change_med": float(np.median([c_gap(n) for n in live])),
            "worst_grad_leaf": worst_g, "worst_change_leaf": worst_c,
            "leaves_left_out": sorted(set(p_start) - set(live)),
            "losses": mine["losses"], "ref_losses": ref["losses"]}
