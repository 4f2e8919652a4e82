"""The head stage's training steps in plain PyTorch: the upkeep when it is
due (with the adaptive capacities before it), then each step's batch,
render, loss, gradients and Adam update, as the program's trainer runs
them, from a new identity or from a state part way through.

Frozen copies at commit 2a619bf24d8171cdad65a8fd4e01bbb8c7f3f0f8 of
``radnerf_tpu_torch/train/losses.py`` (``binary_entropy``, ``head_loss``),
``train/trainer.py`` (``build_optimizer``'s groups, rates and schedule,
``step``'s and ``update_extra_state``'s order and draws,
``_adapt_capacities``, ``train_step``'s order, the noise and grid
generators' seeds), ``train/capacity.py`` (``adapt_render_config``: the
ray, sample, orbit and lattice parts; the two-level march and the torso
are off in the head stage), ``data/provider.py``
(``TalkingHeadDataset.collate`` for a training batch, ``epoch_indices``)
and ``models/network.py`` (``param_groups`` of the head stage). Adam is
written out (betas 0.9 / 0.99, eps 1e-15). Everything the program derives
from the inputs and the seed (the occupancy, the capacities, the rays, the
pixels drawn, the noises, the jitter) is derived here again. It imports
nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import data as rdata
from . import field as fld
from . import render as rrender

BETAS, EPS = (0.9, 0.99), 1e-15
GROUP_OF = {"audio_net": "net", "encoder": "grid", "encoder_ambient": "grid",
            "ambient_net": "net", "sigma_net": "net", "color_net": "net",
            "audio_att_net": "att", "individual_codes": "net"}
# the trainer's bound on its adaptations (Trainer._adapt_cap)
ADAPT_CAP = 6


def group_lr(opt: dict) -> dict:
    return {"grid": opt["lr"], "net": opt["lr_net"], "att": opt["lr_net"] * 5}


def binary_entropy(a):
    a = torch.clamp(a, 1e-5, 1 - 1e-5)
    return -a * torch.log2(a) - (1 - a) * torch.log2(1 - a)


def head_loss(out, gt, face_mask, step, iters, lambda_amb):
    loss = torch.mean((out["image"] - gt) ** 2)
    loss = loss + 1e-4 * torch.mean(binary_entropy(out["weights_sum"]))
    lam = float(np.minimum(np.float32(step) / np.float32(iters), np.float32(1.0))
                * np.float32(lambda_amb))
    return loss + lam * torch.mean(out["ambient"] * (~face_mask))


class Inputs:
    """What the benchmark hands both sides: the dataset's arrays (frames and
    plates uint8, the background, poses, landmarks, audio, intrinsics) as
    it wrote them."""

    def __init__(self, frames, plates, bg_u8, transforms, lms, auds, H, W, scale):
        self.frames, self.plates, self.bg_u8 = frames, plates, bg_u8
        self.lms, self.auds, self.H, self.W = lms, auds, H, W
        self.poses = np.stack([rdata.nerf_matrix_to_ngp(np.asarray(m, np.float32), scale)
                               for m in transforms["matrices"]])
        self.intrinsics = np.array([transforms["focal_len"], transforms["focal_len"],
                                    transforms["cx"], transforms["cy"]], np.float64)


@dataclasses.dataclass
class Caps:
    """The render capacities the trainer adapts (``RenderConfig``'s fields of
    those names) and the count of adaptations made."""

    ray_capacity_frac: float = 1.0
    sample_capacity_mult: float = 4.0
    march_iters: int | None = None
    sample_slots: int | None = None
    count: int = 0


def _ceil_to(v, step):
    return -(-v // step) * step


def adapt(caps: Caps, rs: rrender.RenderSettings, tel: dict, n_rays: int,
          occ_radius: float, headroom: float = 1.35) -> Caps:
    """The capacities after an upkeep's adaptation to the last step's
    telemetry (``n_hit``, ``n_samples_needed``, ``n_max_count``,
    ``n_k_span``), at most ``ADAPT_CAP`` adaptations that change one."""
    if caps.count >= ADAPT_CAP:
        return caps
    n_hit, n_needed, n_max, n_k_span = (tel[k] for k in ("n_hit", "n_samples_needed",
                                                         "n_max_count", "n_k_span"))

    def ray_cap(frac):
        return max(128, int(-(-n_rays * min(frac, 1.0) // 128)) * 128)

    frac = caps.ray_capacity_frac
    want = min(1.0, (n_hit / n_rays) * headroom if n_rays else 1.0)
    want = max(0.125, -(-want * 8 // 1) / 8)
    if want > frac or (want < frac and n_hit < 0.4 * ray_cap(frac)):
        frac = want
    mult = caps.sample_capacity_mult
    used = n_needed / max(ray_cap(frac), 1)
    want_mult = max(0.25, -(-used * headroom / 0.25 // 1) * 0.25)
    if want_mult > mult or want_mult < mult - 0.5:
        mult = want_mult
    full = rs.march(march_iters=None, sample_slots=None)
    if n_k_span > 0:
        want_k = int(_ceil_to(n_k_span + 2, 8))
    else:
        want_k = int(_ceil_to(2.0 * occ_radius / full.dt_min + 2, 8))
    want_k = min(want_k, full.n_march_iters)
    k = caps.march_iters
    if k is None or want_k > k or want_k < k - 16:
        k = want_k
    slots = caps.sample_slots if caps.sample_slots is not None else rs.max_steps
    if n_max >= slots and slots < rs.max_steps:
        slots = min(rs.max_steps, slots + 4)
    elif n_max + 1 <= slots - 4:
        slots = max(4, int(_ceil_to(n_max + 1, 4)))
    new = Caps(frac, mult, k, slots, caps.count)
    if (frac, mult, k, slots) == (caps.ray_capacity_frac, caps.sample_capacity_mult,
                                  caps.march_iters, caps.sample_slots):
        return caps
    new.count += 1
    return new


class Draws:
    """The program's draws from the seed, in its order: each epoch's order
    and each step's pixels from one numpy generator, the perturbation noises
    and each upkeep's jitter from two torch generators on the device."""

    def __init__(self, seed: int, inp: Inputs, num_rays: int, grid_size: int, device):
        self.rng = np.random.default_rng(seed)
        self.noise_gen = torch.Generator(device=device).manual_seed(seed)
        self.grid_gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.n_frames, self.H, self.W = inp.poses.shape[0], inp.H, inp.W
        self.num_rays, self.grid_size, self.device = num_rays, grid_size, device
        self.order, self.pos = np.zeros(0, np.int64), 0

    def frame(self) -> tuple:
        """(the frame of the next step, whether it starts an epoch)."""
        first = self.pos == len(self.order)
        if first:
            self.order = np.arange(self.n_frames)
            self.rng.shuffle(self.order)
            self.pos = 0
        self.pos += 1
        return int(self.order[self.pos - 1]), first

    def pixels(self):
        return rdata.draw_pixels(self.H, self.W, self.num_rays, self.rng)

    def noises(self):
        return torch.rand(self.num_rays, generator=self.noise_gen, device=self.device)

    def skip(self, n_steps: int, interval: int):
        """Draw, and drop, what the program's first ``n_steps`` steps draw."""
        G = self.grid_size
        for g in range(n_steps):
            self.frame()
            self.pixels()
            self.noises()
            if g % interval == 0:
                torch.rand((G**3, 3), generator=self.grid_gen, device=self.device)


def replay(start: dict, arch: fld.Arch, rs: rrender.RenderSettings, inp: Inputs, opt: dict,
           seed: int, n_steps: int, device, q=None, fault=None) -> dict:
    """``n_steps`` steps from ``start``, which holds the steps made before
    (``step``), the parameters, Adam's moments ``m`` and ``v`` (None: a new
    identity), the density grid (None: a new identity, its untrained cells
    marked from the cameras), the capacities (``Caps``) and the telemetry of
    the last step (None at an epoch's first step). Returns each step's
    loss and samples, the first step's gradients, Adam's first moment after
    the first step, the parameters after the last, the density grid after
    the first step and the capacities it marched. ``fault="half"`` leaves
    out the second half of each batch (the loss the mean over the rest): a
    fault the comparison has to catch."""
    step0, interval = start["step"], opt["update_extra_interval"]
    if n_steps > interval:
        raise ValueError("a replay spans at most one upkeep")
    unit = torch.from_numpy(np.arange(256, dtype=np.float32) / np.float32(255.0)).to(device)
    frames = torch.from_numpy(inp.frames).to(device)
    plates = torch.from_numpy(inp.plates).to(device)
    bg = unit[torch.from_numpy(inp.bg_u8).to(device).long()].reshape(-1, 3)
    bg_coords_all = torch.from_numpy(rdata.get_bg_coords(inp.H, inp.W)).to(device)
    auds = torch.from_numpy(inp.auds).to(device)
    eye = np.array([rdata.eye_area(l, inp.H, inp.W) for l in inp.lms], np.float32)
    rects = [rdata.face_rect(l) for l in inp.lms]

    p = {k: v.detach().clone().requires_grad_(True) for k, v in start["params"].items()}
    zeros = start["m"] is None
    m = {k: (torch.zeros_like(v) if zeros else start["m"][k].clone()) for k, v in p.items()}
    v2 = {k: (torch.zeros_like(v) if zeros else start["v"][k].clone()) for k, v in p.items()}
    lrs = group_lr(opt)
    if start["grid"] is None:
        # Trainer.train: the cells no camera sees
        state = rrender.empty_state(rs, device, arch.audio_dim)
        state = rrender.mark_untrained_grid(rs, state, inp.poses, tuple(inp.intrinsics))
    else:
        state = rrender.state_from_grid(rs, start["grid"].clone(), arch.audio_dim)
    caps = start["caps"]
    draws = Draws(seed, inp, opt["num_rays"], rs.grid_size, device)
    draws.skip(step0, interval)
    out = {"losses": [], "samples": [], "grads": None, "m1": None}
    for step in range(step0 + 1, step0 + n_steps + 1):
        idx, first = draws.frame()
        g = step - 1
        if g % interval == 0:
            # Trainer.step: the adaptation to the last step of the same
            # epoch, then the upkeep (an audio window and eye value drawn
            # by the step)
            tel = start["telemetry"] if step == step0 + 1 and not first else None
            if opt["auto_capacity"] and tel is not None:
                caps = adapt(caps, rs, tel, opt["num_rays"],
                             float(state["occ_sphere"][3]))
            rng_up = np.random.default_rng(g + seed)
            ridx = int(rng_up.integers(0, inp.auds.shape[0]))
            with torch.no_grad():
                enc_a = fld.encode_audio(p, arch, rdata.audio_window(auds, ridx))
            state = rrender.update_density_grid(p, arch, rs, state, enc_a,
                                                torch.tensor([[eye[ridx]]], device=device),
                                                draws.grid_gen, q)
        mcfg = rs.march(caps.march_iters, caps.sample_slots)
        pix = torch.from_numpy(draws.pixels()).to(device)
        pose = torch.from_numpy(inp.poses[idx]).to(device)
        ro, rd = rdata.rays_from_pixels(pose, inp.intrinsics, pix, inp.W)
        i, j = rdata.pixel_centres(pix, inp.W)
        xmin, xmax, ymin, ymax = rects[idx]
        face = (j >= xmin) & (j < xmax) & (i >= ymin) & (i < ymax)
        image = unit[frames[idx].reshape(-1, 3)[pix].long()]
        torso = unit[plates[idx].reshape(-1, 4)[pix].long()]
        alpha = torso[:, 3:]
        batch = {"rays_o": ro, "rays_d": rd, "auds": rdata.audio_window(auds, idx),
                 "bg_coords": bg_coords_all[pix], "index": idx,
                 "poses": torch.from_numpy(rdata.convert_poses(inp.poses[idx][None])).to(device),
                 "eye": torch.tensor([[eye[idx]]], device=device),
                 "bg_color": torso[:, :3] * alpha + bg[pix] * (1 - alpha)}
        noises = draws.noises()
        if fault == "half":
            h = ro.shape[0] // 2
            batch = {k: (v[:h] if torch.is_tensor(v) and v.dim() and v.shape[0] == ro.shape[0]
                         else v) for k, v in batch.items()}
            image, face, noises = image[:h], face[:h], noises[:h]
        res = rrender.render(p, arch, rs, state, batch, q, noises=noises, training=True,
                             march=mcfg)
        loss = head_loss(res, image, face, step, opt["iters"], opt["lambda_amb"])
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(p[k]) if gi is None else gi.detach())
                 for k, gi in zip(p, grads)}
        out["losses"].append(float(loss.detach()))
        out["samples"].append(res["n_samples"])
        with torch.no_grad():
            decay = 0.1 ** ((step - 1) / opt["iters"])
            for k in p:
                lr = lrs[GROUP_OF[k.split(".")[0]]] * decay
                m[k].mul_(BETAS[0]).add_(grads[k], alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(grads[k], grads[k], value=1 - BETAS[1])
                mh = m[k] / (1 - BETAS[0] ** step)
                vh = v2[k] / (1 - BETAS[1] ** step)
                p[k].sub_(lr * mh / (vh.sqrt() + EPS))
        if out["grads"] is None:
            out["grads"], out["m1"] = grads, {k: t.clone() for k, t in m.items()}
            out["grid"], out["caps"] = state["density_grid"], caps
        del res, loss, grads
    out["params"] = {k: t.detach() for k, t in p.items()}
    return out


def first_gradient(m1: dict, m0: dict | None) -> dict:
    """The gradient the optimizer got at a step, worked out from Adam's first
    moment before (``m0``, None: zero) and after it."""
    return {k: ((v - BETAS[0] * m0[k]) if m0 is not None else v) / (1 - BETAS[0])
            for k, v in m1.items()}


def norm(t) -> float:
    return float(t.double().norm())


def grid_gap(grid, ref) -> float:
    """The norm of the gap between two density grids over the norm of the
    reference's, over the cells a camera sees."""
    seen = ref >= 0
    return norm(torch.where(seen, grid - ref, 0.0)) / max(norm(torch.where(seen, ref, 0.0)),
                                                           1e-30)
