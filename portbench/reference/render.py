"""The renderer and the head grid's upkeep in plain PyTorch.

A frozen copy of ``radnerf_tpu_torch/models/renderer.py`` at commit
2a619bf24d8171cdad65a8fd4e01bbb8c7f3f0f8 (``RenderConfig``'s fields the
two configurations use, ``make_state``, ``compute_occ_bbox``,
``compute_occ_sphere``, ``bilinear_sample_2d``, ``smooth_audio_code``,
``march_window``, ``field_on_lattice``, ``_render``,
``update_density_grid``, ``mark_untrained_grid``), over the parameter dict
of ``field.py`` and the plain ops of ``ops.py``. The state is a plain dict.
It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from . import field as fld
from .ops import (
    SQRT3,
    MarchConfig,
    build_sigma_bytes,
    composite_rays,
    march_rays,
    morton3d,
    morton3d_invert,
    morton_dilate,
    near_far_from_aabb,
)


class RenderSettings:
    """The render settings the program takes from ``Options`` (its
    ``RenderConfig.from_options``), from a configuration's ``render`` block."""

    def __init__(self, r: dict, torso: bool, smooth_lips: bool):
        self.bound, self.min_near = r["bound"], r["min_near"]
        self.density_thresh, self.density_thresh_torso = r["density_thresh"], r["density_thresh_torso"]
        self.max_steps, self.dt_gamma, self.cull_T = r["max_steps"], r["dt_gamma"], r["cull_T"]
        self.T_thresh, self.grid_size = r["T_thresh"], r["grid_size"]
        self.torso, self.smooth_lips = torso, smooth_lips

    def march(self, march_iters=None, sample_slots=None) -> MarchConfig:
        """The march at the orbit length K and lattice width S given (None:
        their defaults, as the frame and a new identity's first steps march
        them)."""
        return MarchConfig(self.bound, self.grid_size, self.max_steps, self.dt_gamma,
                           march_iters, sample_slots)

    @property
    def aabb(self):
        b = self.bound
        return (-b, -b / 2, -b, b, b / 2, b)


def _cell_coords(H, device):
    return morton3d_invert(torch.arange(H**3, device=device)).float()


def occ_bbox(rs: RenderSettings, grid, thresh):
    H = rs.grid_size
    coords = _cell_coords(H, grid.device)
    occ = (grid[0] > thresh)[:, None]
    cmin = torch.where(occ, coords, math.inf).amin(dim=0)
    cmax = torch.where(occ, coords, -math.inf).amax(dim=0)
    mip = min(1.0, rs.bound)
    lo, hi = (2.0 * cmin / H - 1.0) * mip, (2.0 * (cmax + 1.0) / H - 1.0) * mip
    if not bool(torch.isfinite(lo).all()):
        b = rs.bound
        lo, hi = lo.new_tensor([-b, -b, -b]), hi.new_tensor([b, b, b])
    return torch.cat([lo, hi]).float()


def occ_sphere(rs: RenderSettings, grid, thresh):
    H = rs.grid_size
    coords = _cell_coords(H, grid.device)
    bbox = occ_bbox(rs, grid, thresh)
    center = 0.5 * (bbox[:3] + bbox[3:])
    mip = min(1.0, rs.bound)
    occ = grid[0] > thresh
    world = (2.0 * (coords + 0.5) / H - 1.0) * mip
    dist = torch.linalg.norm(world - center, dim=-1) + SQRT3 * mip / H
    r = torch.maximum(grid.new_zeros(()), torch.where(occ, dist, 0.0).max())
    if not bool(r > 0):
        r = r.new_tensor(rs.bound * SQRT3)
    return torch.cat([center, r[None]]).float()


def make_state(rs: RenderSettings, grid, grid_torso, mean_density, mean_density_torso,
               thresh, audio_dim: int = 64) -> dict:
    """The renderer's state from the grids: sigma bytes, occupied box and
    sphere at ``thresh``, and a zero audio code."""
    dev = grid.device
    return {"density_grid": grid, "mean_density": torch.as_tensor(mean_density, device=dev),
            "density_grid_torso": grid_torso,
            "mean_density_torso": torch.as_tensor(float(mean_density_torso), device=dev),
            "sigma_bytes": build_sigma_bytes(grid, thresh),
            "occ_bbox": occ_bbox(rs, grid, thresh), "occ_sphere": occ_sphere(rs, grid, thresh),
            "enc_a_smooth": torch.zeros((1, audio_dim), device=dev), "enc_a_init": False}


def state_from_grid(rs: RenderSettings, grid, audio_dim: int = 64) -> dict:
    """The head stage's state as an upkeep leaves it, from its density grid
    alone: the mean, the occupancy at the mean clamped to the threshold, no
    torso grid."""
    mean = torch.clamp(grid, min=0.0).mean()
    thresh = torch.clamp(mean, max=rs.density_thresh)
    zeros = torch.zeros((rs.grid_size**2,), device=grid.device)
    return make_state(rs, grid, zeros, mean, 0.0, thresh, audio_dim)


def bilinear_sample_2d(flat, coords, H):
    a = (coords[..., 0] + 1.0) * 0.5 * (H - 1)
    b = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    a0 = torch.clamp(torch.floor(a), 0, H - 1)
    b0 = torch.clamp(torch.floor(b), 0, H - 1)
    b1 = torch.clamp(b0 + 1, 0, H - 1)
    a1 = torch.clamp(a0 + 1, 0, H - 1)
    wa = torch.clamp(a - a0, 0.0, 1.0)
    wb = torch.clamp(b - b0, 0.0, 1.0)
    a0i, a1i, b0i, b1i = (v.long() for v in (a0, a1, b0, b1))
    top = flat[b0i * H + a0i] * (1 - wa) + flat[b0i * H + a1i] * wa
    bot = flat[b1i * H + a0i] * (1 - wa) + flat[b1i * H + a1i] * wa
    return top * (1 - wb) + bot * wb


def smooth_audio_code(state: dict, enc_a):
    """The EMA 0.35 prev + 0.65 new of the audio code; returns the code and
    updates the state (kept detached)."""
    code = 0.35 * state["enc_a_smooth"] + 0.65 * enc_a if state["enc_a_init"] else enc_a
    state["enc_a_smooth"], state["enc_a_init"] = code.detach(), True
    return code


def march_window(state, o, d, nears, fars):
    bb = state["occ_bbox"]
    tb0, tb1 = (bb[:3] - o) / d, (bb[3:] - o) / d
    lo = torch.maximum(torch.minimum(tb0, tb1).amax(dim=-1), nears)
    hi = torch.minimum(torch.maximum(tb0, tb1).amin(dim=-1), fars)
    oc = o - state["occ_sphere"][:3]
    b_half = (oc * d).sum(dim=-1)
    disc = b_half * b_half - ((oc * oc).sum(dim=-1) - state["occ_sphere"][3] ** 2)
    sq = torch.sqrt(disc.clamp_min(0.0))
    lo = torch.maximum(lo, -b_half - sq)
    hi = torch.minimum(hi, torch.where(disc > 0, -b_half + sq, -math.inf))
    return lo, hi


def render(p, arch: fld.Arch, rs: RenderSettings, state: dict, batch: dict, q=None,
           noises=None, training=False, enc_a=None, march=None) -> dict:
    """A batch of rays: the head over the torso layer over the background.
    ``batch`` holds rays_o, rays_d, auds (or ``enc_a`` given), bg_coords,
    poses [1, 6], eye, index, bg_color; ``march`` the capacities (None:
    the defaults). Returns image, weights_sum, depth and, when training,
    ambient; the telemetry n_hit and n_samples."""
    ro, rd = batch["rays_o"], batch["rays_d"]
    mcfg = march or rs.march()
    nears, fars = near_far_from_aabb(ro, rd, ro.new_tensor(rs.aabb), rs.min_near)
    if enc_a is None:
        enc_a = fld.encode_audio(p, arch, batch["auds"])
        if rs.smooth_lips:
            enc_a = smooth_audio_code(state, enc_a)
    index = batch["index"] if training else 0
    code = p["individual_codes"][index]
    t_lo, t_hi = march_window(state, ro, rd, nears, fars)
    hit = t_lo < t_hi
    march = march_rays(ro, rd, nears, fars, state["sigma_bytes"], mcfg, (t_lo, t_hi),
                       rs.cull_T, noises)
    valid = march["valid"]
    N, S = valid.shape
    idx = valid.reshape(-1).nonzero().squeeze(1)
    xyz = march["xyz"].reshape(-1, 3)[idx]
    sig_c, col_c, amb_c = fld.field_forward(p, arch, xyz, rd[idx // S], enc_a, code,
                                            batch.get("eye"), q)
    if q is not None:
        sig_c, col_c, amb_c = q(sig_c), q(col_c), q(amb_c)
    sigma = sig_c.new_zeros(N * S).index_copy(0, idx, sig_c).view(N, S)
    color = col_c.new_zeros(N * S, 3).index_copy(0, idx, col_c).view(N, S, 3)
    amb = amb_c.new_zeros(N * S, amb_c.shape[-1]).index_copy(0, idx, amb_c).view(N, S, -1)
    comp = composite_rays(sigma, color, march["dt"], march["t"], valid,
                          amb.abs().sum(dim=-1), rs.T_thresh)
    out = {"n_hit": int(hit.sum()), "n_samples": int(valid.sum())}
    weights_sum = torch.where(hit, comp["weights_sum"], 0.0)
    image = torch.where(hit[:, None], comp["image"], 0.0)
    depth_raw = torch.where(hit, comp["depth"], 0.0)
    if training:
        out["ambient"] = torch.where(hit, comp["ambient_sum"], 0.0)
    bg = batch["bg_color"]
    if rs.torso:
        code_t = p["individual_codes_torso"][index]
        thresh_t = torch.clamp(state["mean_density_torso"], max=rs.density_thresh_torso)
        occupancy = bilinear_sample_2d(state["density_grid_torso"], batch["bg_coords"],
                                       rs.grid_size)
        mask = occupancy > thresh_t
        t_alpha, t_color = fld.forward_torso(p, arch, batch["bg_coords"], batch["poses"],
                                             code_t, q)
        t_alpha = torch.where(mask[:, None], t_alpha, 0.0)
        t_color = torch.where(mask[:, None], t_color, 0.0)
        bg = t_color * t_alpha + bg * (1.0 - t_alpha)
    out["image"] = torch.clamp(image + (1.0 - weights_sum)[:, None] * bg, 0.0, 1.0)
    out["weights_sum"] = weights_sum
    out["depth"] = torch.clamp(depth_raw - nears, min=0.0) / torch.clamp(fars - nears, min=1e-8)
    return out


def _grid_points(H, device):
    lin = torch.arange(H, device=device)
    coords = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)
    xyzs01 = 2.0 * coords.float() / torch.full((), H - 1.0, device=device) - 1.0
    return morton3d(coords), xyzs01


@torch.no_grad()
def update_density_grid(p, arch, rs: RenderSettings, state: dict, enc_a, eye, generator,
                        q=None, decay: float = 0.95, chunk: int = 128**3 // 4) -> dict:
    """Jittered density queries at every cell, 6-neighbour dilation, the max
    with the decayed grid, and the occupancy derived again."""
    H, dev = rs.grid_size, state["density_grid"].device
    indices, xyzs01 = _grid_points(H, dev)
    tmp = torch.zeros_like(state["density_grid"])
    bound = min(1, rs.bound)
    half = bound / H
    pts = xyzs01 * (bound - half) + (torch.rand(xyzs01.shape, generator=generator, device=dev)
                                     * (2.0 * half) - half)
    tmp[0, indices] = torch.cat([fld.field_density(p, arch, pts[i:i + chunk], enc_a, eye, q)
                                 for i in range(0, pts.shape[0], chunk)])
    tmp = morton_dilate(tmp, H)
    old = state["density_grid"]
    valid = (old >= 0) & (tmp >= 0)
    grid = torch.where(valid, torch.maximum(old * decay, tmp), old)
    mean_density = torch.clamp(grid, min=0.0).mean()
    thresh = torch.clamp(mean_density, max=rs.density_thresh)
    return dict(state, density_grid=grid, mean_density=mean_density,
                sigma_bytes=build_sigma_bytes(grid, thresh), occ_bbox=occ_bbox(rs, grid, thresh),
                occ_sphere=occ_sphere(rs, grid, thresh))


@torch.no_grad()
def mark_untrained_grid(rs: RenderSettings, state: dict, poses, intrinsics) -> dict:
    """Cells no training camera sees become -1."""
    H, dev = rs.grid_size, state["density_grid"].device
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    poses = torch.as_tensor(poses, dtype=torch.float32).to(dev)
    indices, world01 = _grid_points(H, dev)
    count = torch.zeros_like(state["density_grid"])
    bound = min(1, rs.bound)
    half = bound / H
    pts = world01 * (bound - half)
    seen = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev)
    for pose in poses:
        cam = (pts - pose[:3, 3]) @ pose[:3, :3]
        mask_z = cam[:, 2] > 0
        mask_x = torch.abs(cam[:, 0]) < cx / fx * cam[:, 2] + half * 2
        mask_y = torch.abs(cam[:, 1]) < cy / fy * cam[:, 2] + half * 2
        seen += (mask_z & mask_x & mask_y).to(torch.int32)
    count[0, indices] += seen.to(count.dtype)
    return dict(state, density_grid=torch.where(count == 0, -1.0, state["density_grid"]))


def empty_state(rs: RenderSettings, device, audio_dim: int = 64) -> dict:
    """The state of a new identity: zero grids, the whole box, no cell."""
    H, b = rs.grid_size, rs.bound
    return {"density_grid": torch.zeros((1, H**3), device=device),
            "mean_density": torch.zeros((), device=device),
            "density_grid_torso": torch.zeros((H * H,), device=device),
            "mean_density_torso": torch.zeros((), device=device),
            "sigma_bytes": torch.zeros((H**3,), dtype=torch.uint8, device=device),
            "occ_bbox": torch.tensor([-b, -b, -b, b, b, b], device=device),
            "occ_sphere": torch.tensor([0.0, 0.0, 0.0, b * SQRT3], device=device),
            "enc_a_smooth": torch.zeros((1, audio_dim), device=device), "enc_a_init": False}

