"""An inference frame of ER-NeRF's field in plain PyTorch: the head field
over the torso layer over the background, on the renderer state, march,
compositor and bilinear lookup of ``render.py`` and ``ops.py`` (used as they
are), with ``field_triplane.py``'s field and torso. It imports nothing of
the program."""

from __future__ import annotations

import torch

from . import field_triplane as ftri
from .ops import composite_rays, march_rays, near_far_from_aabb
from .render import RenderSettings, bilinear_sample_2d, march_window


def render(p, arch: ftri.Arch, rs: RenderSettings, state: dict, batch: dict, enc_a) -> dict:
    """A frame's rays at the default capacities: ``batch`` holds rays_o,
    rays_d, bg_coords, poses_matrix [1, 4, 4], eye, bg_color; ``enc_a`` the
    frame's (smoothed) audio code. Returns image, weights_sum, depth and the
    telemetry n_hit and n_samples."""
    ro, rd = batch["rays_o"], batch["rays_d"]
    nears, fars = near_far_from_aabb(ro, rd, ro.new_tensor(rs.aabb), rs.min_near)
    t_lo, t_hi = march_window(state, ro, rd, nears, fars)
    hit = t_lo < t_hi
    march = march_rays(ro, rd, nears, fars, state["sigma_bytes"], rs.march(), (t_lo, t_hi),
                       rs.cull_T, None)
    valid = march["valid"]
    N, S = valid.shape
    idx = valid.reshape(-1).nonzero().squeeze(1)
    sig_c, col_c, amb_c = ftri.field_forward(p, arch, march["xyz"].reshape(-1, 3)[idx],
                                             rd[idx // S], enc_a, p["individual_codes"][0],
                                             batch["eye"])
    sigma = sig_c.new_zeros(N * S).index_copy(0, idx, sig_c).view(N, S)
    color = col_c.new_zeros(N * S, 3).index_copy(0, idx, col_c).view(N, S, 3)
    amb = amb_c.new_zeros(N * S, 1).index_copy(0, idx, amb_c).view(N, S)
    comp = composite_rays(sigma, color, march["dt"], march["t"], valid, amb, rs.T_thresh)
    weights_sum = torch.where(hit, comp["weights_sum"], 0.0)
    image = torch.where(hit[:, None], comp["image"], 0.0)
    depth_raw = torch.where(hit, comp["depth"], 0.0)
    bg = batch["bg_color"]
    if rs.torso:
        thresh_t = torch.clamp(state["mean_density_torso"], max=rs.density_thresh_torso)
        mask = bilinear_sample_2d(state["density_grid_torso"], batch["bg_coords"],
                                  rs.grid_size) > thresh_t
        t_alpha, t_color = ftri.forward_torso(p, arch, batch["bg_coords"],
                                              batch["poses_matrix"],
                                              p["individual_codes_torso"][0])
        t_alpha = torch.where(mask[:, None], t_alpha, 0.0)
        t_color = torch.where(mask[:, None], t_color, 0.0)
        bg = t_color * t_alpha + bg * (1.0 - t_alpha)
    return {"image": torch.clamp(image + (1.0 - weights_sum)[:, None] * bg, 0.0, 1.0),
            "weights_sum": weights_sum, "n_hit": int(hit.sum()), "n_samples": int(valid.sum()),
            "depth": torch.clamp(depth_raw - nears, min=0.0) / torch.clamp(fars - nears,
                                                                            min=1e-8)}
