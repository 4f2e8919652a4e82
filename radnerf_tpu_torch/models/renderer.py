"""Inference renderer (counterpart of ``radnerf_tpu/models/renderer.py``).

``render_rays`` keeps the semantics of the JAX ``render_rays`` with
``training=False`` and drops its TPU plumbing: the compacted field
evaluation with markers and wide-row return trips becomes
``valid.nonzero()`` -> field on the packed samples -> scatter back into
``[N, S]``; row gathers become plain indexing. The port never drops work,
so the static capacities of the JAX config (``sample_capacity_mult``,
``ray_capacity_frac``, ``torso_capacity_frac``) have nothing to size; the
result equals the JAX one at exhaustive capacities. ``march_iters`` (K) and
``sample_slots`` (S) truncate the march and are honoured.

The march (kernel B), the three grid encodes (kernel A) and the compositor
(kernel C) run as hand-written CUDA kernels on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops import (
    MarchConfig,
    build_sigma_bytes,
    composite_rays,
    march_rays,
    morton3d_invert,
    near_far_from_aabb,
    packbits,
)
from .network import NeRFNetwork

GRID_SIZE = 128
SQRT3 = 1.7320508075688772


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (the JAX ``RenderConfig``, minus the
    capacity knobs that only size TPU buffers, and minus ``exp_eye`` and
    ``density_scale``, which no caller sets: the renderer never reads the
    first and the second is always 1)."""

    bound: float = 1.0
    min_near: float = 0.05
    density_thresh: float = 10.0
    density_thresh_torso: float = 0.01
    max_steps: int = 16
    dt_gamma: float = 1.0 / 256
    grid_size: int = GRID_SIZE
    torso: bool = False
    smooth_lips: bool = False
    T_thresh: float = 1e-4
    march_iters: Optional[int] = None
    sample_slots: Optional[int] = None
    cull_T: float = 1e-6

    @property
    def cascade(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    @property
    def aabb(self) -> tuple:
        b = self.bound
        return (-b, -b / 2, -b, b, b / 2, b)

    def march_config(self) -> MarchConfig:
        return MarchConfig(bound=self.bound, cascade=self.cascade,
                           grid_size=self.grid_size, max_steps=self.max_steps,
                           dt_gamma=self.dt_gamma, march_iters=self.march_iters,
                           sample_slots=self.sample_slots)


@dataclasses.dataclass
class RendererState:
    """Occupancy and audio state the renderer reads (the JAX
    ``RendererState`` without its TPU row layouts)."""

    density_grid: torch.Tensor  # [cascade, H^3] float32, Morton order
    density_bitfield: torch.Tensor  # [cascade*H^3//8] uint8
    sigma_bytes: torch.Tensor  # [cascade*H^3] uint8 occupancy | log-sigma
    mean_density: torch.Tensor  # [] float32
    density_grid_torso: torch.Tensor  # [H^2] float32
    mean_density_torso: torch.Tensor  # [] float32
    occ_bbox: torch.Tensor  # [6] world bounds of occupied cells
    occ_sphere: torch.Tensor  # [4] centre and radius
    enc_a_smooth: torch.Tensor  # [1, audio_dim]
    enc_a_initialized: torch.Tensor  # [] bool

    def to(self, device) -> "RendererState":
        return RendererState(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


def _cell_coords(H: int, device) -> torch.Tensor:
    return morton3d_invert(torch.arange(H**3, device=device)).float()


def compute_occ_bbox(cfg: RenderConfig, density_grid: torch.Tensor, thresh) -> torch.Tensor:
    """World-space bounding box of occupied cells over all cascades; the full
    box when nothing is occupied."""
    H = cfg.grid_size
    coords = _cell_coords(H, density_grid.device)
    inf = torch.full((3,), math.inf, device=density_grid.device)
    lo, hi = inf, -inf
    for cas in range(cfg.cascade):
        mip_bound = min(2.0**cas, cfg.bound)
        occ = (density_grid[cas] > thresh)[:, None]
        cmin = torch.where(occ, coords, math.inf).amin(dim=0)
        cmax = torch.where(occ, coords, -math.inf).amax(dim=0)
        lo = torch.minimum(lo, (2.0 * cmin / H - 1.0) * mip_bound)
        hi = torch.maximum(hi, (2.0 * (cmax + 1.0) / H - 1.0) * mip_bound)
    if not bool(torch.isfinite(lo).all()):
        b = cfg.bound
        lo, hi = lo.new_tensor([-b, -b, -b]), hi.new_tensor([b, b, b])
    return torch.cat([lo, hi]).float()


def compute_occ_sphere(cfg: RenderConfig, density_grid: torch.Tensor, thresh) -> torch.Tensor:
    """Bounding sphere [cx, cy, cz, r] of occupied cells, centred on the
    occupied bbox; radius bound*sqrt(3) when nothing is occupied."""
    H = cfg.grid_size
    coords = _cell_coords(H, density_grid.device)
    bbox = compute_occ_bbox(cfg, density_grid, thresh)
    center = 0.5 * (bbox[:3] + bbox[3:])
    r = density_grid.new_zeros(())
    for cas in range(cfg.cascade):
        mip_bound = min(2.0**cas, cfg.bound)
        occ = density_grid[cas] > thresh
        world = (2.0 * (coords + 0.5) / H - 1.0) * mip_bound
        dist = torch.linalg.norm(world - center, dim=-1) + SQRT3 * mip_bound / H
        r = torch.maximum(r, torch.where(occ, dist, 0.0).max())
    if not bool(r > 0):
        r = r.new_tensor(cfg.bound * SQRT3)
    return torch.cat([center, r[None]]).float()


def make_state(cfg: RenderConfig, density_grid: torch.Tensor, density_grid_torso: torch.Tensor,
               mean_density: float, mean_density_torso: float, thresh=None,
               density_bitfield: Optional[torch.Tensor] = None,
               audio_dim: int = 64) -> RendererState:
    """Renderer state from density grids on their device; the occupancy
    threshold defaults to min(mean_density, density_thresh) as the JAX
    grid update uses. Derives sigma_bytes, occ_bbox and occ_sphere (and the
    bitfield unless given)."""
    dev = density_grid.device
    if thresh is None:
        thresh = min(float(mean_density), cfg.density_thresh)
    if density_bitfield is None:
        density_bitfield = packbits(density_grid, thresh)
    return RendererState(
        density_grid=density_grid,
        density_bitfield=density_bitfield,
        sigma_bytes=build_sigma_bytes(density_grid, thresh),
        mean_density=torch.tensor(float(mean_density), dtype=torch.float32, device=dev),
        density_grid_torso=density_grid_torso,
        mean_density_torso=torch.tensor(float(mean_density_torso), dtype=torch.float32,
                                        device=dev),
        occ_bbox=compute_occ_bbox(cfg, density_grid, thresh),
        occ_sphere=compute_occ_sphere(cfg, density_grid, thresh),
        enc_a_smooth=torch.zeros((1, audio_dim), dtype=torch.float32, device=dev),
        enc_a_initialized=torch.zeros((), dtype=torch.bool, device=dev),
    )


def bilinear_sample_2d(grid_flat: torch.Tensor, coords: torch.Tensor, H: int) -> torch.Tensor:
    """Sample a flat [H*H] grid at coords [..., 2] in [-1, 1], as
    ``F.grid_sample(align_corners=True)`` on the reference's flat layout
    ``flat[c1*H + c0]``."""
    a = (coords[..., 0] + 1.0) * 0.5 * (H - 1)  # minor axis
    b = (coords[..., 1] + 1.0) * 0.5 * (H - 1)  # major axis
    a0 = torch.clamp(torch.floor(a), 0, H - 1)
    b0 = torch.clamp(torch.floor(b), 0, H - 1)
    b1 = torch.clamp(b0 + 1, 0, H - 1)
    a1 = torch.clamp(a0 + 1, 0, H - 1)  # at a0 == H-1, wa == 0
    wa = torch.clamp(a - a0, 0.0, 1.0)
    wb = torch.clamp(b - b0, 0.0, 1.0)
    a0i, a1i, b0i, b1i = (v.long() for v in (a0, a1, b0, b1))
    top = grid_flat[b0i * H + a0i] * (1 - wa) + grid_flat[b0i * H + a1i] * wa
    bot = grid_flat[b1i * H + a0i] * (1 - wa) + grid_flat[b1i * H + a1i] * wa
    return top * (1 - wb) + bot * wb


def smooth_audio_code(state: RendererState, enc_a: torch.Tensor, enabled: bool):
    """enc_a EMA 0.35*prev + 0.65*new (reference renderer.py:190-194).
    Returns (code, new state)."""
    if not enabled:
        return enc_a, state
    lam = 0.35
    smoothed = torch.where(state.enc_a_initialized,
                           lam * state.enc_a_smooth + (1 - lam) * enc_a, enc_a)
    return smoothed, dataclasses.replace(
        state, enc_a_smooth=smoothed,
        enc_a_initialized=torch.ones_like(state.enc_a_initialized))


def march_window(state: RendererState, o, d, nears, fars):
    """Marched interval per ray: the occupied bbox AND the bounding sphere,
    inside [nears, fars]. Returns (t_lo, t_hi); the ray hits iff t_lo < t_hi."""
    bb = state.occ_bbox
    tb0 = (bb[:3] - o) / d
    tb1 = (bb[3:] - o) / d
    lo = torch.maximum(torch.minimum(tb0, tb1).amax(dim=-1), nears)
    hi = torch.minimum(torch.maximum(tb0, tb1).amin(dim=-1), fars)
    oc = o - state.occ_sphere[:3]
    b_half = (oc * d).sum(dim=-1)
    disc = b_half * b_half - ((oc * oc).sum(dim=-1) - state.occ_sphere[3] ** 2)
    sq = torch.sqrt(disc.clamp_min(0.0))
    lo = torch.maximum(lo, -b_half - sq)
    hi = torch.minimum(hi, torch.where(disc > 0, -b_half + sq, -math.inf))
    return lo, hi


def field_on_lattice(net: NeRFNetwork, march: dict, rays_d, enc_a, ind_code, eye):
    """Evaluate the field on the valid samples of a [N, S] march only, and
    scatter (sigma [N, S], color [N, S, 3], ambient [N, S, amb]) back; invalid
    slots hold zeros."""
    valid = march["valid"]
    N, S = valid.shape
    idx = valid.reshape(-1).nonzero().squeeze(1)
    xyz = march["xyz"].reshape(-1, 3)[idx]
    dirs = rays_d[idx // S]
    sig_c, col_c, amb_c = net.field_forward(xyz, dirs, enc_a, ind_code, eye)
    sigma = sig_c.new_zeros(N * S).index_copy_(0, idx, sig_c)
    color = col_c.new_zeros(N * S, 3).index_copy_(0, idx, col_c)
    amb = amb_c.new_zeros(N * S, amb_c.shape[-1]).index_copy_(0, idx, amb_c)
    return sigma.view(N, S), color.view(N, S, 3), amb.view(N, S, -1)


@torch.no_grad()
def render_rays(net: NeRFNetwork, cfg: RenderConfig, state: RendererState,
                rays_o, rays_d, auds, bg_coords, pose6, eye, index, bg_color,
                training: bool = False):
    """Render a batch of rays: head field over the torso layer over the
    background (reference run_cuda, renderer.py:158-316).

    Args:
      rays_o, rays_d: [N, 3]; auds: [seq, audio_in_dim, 16] or None;
      bg_coords: [N, 2]; pose6: [1, 6]; eye: [1, 1] or None; index: frame
      index (unused at inference: the individual codes use row 0);
      bg_color: [N, 3].

    Returns (results, state): image [N, 3], weights_sum [N] (the head's
      opacity), depth [N] (normalised by the full-AABB near/far),
      torso_alpha / torso_color / deform with the torso, and the telemetry
      n_hit, n_k_span, n_samples_needed, n_max_count, n_torso_mask as 0-dim
      int tensors.
    """
    if training:
        raise NotImplementedError("the port renders inference frames only")
    if rays_o.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the float32 render needs them off")
    mcfg = cfg.march_config()
    aabb = rays_o.new_tensor(cfg.aabb)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)

    enc_a = net.encode_audio(auds)
    if enc_a is not None and cfg.smooth_lips:
        enc_a, state = smooth_audio_code(state, enc_a, True)
    ind_code = net.individual_codes[0] if net.individual_codes is not None else None

    t_lo, t_hi = march_window(state, rays_o, rays_d, nears, fars)
    hit = t_lo < t_hi
    results = {
        "n_hit": hit.sum(dtype=torch.int32),
        # the widest marched window in orbit steps (what K has to cover)
        "n_k_span": torch.where(hit, torch.ceil((t_hi - t_lo) / mcfg.dt_min),
                                0.0).max().to(torch.int32),
    }

    march = march_rays(rays_o, rays_d, nears, fars, state.sigma_bytes, mcfg,
                       t_window=(t_lo, t_hi), cull_T=cfg.cull_T)
    sig, col, amb = field_on_lattice(net, march, rays_d, enc_a, ind_code, eye)
    comp = composite_rays(sig, col, march["dt"], march["t"],
                          march["valid"], ambient=amb.abs().sum(dim=-1),
                          T_thresh=cfg.T_thresh)
    results["n_samples_needed"] = march["valid"].sum(dtype=torch.int32)
    results["n_max_count"] = march["count"].max()
    weights_sum = torch.where(hit, comp["weights_sum"], 0.0)
    depth_raw = torch.where(hit, comp["depth"], 0.0)
    image = torch.where(hit[:, None], comp["image"], 0.0)

    if cfg.torso:
        code_t = (net.individual_codes_torso[0]
                  if net.individual_codes_torso is not None else None)
        thresh_t = torch.clamp(state.mean_density_torso, max=cfg.density_thresh_torso)
        occupancy = bilinear_sample_2d(state.density_grid_torso, bg_coords, cfg.grid_size)
        mask = occupancy > thresh_t
        results["n_torso_mask"] = mask.sum(dtype=torch.int32)
        t_alpha, t_color, deform = net.forward_torso(bg_coords, pose6, code_t)
        t_alpha = torch.where(mask[:, None], t_alpha, 0.0)
        t_color = torch.where(mask[:, None], t_color, 0.0)
        bg_color = t_color * t_alpha + bg_color * (1.0 - t_alpha)
        results["deform"] = deform
        results["torso_alpha"] = t_alpha
        results["torso_color"] = bg_color

    image = torch.clamp(image + (1.0 - weights_sum)[:, None] * bg_color, 0.0, 1.0)
    results["image"] = image
    results["weights_sum"] = weights_sum
    results["depth"] = torch.clamp(depth_raw - nears, min=0.0) / torch.clamp(
        fars - nears, min=1e-8)
    return results, state
