"""Renderer and grid maintenance (counterpart of
``radnerf_tpu/models/renderer.py``).

``render_rays`` keeps the semantics of the JAX ``render_rays`` and drops its
TPU plumbing: the compacted field
evaluation with markers and wide-row return trips becomes
``valid.nonzero()`` -> field on the packed samples -> scatter back into
``[N, S]``; row gathers become plain indexing. The port never drops work:
the buffer capacities of the JAX config (``sample_capacity_mult``,
``ray_capacity_frac``, ``torso_capacity_frac``, ``march_group_mult``) are
carried for ``train/capacity.py`` and the checkpoints, and size nothing
here; the result equals the JAX one at exhaustive capacities.
``march_iters`` (K), ``sample_slots`` (S) and ``march_group_slots``
truncate the march and are honoured.

The march (kernel B, or with ``march_group`` the two-level march B-grouped
where the config qualifies), the three grid encodes (kernel A, or its bf16 variant
under the bf16 policy) and the compositor (kernel C) run as hand-written
CUDA kernels on the card. Under the bf16 policy the field's outputs come
back to the [N, S] lattice through bf16, as the JAX compacted return trip
carries them (``renderer.py:370-371``), and the density-grid upkeep queries
the bf16 field. With
``training=True`` the march takes the perturbation ``noises`` and autograd
runs through the grid encodes and the compositor into kernels A' and C'
(the head stage), or through the torso's grid encode alone into A' (the
torso stage, whose frozen head records no graph). With ``train_camera`` the
rays first turn and move by the frame's learnt offsets; B marches them
detached and the sample positions are formed again from its t under
autograd, so no backward of B is needed.

An inference frame on the card (``training=False``, outside data
parallelism) replays its fixed-shape stretches from CUDA graphs captured
at its key's second frame in a row (``_render_graphed``,
``frame_graph.py``): the audio net and the march; the torso's mask and
deformation; the torso MLP, the compositor, blend and depth. The
compaction, whose sample count the host reads back, the torso's grid
encode and the field on exactly the valid samples run eagerly between
them. The box (``aabb``) is a device constant made once per bound and
device on every path.

Grid maintenance: ``RendererState.create``, ``reset_extra_state``,
``mark_untrained_grid`` (cells no training camera sees become -1),
``update_density_grid`` (the head: jittered density queries at every cell
centre, 6-neighbour dilation, EMA max, re-derived occupancy) and
``update_torso_grid`` (the torso: jittered alpha queries at every pixel of
an H x H lattice, 5x5 max pool, EMA max).
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import (
    MarchConfig,
    build_coarse_bytes,
    build_sigma_bytes,
    composite_rays,
    grouped_march_qualifies,
    march_rays,
    march_rays_grouped,
    morton3d,
    morton3d_invert,
    morton_dilate,
    near_far_from_aabb,
    packbits,
)
from ..ops.marching import MARCH_GROUP
from ..utils.tracing import span, sync
from . import frame_graph
from .frame_graph import Segment, can_capture, count_eager, warm_up
from .network import NeRFNetwork

GRID_SIZE = 128
SQRT3 = 1.7320508075688772


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (the JAX ``RenderConfig``, minus
    ``exp_eye`` and ``density_scale``, which no caller sets: the renderer
    never reads the first and the second is always 1).

    ``march_group`` turns on the two-level march (``march_rays_grouped``)
    where the config qualifies, as JAX's ``run_head`` chooses: the affine
    orbit, cascade 1 and ceil(K / 4) <= 24 groups; else the dense march
    runs. At the defaults (bound 1, grid 128, max_steps 16) K is 129 and
    ceil(K / 4) 33, so the renderer marches densely unless ``march_iters``
    is at most 96. ``march_group_slots`` fine-marches only a ray's first
    kept groups (None: all).

    ``ray_capacity_frac``, ``sample_capacity_mult``, ``torso_capacity_frac``
    and ``march_group_mult`` are JAX's buffer capacities, with its names and
    defaults. The renderer reads none of them and drops no work at them;
    ``train/capacity.py`` sizes them as JAX does, and the checkpoints record
    them. After adaptation K can fall to 96 or less, where the two-level
    march qualifies.
    """

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
    march_group: bool = False
    march_group_slots: Optional[int] = None
    # JAX's buffer capacities (see the class docstring)
    ray_capacity_frac: float = 1.0
    sample_capacity_mult: float = 4.0
    torso_capacity_frac: Optional[float] = None
    march_group_mult: float = 4.0

    @property
    def cascade(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    @staticmethod
    def ray_capacity(n_rays: int, frac: float) -> int:
        """JAX's compacted-ray count for a capacity fraction (x128 rows)."""
        return max(128, int(-(-n_rays * min(frac, 1.0) // 128)) * 128)

    @staticmethod
    def sample_capacity(n_rays_cap: int, mult: float) -> int:
        """JAX's field-eval buffer rows for a compacted ray count (x128)."""
        return max(128, int(-(-n_rays_cap * mult // 128)) * 128)

    @property
    def aabb(self) -> tuple:
        b = self.bound
        return (-b, -b / 2, -b, b, b / 2, b)

    def march_config(self) -> MarchConfig:
        return MarchConfig(bound=self.bound, cascade=self.cascade,
                           grid_size=self.grid_size, max_steps=self.max_steps,
                           dt_gamma=self.dt_gamma, march_iters=self.march_iters,
                           sample_slots=self.sample_slots)

    @staticmethod
    def from_options(opt) -> "RenderConfig":
        return RenderConfig(bound=opt.bound, min_near=opt.min_near,
                            density_thresh=opt.density_thresh,
                            density_thresh_torso=opt.density_thresh_torso,
                            max_steps=opt.max_steps, dt_gamma=opt.dt_gamma, torso=opt.torso,
                            smooth_lips=opt.smooth_lips, march_iters=opt.march_iters,
                            cull_T=opt.cull_T, sample_capacity_mult=opt.sample_capacity_mult,
                            ray_capacity_frac=opt.ray_capacity_frac)


@dataclasses.dataclass
class RendererState:
    """Occupancy and audio state the renderer reads (the JAX
    ``RendererState`` without its TPU row layouts). ``coarse_bytes`` is
    derived from ``sigma_bytes`` (``build_coarse_bytes``) and set with it:
    set both through ``with_sigma_bytes`` (JAX's invariant)."""

    density_grid: torch.Tensor  # [cascade, H^3] float32, Morton order
    density_bitfield: torch.Tensor  # [cascade*H^3//8] uint8
    sigma_bytes: torch.Tensor  # [cascade*H^3] uint8 occupancy | log-sigma
    coarse_bytes: torch.Tensor  # [cascade*(H/4)^3] uint8 supercells, Morton order
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

    def with_sigma_bytes(self, sigma_bytes: torch.Tensor) -> "RendererState":
        """The state with these sigma bytes and the coarse bytes built from
        them (JAX ``with_sigma_bytes``)."""
        cas, ncells = self.density_grid.shape
        coarse = build_coarse_bytes(sigma_bytes, cas, round(ncells ** (1.0 / 3.0)))
        return dataclasses.replace(self, sigma_bytes=sigma_bytes, coarse_bytes=coarse)

    @staticmethod
    def create(cfg: "RenderConfig", audio_dim: int = 64, device="cuda") -> "RendererState":
        """An empty state, as JAX ``RendererState.create``: zero grids, no
        occupied cell, the full cube as the occupied box."""
        dev = resolve_device(device)
        H, cas, b = cfg.grid_size, cfg.cascade, cfg.bound
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return RendererState(
            density_grid=torch.zeros((cas, H**3), dtype=torch.float32, device=dev),
            density_bitfield=torch.zeros((cas * H**3 // 8,), dtype=torch.uint8, device=dev),
            sigma_bytes=torch.zeros((cas * H**3,), dtype=torch.uint8, device=dev),
            coarse_bytes=torch.zeros((cas * (H // MARCH_GROUP)**3,), dtype=torch.uint8,
                                     device=dev),
            mean_density=zero.clone(),
            density_grid_torso=torch.zeros((H * H,), dtype=torch.float32, device=dev),
            mean_density_torso=zero.clone(),
            occ_bbox=torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=dev),
            occ_sphere=torch.tensor([0.0, 0.0, 0.0, b * SQRT3], dtype=torch.float32,
                                    device=dev),
            enc_a_smooth=torch.zeros((1, audio_dim), dtype=torch.float32, device=dev),
            enc_a_initialized=torch.zeros((), dtype=torch.bool, device=dev),
        )


def reset_extra_state(cfg: RenderConfig, state: RendererState) -> RendererState:
    """Zero the head grid, its bitfield and counters; keep the torso grid
    (reference renderer.py:145-155)."""
    fresh = RendererState.create(cfg, state.enc_a_smooth.shape[-1], state.density_grid.device)
    return dataclasses.replace(fresh, density_grid_torso=state.density_grid_torso,
                               mean_density_torso=state.mean_density_torso)


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
    with sync("occ_bbox"):
        empty = not bool(torch.isfinite(lo).all())
    if empty:
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
    with sync("occ_sphere"):
        empty = not bool(r > 0)
    if empty:
        r = r.new_tensor(cfg.bound * SQRT3)
    return torch.cat([center, r[None]]).float()


def _occupancy(cfg: RenderConfig, grid: torch.Tensor, thresh) -> dict:
    """The state fields derived from a head grid at an occupancy threshold:
    bitfield, sigma bytes and their coarse bytes, occupied box and sphere."""
    sigma_bytes = build_sigma_bytes(grid, thresh)
    return dict(density_bitfield=packbits(grid, thresh), sigma_bytes=sigma_bytes,
                coarse_bytes=build_coarse_bytes(sigma_bytes, cfg.cascade, cfg.grid_size),
                occ_bbox=compute_occ_bbox(cfg, grid, thresh),
                occ_sphere=compute_occ_sphere(cfg, grid, thresh))


def make_state(cfg: RenderConfig, density_grid: torch.Tensor, density_grid_torso: torch.Tensor,
               mean_density: float, mean_density_torso: float, thresh=None,
               density_bitfield: Optional[torch.Tensor] = None,
               audio_dim: int = 64) -> RendererState:
    """Renderer state from density grids on their device; the occupancy
    threshold defaults to min(mean_density, density_thresh) as the JAX
    grid update uses. Derives sigma_bytes, coarse_bytes, occ_bbox and
    occ_sphere (and the bitfield unless given)."""
    dev = density_grid.device
    if thresh is None:
        thresh = min(float(mean_density), cfg.density_thresh)
    derived = _occupancy(cfg, density_grid, thresh)
    if density_bitfield is not None:
        derived["density_bitfield"] = density_bitfield
    return RendererState(
        density_grid=density_grid,
        mean_density=torch.tensor(float(mean_density), dtype=torch.float32, device=dev),
        density_grid_torso=density_grid_torso,
        mean_density_torso=torch.tensor(float(mean_density_torso), dtype=torch.float32,
                                        device=dev),
        enc_a_smooth=torch.zeros((1, audio_dim), dtype=torch.float32, device=dev),
        enc_a_initialized=torch.zeros((), dtype=torch.bool, device=dev),
        **derived,
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
    Returns (code, new state). The state keeps the code detached: the next
    call reads it as a constant, as the JAX step reads its incoming state
    (kept with its graph, a training step would backpropagate into the
    previous step's freed graph)."""
    if not enabled:
        return enc_a, state
    lam = 0.35
    smoothed = torch.where(state.enc_a_initialized,
                           lam * state.enc_a_smooth + (1 - lam) * enc_a, enc_a)
    return smoothed, dataclasses.replace(
        state, enc_a_smooth=smoothed.detach(),
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


def compacted_index(valid: torch.Tensor) -> torch.Tensor:
    """The flat indices of the valid slots of a [N, S] lattice; the host
    reads their count back."""
    with sync("compact"):
        return valid.reshape(-1).nonzero().squeeze(1)


def field_on_lattice(net: NeRFNetwork, march: dict, rays_d, enc_a, ind_code, eye, out=None,
                     idx=None):
    """Evaluate the field on the valid samples of a [N, S] march only, and
    scatter (sigma [N, S], color [N, S, 3], ambient [N, S, amb]) back; invalid
    slots hold zeros. ``out``: zeroed flat (sigma [N * S], color [N * S, 3],
    ambient [N * S, amb]) to scatter into (a captured frame's), else new;
    ``idx``: the lattice's ``compacted_index``, taken here if None."""
    valid = march["valid"]
    N, S = valid.shape
    if idx is None:
        idx = compacted_index(valid)
    xyz = march["xyz"].reshape(-1, 3)[idx]
    dirs = rays_d[idx // S]
    sig_c, col_c, amb_c = net.field_forward(xyz, dirs, enc_a, ind_code, eye)
    if net.cfg.compute_dtype == "bfloat16":
        sig_c, col_c, amb_c = (v.to(torch.bfloat16).float() for v in (sig_c, col_c, amb_c))
    if out is None:
        out = (sig_c.new_zeros(N * S), col_c.new_zeros(N * S, 3),
               amb_c.new_zeros(N * S, amb_c.shape[-1]))
    sigma, color, amb = (o.index_copy_(0, idx, v) for o, v in zip(out, (sig_c, col_c, amb_c)))
    return sigma.view(N, S), color.view(N, S, 3), amb.view(N, S, -1)


def render_rays(net: NeRFNetwork, cfg: RenderConfig, state: RendererState,
                rays_o, rays_d, auds, bg_coords, pose6, eye, index, bg_color,
                noises=None, training: bool = False, poses_matrix=None):
    """Render a batch of rays: head field over the torso layer over the
    background (reference run_cuda, renderer.py:158-316).

    Args:
      rays_o, rays_d: [N, 3]; auds: [seq, audio_in_dim, 16] or None;
      bg_coords: [N, 2]; pose6: [1, 6]; eye: [1, 1] or None; index: frame
      index (the row of the individual codes, head and torso, when
      training; row 0 otherwise);
      bg_color: [N, 3]; noises: [N] in [0, 1) or None, the march
      perturbation; poses_matrix: the frame's 4x4 pose [1, 4, 4], which
      a network whose ``torso_pose`` names it (ER-NeRF's field) takes in
      the torso layer in the place of pose6.
      training: run with autograd (a train step of either stage) and
        return ``ambient``, the per-ray ambient sum the head loss reads;
        with ``train_camera`` the rays first move by frame ``index``'s
        learnt offsets (``camera_offsets``). Inference runs under
        ``torch.no_grad()``, on CUDA tensors outside data parallelism
        through the captured frame (``_render_graphed``): the same kernels
        on the same samples. The torso runs on every pixel and is masked
        afterwards (the JAX path at ``torso_capacity_frac >= 1``).

    Returns (results, state): image [N, 3], weights_sum [N] (the head's
      opacity), depth [N] (normalised by the full-AABB near/far),
      torso_alpha / torso_color / deform with the torso, ambient [N] when
      training, and the telemetry n_hit, n_k_span, n_samples_needed,
      n_max_count, n_groups_needed, n_group_max (the two-level march's kept
      groups, their sum and per-ray max before the ``march_group_slots``
      truncation; 0 when the march is dense), n_torso_mask as 0-dim int
      tensors. No result shares memory with another call's.
    """
    if rays_o.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the float32 render needs them off")
    if rays_o.is_cuda and net.cfg.compute_dtype == "bfloat16" and \
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        # cuBLAS would then sum split-K partials in bf16, which JAX does not
        raise RuntimeError("bf16 reduced-precision GEMM reductions are on; the bf16 "
                           "render needs them off")
    if not training:
        with torch.no_grad():
            if frame_graph.engages(rays_o):
                out = _render_graphed(net, cfg, state, rays_o, rays_d, auds, bg_coords, pose6,
                                      eye, bg_color, noises, poses_matrix)
                if out is not None:
                    return out
            count_eager()
            return _render(net, cfg, state, rays_o, rays_d, auds, bg_coords, pose6, eye,
                           0, bg_color, noises, False, poses_matrix)
    count_eager()
    return _render(net, cfg, state, rays_o, rays_d, auds, bg_coords, pose6, eye, index,
                   bg_color, noises, True, poses_matrix)


def camera_offsets(net: NeRFNetwork, index, rays_o, rays_d):
    """The rays of frame ``index`` moved by its learnt camera offsets (JAX
    ``renderer.py:432-448``, reference renderer.py:169-175): ``rays_o + dT``
    and the row-vector product ``rays_d @ dR``, dR = rx @ ry @ rz of the
    frame's ``camera_dR`` in degrees (+1e-8 rad)."""
    dT = net.camera_dT[index]
    # divide by a tensor (see _grid_points)
    ang = net.camera_dR[index] / torch.full((), 180.0, device=dT.device) * math.pi + 1e-8
    ca, sa = torch.cos(ang), torch.sin(ang)
    one, zero = torch.ones_like(ca[0]), torch.zeros_like(ca[0])

    def mat(*rows):
        return torch.stack([torch.stack(r) for r in rows])

    rx = mat((one, zero, zero), (zero, ca[0], -sa[0]), (zero, sa[0], ca[0]))
    ry = mat((ca[1], zero, sa[1]), (zero, one, zero), (-sa[1], zero, ca[1]))
    rz = mat((ca[2], -sa[2], zero), (sa[2], ca[2], zero), (zero, zero, one))
    return rays_o + dT, rays_d @ (rx @ ry @ rz)


def sample_positions(rays_o, rays_d, t, bound: float):
    """``clip(o + t d, -bound, bound)`` [N, S, 3] of the march's ``t`` [N,
    S], as kernel B forms its xyz (a multiply, an add, the clamp, each in
    float32), with autograd: ``jnp.clip``'s gradient, split evenly at a
    tie, as lax.max / lax.min split it (``torch.clamp`` would pass all of
    it)."""
    p = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
    with sync("clip_bounds"):
        lo, hi = p.new_tensor(-bound), p.new_tensor(bound)
    return torch.minimum(torch.maximum(p, lo), hi)


_AABBS: dict = {}


def _aabb(cfg: RenderConfig, device) -> torch.Tensor:
    """The full AABB [6] as a float32 device constant, made once per bound
    and device (an upload that no captured frame could hold)."""
    key = (cfg.aabb, device)
    if key not in _AABBS:
        _AABBS[key] = torch.tensor(cfg.aabb, dtype=torch.float32, device=device)
    return _AABBS[key]


def _audio_code(net, cfg, state, auds):
    """The frame's audio code (None without audio) and the state, its EMA
    advanced with ``smooth_lips``."""
    enc_a = net.encode_audio(auds)
    if enc_a is not None and cfg.smooth_lips:
        enc_a, state = smooth_audio_code(state, enc_a, True)
    return enc_a, state


def _march(cfg, state, rays_o, rays_d, noises):
    """The rays marched through the state's occupancy: (the lattice with the
    rays' nears, fars and hit mask in one dict, the march's telemetry)."""
    mcfg = cfg.march_config()
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(cfg, rays_o.device), cfg.min_near)
    t_lo, t_hi = march_window(state, rays_o, rays_d, nears, fars)
    hit = t_lo < t_hi
    telemetry = {
        "n_hit": hit.sum(dtype=torch.int32),
        # the widest marched window in orbit steps (what K has to cover)
        "n_k_span": torch.where(hit, torch.ceil((t_hi - t_lo) / mcfg.dt_min),
                                0.0).max().to(torch.int32),
    }
    if cfg.march_group and grouped_march_qualifies(mcfg):
        n_groups = -(-mcfg.n_march_iters // MARCH_GROUP)
        march = march_rays_grouped(rays_o, rays_d, nears, fars, state.sigma_bytes,
                                   state.coarse_bytes, mcfg, (t_lo, t_hi),
                                   min(cfg.march_group_slots or n_groups, n_groups),
                                   cfg.cull_T, noises)
        telemetry["n_groups_needed"] = march["groups"].sum(dtype=torch.int32)
        telemetry["n_group_max"] = march["groups"].max()
    else:
        march = march_rays(rays_o, rays_d, nears, fars, state.sigma_bytes, mcfg,
                           t_window=(t_lo, t_hi), cull_T=cfg.cull_T, noises=noises)
        telemetry["n_groups_needed"] = telemetry["n_group_max"] = torch.zeros(
            (), dtype=torch.int32, device=rays_o.device)
    return dict(march, nears=nears, fars=fars, hit=hit), telemetry


def _composite(cfg, march, sig, col, amb, training):
    """Kernel C over the field's lattice: the head's image, weights_sum and
    raw depth (0 on rays that miss), its telemetry and, when training, the
    per-ray ambient sum."""
    comp = composite_rays(sig, col, march["dt"], march["t"], march["valid"],
                          ambient=amb.abs().sum(dim=-1), T_thresh=cfg.T_thresh)
    hit = march["hit"]
    out = {"n_samples_needed": march["valid"].sum(dtype=torch.int32),
           "n_max_count": march["count"].max(),
           "weights_sum": torch.where(hit, comp["weights_sum"], 0.0),
           "depth_raw": torch.where(hit, comp["depth"], 0.0),
           "image": torch.where(hit[:, None], comp["image"], 0.0)}
    if training:
        out["ambient"] = torch.where(hit, comp["ambient_sum"], 0.0)
    return out


def _torso_pose(net, pose6, poses_matrix):
    """The pose the network's torso takes (``net.torso_pose``): RAD-NeRF's
    6 numbers, or the frame's 4x4 matrix."""
    if net.torso_pose == "pose6":
        return pose6
    if poses_matrix is None:
        raise ValueError(f"{type(net).__name__}'s torso takes the frame's 4x4 pose: pass "
                         "render_rays the batch's poses_matrix")
    return poses_matrix


def _torso_deform(net, cfg, state, bg_coords, pose, index):
    """The torso layer's stretch before its grid encode: the torso grid's
    mask at every pixel and the network's ``torso_deform`` coords,
    features and offsets (``pose``: what ``_torso_pose`` gives)."""
    code_t = (net.individual_codes_torso[index]
              if net.individual_codes_torso is not None else None)
    thresh_t = torch.clamp(state.mean_density_torso, max=cfg.density_thresh_torso)
    occupancy = bilinear_sample_2d(state.density_grid_torso, bg_coords, cfg.grid_size)
    mask = occupancy > thresh_t
    x, h, dx = net.torso_deform(bg_coords, pose, code_t)
    return {"mask": mask, "n_torso_mask": mask.sum(dtype=torch.int32), "x": x, "h": h,
            "deform": dx}


def _torso_layer(net, pre, enc_t, bg_color):
    """The torso layer after its grid encode ``enc_t``, masked, over the
    background: n_torso_mask, deform, torso_alpha and torso_color (the
    background the head is blended over)."""
    t_alpha, t_color = net.torso_head(enc_t, pre["h"])
    mask = pre["mask"]
    t_alpha = torch.where(mask[:, None], t_alpha, 0.0)
    t_color = torch.where(mask[:, None], t_color, 0.0)
    return {"n_torso_mask": pre["n_torso_mask"], "deform": pre["deform"],
            "torso_alpha": t_alpha,
            "torso_color": t_color * t_alpha + bg_color * (1.0 - t_alpha)}


def _torso(net, cfg, state, bg_coords, pose, bg_color, index):
    """The torso layer over the background, masked by the torso grid."""
    pre = _torso_deform(net, cfg, state, bg_coords, pose, index)
    return _torso_layer(net, pre, net.torso_encode(pre["x"], pre["deform"]), bg_color)


def _blend(comp, bg_color, march):
    """The head over the background, and its depth normalised by the full
    AABB's near and far."""
    ws = comp["weights_sum"]
    image = torch.clamp(comp["image"] + (1.0 - ws)[:, None] * bg_color, 0.0, 1.0)
    nears, fars = march["nears"], march["fars"]
    depth = torch.clamp(comp["depth_raw"] - nears, min=0.0) / torch.clamp(fars - nears,
                                                                         min=1e-8)
    return {"image": image, "weights_sum": ws, "depth": depth}


def _render(net, cfg, state, rays_o, rays_d, auds, bg_coords, pose6, eye, index, bg_color,
            noises, training, poses_matrix=None):
    # with learnt camera offsets the gradient reaches the rays only through
    # the samples' positions and the SH directions: as in JAX (near/far
    # under stop_gradient, the window and the march through floor and
    # comparisons), the march takes the rays detached and the positions are
    # formed again from its t under autograd
    camera = training and net.cfg.train_camera
    if camera:
        rays_o, rays_d = camera_offsets(net, index, rays_o, rays_d)
    ro, rd = (rays_o.detach(), rays_d.detach()) if camera else (rays_o, rays_d)

    with span("render.audio"):
        enc_a, state = _audio_code(net, cfg, state, auds)
    ind_code = net.individual_codes[index] if net.individual_codes is not None else None

    with span("render.march"):
        march, results = _march(cfg, state, ro, rd, noises)
        if camera:
            march["xyz"] = sample_positions(rays_o, rays_d, march["t"], cfg.bound)
    with span("render.field"):
        sig, col, amb = field_on_lattice(net, march, rays_d, enc_a, ind_code, eye)
    with span("render.composite"):
        comp = _composite(cfg, march, sig, col, amb, training)
    results.update({k: comp[k] for k in _COMPOSITE_TELEMETRY})
    if training:
        results["ambient"] = comp["ambient"]
    if cfg.torso:
        with span("render.torso"):
            torso = _torso(net, cfg, state, bg_coords, _torso_pose(net, pose6, poses_matrix),
                           bg_color, index)
        results.update(torso)
        bg_color = torso["torso_color"]
    results.update(_blend(comp, bg_color, march))
    return results, state


# the results of a captured frame by segment, in render_rays' order
_MARCH_RESULTS = ("n_hit", "n_k_span", "n_groups_needed", "n_group_max")
_COMPOSITE_TELEMETRY = ("n_samples_needed", "n_max_count")
_TORSO_RESULTS = ("n_torso_mask", "deform", "torso_alpha", "torso_color")
_COMPOSITE_RESULTS = ("image", "weights_sum", "depth")


def _graph_identity(net, state) -> tuple:
    """The addresses of every persistent tensor a captured frame reads in
    place: the parameters, and the state's occupancy, box, sphere and torso
    grid."""
    held = [*net.parameters(), state.sigma_bytes, state.coarse_bytes, state.occ_bbox,
            state.occ_sphere, state.density_grid_torso, state.mean_density_torso]
    return tuple(t.data_ptr() for t in held)


class _CapturedFrame:
    """A network's captured frame: its key and the identity of what it
    reads in place (``_graph_identity``), its static inputs and its
    segments (None until the key's second frame in a row captures them)."""

    def __init__(self, key: tuple, identity: tuple):
        self.key, self.identity, self.static, self.segments = key, identity, None, None

    def capture(self, net, cfg, state, ins: dict, smooth: bool, device):
        """Warm up and capture the segments ``march`` (the audio net and its
        EMA, the window and the march, a zeroed lattice for the field),
        ``torso`` (with the torso: its mask and deformation) and
        ``composite`` (the torso MLP on the eager encode's static copy,
        kernel C, the blend, the depth), which read the static inputs and
        the state in place. They hold the network weakly: it keys them
        (``_FRAMES``), and a strong reference would keep it alive."""
        static = self.static = {k: v.clone(memory_format=torch.contiguous_format)
                                for k, v in ins.items()}
        amb_dim, pose_key = net.ambient_out_dim, net.torso_pose
        net_ref = weakref.ref(net)
        if cfg.torso:
            static["enc_t"] = torch.zeros(
                ins["bg_coords"].shape[0], net.cfg.torso_spec.output_dim,
                dtype=net.cfg.table_dtype or torch.float32, device=device)

        def march_fn():
            st = state
            if smooth:
                st = dataclasses.replace(state, enc_a_smooth=static["enc_a_smooth"],
                                         enc_a_initialized=static["enc_a_initialized"])
            enc_a, st = _audio_code(net_ref(), cfg, st, static.get("auds"))
            march, telemetry = _march(cfg, state, static["rays_o"], static["rays_d"],
                                      static.get("noises"))
            n = march["valid"].numel()
            zeros = march["t"].new_zeros
            out = dict(march, **telemetry, sigma=zeros(n), color=zeros(n, 3),
                       ambient=zeros(n, amb_dim))
            if enc_a is not None:
                out["enc_a"] = enc_a
            if smooth:
                out.update(enc_a_smooth=st.enc_a_smooth, enc_a_initialized=st.enc_a_initialized)
            return out

        def torso_fn():
            return _torso_deform(net_ref(), cfg, state, static["bg_coords"], static[pose_key],
                                 0)

        def composite_fn(m, t):
            N, S = m["valid"].shape
            comp = _composite(cfg, m, m["sigma"].view(N, S), m["color"].view(N, S, 3),
                              m["ambient"].view(N, S, amb_dim), False)
            out = {k: comp[k] for k in _COMPOSITE_TELEMETRY}
            bg = static["bg_color"]
            if t is not None:
                out.update(_torso_layer(net_ref(), t, static["enc_t"], bg))
                bg = out["torso_color"]
            return {**out, **_blend(comp, bg, m)}

        def warm():
            composite_fn(march_fn(), torso_fn() if cfg.torso else None)

        with span("render.graph.capture"):
            warm_up(device, warm)
            pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
            march = Segment("march", march_fn, device, pool)
            torso = Segment("torso", torso_fn, device, pool) if cfg.torso else None
            composite = Segment(
                "composite", lambda: composite_fn(march.outputs, torso and torso.outputs),
                device, pool)
        self.segments = {"march": march, "composite": composite}
        if torso is not None:
            self.segments["torso"] = torso


# each network's one captured frame, dropped with the network
_FRAMES: "weakref.WeakKeyDictionary[NeRFNetwork, _CapturedFrame]" = weakref.WeakKeyDictionary()


def _render_graphed(net, cfg, state, rays_o, rays_d, auds, bg_coords, pose6, eye, bg_color,
                    noises, poses_matrix=None):
    """``render_rays(training=False)``'s frame with its fixed-shape stretches
    replayed from captured segments (``frame_graph.Segment``): the march
    segment; the compaction, which reads the sample count back; the torso
    segment, then the torso's grid encode (eagerly, on fresh points, so that
    every kernel A a frame runs is a call of ``network.grid_encode``, which
    is where the benchmark counts a frame's encodes), copied into the
    composite segment's static input; the field on exactly the valid
    samples, eager, scattering into the march segment's zeroed lattice; the
    composite segment. The card runs the torso while the host launches the
    field. The same kernels on the same samples as ``_render``, bit for bit.

    A network keeps one captured frame (``_FRAMES``), under a key of the
    render config and the shapes, dtypes and presence of the per-frame
    inputs, and the identity of the persistent tensors it reads in place
    (``_graph_identity``). The inputs' values, and the carried audio code
    with its flag, are copied into the static inputs before each replay. A
    frame whose key or identity differs from the kept one's frees it, keeps
    its own in its place and returns None (it renders eagerly); the next
    frame of the same key and identity captures, unless a profiler traces
    (None again). Keys that alternate thus stay eager and hold no graph.
    The results are copies that no later replay touches.
    """
    smooth = auds is not None and cfg.smooth_lips
    ins = {"rays_o": rays_o, "rays_d": rays_d, "auds": auds, "bg_coords": bg_coords,
           "pose6": pose6, "bg_color": bg_color, "noises": noises}
    if cfg.torso and net.torso_pose != "pose6":
        ins[net.torso_pose] = _torso_pose(net, pose6, poses_matrix)
    if smooth:
        ins.update(enc_a_smooth=state.enc_a_smooth, enc_a_initialized=state.enc_a_initialized)
    ins = {k: v for k, v in ins.items() if v is not None}
    key = (cfg, tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in ins.items()),
           None if eye is None else (tuple(eye.shape), eye.dtype))
    identity = _graph_identity(net, state)
    frame = _FRAMES.get(net)
    if frame is None or frame.key != key or frame.identity != identity:
        _FRAMES[net] = _CapturedFrame(key, identity)
        return None
    device = rays_o.device
    if frame.segments is None:
        if not can_capture(device):
            return None
        frame.capture(net, cfg, state, ins, smooth, device)
    for k, v in ins.items():
        frame.static[k].copy_(v)
    segs = frame.segments
    segs["march"].replay()
    m = segs["march"].outputs
    ind_code = net.individual_codes[0] if net.individual_codes is not None else None
    idx = compacted_index(m["valid"])
    if cfg.torso:
        with span("render.torso"):
            segs["torso"].replay()
            t = segs["torso"].outputs
            frame.static["enc_t"].copy_(net.torso_encode(t["x"], t["deform"]))
    with span("render.field"):
        field_on_lattice(net, m, rays_d, m.get("enc_a"), ind_code, eye,
                         out=(m["sigma"], m["color"], m["ambient"]), idx=idx)
    segs["composite"].replay()
    c = segs["composite"].outputs
    results = {k: m[k].clone() for k in _MARCH_RESULTS}
    results.update({k: c[k].clone() for k in _COMPOSITE_TELEMETRY})
    if cfg.torso:
        results.update({k: c[k].clone() for k in _TORSO_RESULTS})
    results.update({k: c[k].clone() for k in _COMPOSITE_RESULTS})
    if smooth:
        state = dataclasses.replace(state, enc_a_smooth=m["enc_a_smooth"].clone(),
                                    enc_a_initialized=m["enc_a_initialized"].clone())
    return results, state


# --------------------------------------------------------------------------
# grid maintenance
# --------------------------------------------------------------------------

def _grid_points(cfg: RenderConfig, device):
    """All H^3 cell coords [H^3, 3] (x-major), their Morton indices and the
    cell centres in [-1, 1] (``2 * coord / (H - 1) - 1`` in float32)."""
    H = cfg.grid_size
    lin = torch.arange(H, device=device)
    coords = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)
    # divide by a tensor: the CUDA division by a Python scalar multiplies by
    # its reciprocal, which is not the IEEE quotient the CPU and JAX take
    xyzs01 = 2.0 * coords.float() / torch.full((), H - 1.0, device=device) - 1.0
    return coords, morton3d(coords), xyzs01


@torch.no_grad()
def update_density_grid(net: NeRFNetwork, cfg: RenderConfig, state: RendererState, enc_a,
                        eye, generator: Optional[torch.Generator] = None, jitter=None,
                        decay: float = 0.95, chunk: int = 128**3 // 4) -> RendererState:
    """Head density-grid maintenance (JAX ``update_density_grid``, reference
    renderer.py:397-448): query sigma at every cell centre of every cascade,
    jittered by U(-half, half) per coordinate (half = a cell's half width),
    scatter in Morton order, dilate to the 6 neighbours, take the max with
    the decayed grid (cells at -1 stay -1), and re-derive the mean density,
    bitfield, sigma bytes and occupied box and sphere.

    The jitter comes from ``generator`` (on the state's device), or is given
    as ``jitter``: one [H^3, 3] tensor per cascade.
    """
    H = cfg.grid_size
    dev = state.density_grid.device
    _, indices, xyzs01 = _grid_points(cfg, dev)
    tmp = torch.zeros_like(state.density_grid)
    for cas in range(cfg.cascade):
        bound = min(2**cas, cfg.bound)
        half = bound / H
        cas_xyz = xyzs01 * (bound - half)
        if jitter is not None:
            noise = jitter[cas].to(dev)
        else:
            noise = torch.rand(cas_xyz.shape, generator=generator, device=dev) \
                * (2.0 * half) - half
        pts = cas_xyz + noise
        sigmas = torch.cat([net.field_density(pts[i:i + chunk], enc_a, eye)["sigma"]
                            for i in range(0, pts.shape[0], chunk)])
        tmp[cas, indices] = sigmas
    tmp = morton_dilate(tmp, H)
    valid = (state.density_grid >= 0) & (tmp >= 0)
    grid = torch.where(valid, torch.maximum(state.density_grid * decay, tmp),
                       state.density_grid)
    mean_density = torch.clamp(grid, min=0.0).mean()
    thresh = torch.clamp(mean_density, max=cfg.density_thresh)
    return dataclasses.replace(state, density_grid=grid, mean_density=mean_density,
                               **_occupancy(cfg, grid, thresh))


@torch.no_grad()
def update_torso_grid(net: NeRFNetwork, cfg: RenderConfig, state: RendererState, pose6, code,
                      generator: Optional[torch.Generator] = None, jitter=None,
                      decay: float = 0.95) -> RendererState:
    """Torso alpha-grid maintenance (JAX ``update_torso_grid``, reference
    renderer.py:451-490): query the torso's alpha at every point of an H x H
    lattice in [-1, 1] * (1 - 1/H), jittered by U(-1/H, 1/H) per coordinate,
    scatter to ``y * H + x`` (x and y transposed, as the reference), take a
    5x5 max pool (stride 1, padded with -inf), the max with the decayed grid,
    and its mean.

    pose6: [1, 6]; code: the torso code row or None. The jitter comes from
    ``generator`` (on the state's device), or is given as ``jitter`` [H^2, 2].
    """
    H = cfg.grid_size
    dev = state.density_grid_torso.device
    lin = torch.arange(H, device=dev)
    coords = torch.stack(torch.meshgrid(lin, lin, indexing="ij"), dim=-1).reshape(-1, 2)
    indices = coords[:, 1] * H + coords[:, 0]
    half = 1.0 / H
    # divide by a tensor (see _grid_points)
    xys = (2.0 * coords.float() / torch.full((), H - 1.0, device=dev) - 1.0) * (1.0 - half)
    if jitter is not None:
        noise = jitter.to(dev)
    else:
        noise = torch.rand(xys.shape, generator=generator, device=dev) * (2.0 * half) - half
    alphas = net.forward_torso(xys + noise, pose6, code)[0]
    tmp = torch.zeros_like(state.density_grid_torso)
    tmp[indices] = alphas[:, 0]
    pooled = F.max_pool2d(tmp.view(1, 1, H, H), 5, stride=1, padding=2).reshape(-1)
    grid = torch.maximum(state.density_grid_torso * decay, pooled)
    return dataclasses.replace(state, density_grid_torso=grid, mean_density_torso=grid.mean())


@torch.no_grad()
def mark_untrained_grid(cfg: RenderConfig, state: RendererState, poses, intrinsics
                        ) -> RendererState:
    """Mark the cells no training camera sees as -1 (JAX
    ``mark_untrained_grid``, reference renderer.py:318-381). poses: [B, 4, 4]
    cam2world; intrinsics: (fx, fy, cx, cy)."""
    H = cfg.grid_size
    dev = state.density_grid.device
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    poses = torch.as_tensor(poses, dtype=torch.float32).to(dev)
    _, indices, world01 = _grid_points(cfg, dev)
    count = torch.zeros_like(state.density_grid)
    for cas in range(cfg.cascade):
        bound = min(2**cas, cfg.bound)
        half = bound / H
        pts = world01 * (bound - half)
        seen = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev)
        for pose in poses:
            # world -> camera: subtract the origin, project on the c2w rows
            cam = (pts - pose[:3, 3]) @ pose[:3, :3]
            mask_z = cam[:, 2] > 0
            mask_x = torch.abs(cam[:, 0]) < cx / fx * cam[:, 2] + half * 2
            mask_y = torch.abs(cam[:, 1]) < cy / fy * cam[:, 2] + half * 2
            seen += (mask_z & mask_x & mask_y).to(torch.int32)
        count[cas, indices] += seen.to(count.dtype)
    return dataclasses.replace(
        state, density_grid=torch.where(count == 0, -1.0, state.density_grid))
