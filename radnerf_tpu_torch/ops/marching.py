"""Occupancy-grid ray marching and volume compositing.

Counterpart of ``radnerf_tpu/ops/marching.py``:

- ``MarchConfig``, ``build_sigma_bytes`` and ``dequant_sigma`` as there;
- ``march_rays``: the wrapper of kernel B (``csrc/march_rays.cu``), with
  the plain twin ``march_rays_plain``. It walks the orbit through the
  sigma-byte field of every cascade, with the transmittance-bound cull,
  and keeps the first S occupied points. On the affine orbit
  ``t_k = t0 + (k0 + k) * dt`` (``dt_min == dt_max``, the shipped config,
  or ``dt_gamma == 0``) it marches the per-ray ``t_window`` only; on the
  general orbit ``t_{k+1} = t_k + clamp(t_k * dt_gamma, dt_min, dt_max)``
  it walks K steps from t0 and the window only ends it (JAX's branches).
  At ``cascade > 1`` each point's level is JAX's ``_mip_level``. Training
  perturbs each ray's orbit origin with ``noises``. With a ``bitfield``
  instead of sigma bytes it is JAX's march without ``sigma_rows``: kernel
  B-bitfield, occupancy from ``occupancy_lookup`` and, with ``sigma_grid``,
  the float-grid cull on the selected samples;
- ``march_rays_grouped``: the two-level march (kernel B-grouped, twin
  ``march_rays_grouped_plain``): coarse groups of 4 steps looked up in the
  supercell bytes of ``build_coarse_bytes``, then the kept groups' fine
  steps, with the dense march's cull and selection;
- ``composite_rays``: the wrapper of kernel C (``csrc/composite_rays.cu``),
  with the plain twin ``composite_rays_plain``: front-to-back alpha
  compositing with early termination at ``T_thresh``. Its gradient is kernel
  C' (``csrc/composite_rays_backward.cu``, ``composite_rays_backward``).

The twins run their running sums and products as explicit loops over the
lattice axis in float32, in the order the kernels run them: PyTorch's CPU
``cumsum``/``cumprod`` accumulate float32 in double, which would put a
sample on the other side of the cull threshold now and then.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ._kernels import KERNELS, refuse_grad, require_cuda_tensors
from .morton import morton3d, morton3d_invert

SQRT3 = 1.7320508075688772
# kernel B holds a block's rays' [S] rows in shared memory, 21 B a slot; at
# 2,048 slots its fewest rays, four, take 172 KB of the 227 KB a block may have
MAX_SLOTS = 2048
# share of the lower-bound optical depth sigma_lo * dt the cull counts
# (kCullSafety in csrc/march_rays.cu)
CULL_SAFETY = 0.5
# the two-level march: fine steps a coarse group (JAX RendererState.
# MARCH_GROUP) and the most groups a ray's orbit may take (JAX's group-id
# bitmask is exact in float32 up to 24 bits; the port keeps its limit)
MARCH_GROUP = 4
MAX_GROUPS = 24


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static marching configuration (see ``radnerf_tpu`` ``MarchConfig``).

    ``march_iters`` (K, the orbit length) and ``sample_slots`` (S, the width
    of the emitted lattice) truncate the march and are honoured exactly.
    """

    bound: float = 1.0
    cascade: int = 1
    grid_size: int = 128
    max_steps: int = 16
    dt_gamma: float = 0.0
    march_iters: int | None = None
    sample_slots: int | None = None

    @property
    def dt_max(self) -> float:
        return 2.0 * SQRT3 * (1 << (self.cascade - 1)) / self.grid_size

    @property
    def dt_min(self) -> float:
        return min(self.dt_max, 2.0 * SQRT3 / self.max_steps)

    @property
    def n_march_iters(self) -> int:
        if self.march_iters is not None:
            return self.march_iters
        return int(math.ceil(2.0 * SQRT3 * self.bound / self.dt_min)) + 1

    @property
    def n_sample_slots(self) -> int:
        if self.sample_slots is None:
            return self.max_steps
        return min(self.max_steps, self.sample_slots)

    @property
    def affine(self) -> bool:
        return self.dt_gamma == 0.0 or self.dt_min == self.dt_max


def build_sigma_bytes(density_grid: torch.Tensor, thresh) -> torch.Tensor:
    """One byte per Morton cell: bit 7 = occupied (grid > thresh), bits 0-6 =
    clip(floor(4*log2(sigma)) + 40, 1, 127); 0 for empty cells."""
    grid = density_grid.reshape(-1)
    occ = grid > thresh
    q = torch.clamp(torch.floor(4.0 * torch.log2(grid.clamp_min(1e-30))) + 40.0,
                    1.0, 127.0).to(torch.uint8)
    return torch.where(occ, q | 128, torch.zeros_like(q))


def dequant_sigma(q: torch.Tensor) -> torch.Tensor:
    """Lower-bound dequantisation of the 7-bit code (0 -> 0)."""
    s = torch.exp2((q.float() - 40.0) * 0.25)
    return torch.where(q > 0, s, torch.zeros_like(s))


def _f32(v: float) -> float:
    """A Python float holding exactly the float32 value the JAX path uses for
    the weakly-typed constant ``v``."""
    return float(np.float32(v))


def _clamp_dt(t, cfg: MarchConfig):
    """The general orbit's step ``clip(t * dt_gamma, dt_min, dt_max)`` in
    float32 (JAX ``_clamp_dt``)."""
    return torch.clamp(t * _f32(cfg.dt_gamma), _f32(cfg.dt_min), _f32(cfg.dt_max))


def _frexp_exponent(v):
    """frexpf's exponent of float32 v > 0 from its bits (biased exponent -
    126), 0 for v <= 0 (JAX ``_mip_level``'s ``frexp_exponent``)."""
    e = ((v.view(torch.int32) >> 23) & 0xFF) - 126
    return torch.where(v > 0, e, torch.zeros_like(e))


def _cells(xyz, dts, cfg: MarchConfig):
    """Flat sigma-byte cell of each position [..., 3] with step [...]: at
    cascade 1 its Morton cell in the unit (or bound) box, else JAX's
    ``_mip_level`` level ``clip(max(e(max|x|), e(dt * H * 0.5)), 0, C - 1)``
    and the cell ``level * H^3 + morton(floor(0.5 * (x / mip_bound + 1) *
    H))``, ``mip_bound = min(2^level, bound)``."""
    H = cfg.grid_size
    if cfg.cascade == 1:
        mip_bound, level = _f32(min(1.0, cfg.bound)), None
    else:
        level = torch.maximum(_frexp_exponent(xyz.abs().amax(dim=-1)),
                              _frexp_exponent(dts * float(H) * 0.5))
        level = torch.clamp(level, 0, cfg.cascade - 1)
        mip_bound = torch.minimum(torch.exp2(level.float()),
                                  torch.full_like(dts, _f32(cfg.bound)))[..., None]
    cell = torch.clamp(torch.floor(0.5 * (xyz / mip_bound + 1.0) * H), 0.0, H - 1)
    # the int clamp only matters for NaN positions, which ts < t_end masks
    index = morton3d(cell.to(torch.int64).clamp(0, H - 1))
    return index if level is None else index + level.to(torch.int64) * H**3


def occupancy_lookup(xyz, dt, bitfield, cfg: MarchConfig):
    """Occupancy bits of points xyz [..., 3] with steps dt [...] (JAX
    ``occupancy_lookup``, and ``occupancy_lookup_wide`` on its TPU rows):
    bit ``index & 7`` of byte ``index >> 3`` of the packed ``bitfield``
    (uint8 [cascade * H^3 / 8], ``packbits``), ``index`` the cell of
    ``_cells``."""
    index = _cells(xyz, dt, cfg)
    return ((bitfield[index >> 3].long() >> (index & 7)) & 1).bool()


def build_coarse_bytes(sigma_bytes, cascade: int, grid_size: int) -> torch.Tensor:
    """The supercell byte field of the two-level march (JAX
    ``build_coarse_rows`` as bytes): one byte per 4^3 supercell (a group of
    MARCH_GROUP steps), Morton order, uint8 [cascade * (H / 4)^3]. Bit 7:
    some sigma byte of the 3x3x3 supercells around it is occupied (a box
    dilation, so a coarse step never skips an occupied fine cell); bits
    0-6: the least 7-bit code over those supercells' cells (a box erosion,
    > 0 only where every one is occupied), so ``4 * dt * sigma`` bounds the
    optical depth of a group from below. A supercell's cells are
    Morton-contiguous, so its pooling is a reshape."""
    g, H = MARCH_GROUP, grid_size
    if H % g:
        raise ValueError(f"the coarse field needs a grid that {g} divides, not {H}")
    Hc = H // g
    b = sigma_bytes.reshape(cascade, Hc**3, g**3)
    occ = (b.amax(dim=-1) >= 128).float()
    code = (b & 127).amin(dim=-1).float()
    xyz = morton3d_invert(torch.arange(Hc**3, device=sigma_bytes.device))
    flat = (xyz[:, 0] * Hc + xyz[:, 1]) * Hc + xyz[:, 2]

    def window_max(v):  # [cascade, Hc^3] Morton -> its 3x3x3 max, Morton
        dense = v.new_zeros((cascade, Hc**3))
        dense[:, flat] = v
        pooled = F.max_pool3d(dense.view(cascade, 1, Hc, Hc, Hc), 3, stride=1, padding=1)
        return pooled.reshape(cascade, -1)[:, flat]

    # max_pool3d pads with -inf: for these non-negative values the max is
    # the max with 0 padding, and the min (a max of negations) the min with
    # 127 padding, as JAX's reduce_window pads them
    dil, ero = window_max(occ), -window_max(-code)
    byte = torch.clamp(ero, 0, 127).to(torch.uint8) | 128
    return torch.where(dil > 0, byte, torch.zeros_like(byte)).reshape(-1)


def _affine_start(nears, t_lo, cfg: MarchConfig, noises):
    """The affine orbit's origin t0 (moved by ``dt * noises``) and the
    window's first step k0 = max(floor((t_lo - t0) / dt), 0), NaN kept."""
    dt = _f32(cfg.dt_min)
    t0 = nears
    if noises is not None:
        # on the affine orbit the clamped step _clamp_dt(nears) is exactly dt
        t0 = t0 + torch.full_like(t0, dt) * noises
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    k0 = torch.floor((t_lo - t0) / torch.full_like(t0, dt))
    return t0, torch.where(k0 < 0.0, torch.zeros_like(k0), k0)


def _running_keep(est, log_cull: float):
    """keep[:, j] = (sum_{i <= j} est[:, i]) - est[:, j] <= log_cull: the
    JAX path's ``cumsum(est) - est``, the running sum float32 in column
    order."""
    incl = torch.zeros_like(est[:, 0])
    keep = torch.empty(est.shape, dtype=torch.bool, device=est.device)
    for j in range(est.shape[1]):
        incl = incl + est[:, j]
        keep[:, j] = (incl - est[:, j]) <= log_cull
    return keep


def _select_first(occ, ts, dts, S: int):
    """The first S occupied lattice points of each row into slots 0..S-1
    (the rest go to column S, which is dropped): (t, dt, valid) [N, S]."""
    N, dev = occ.shape[0], occ.device
    rank = torch.cumsum(occ.to(torch.int32), dim=1)
    slot = torch.where(occ & (rank <= S), rank - 1, torch.full_like(rank, S)).long()
    valid = torch.zeros((N, S + 1), dtype=torch.bool, device=dev)
    valid.scatter_(1, slot, torch.ones_like(occ))
    t_out = torch.zeros((N, S + 1), dtype=torch.float32, device=dev)
    dt_out = torch.zeros_like(t_out)
    t_out.scatter_(1, slot, ts)
    dt_out.scatter_(1, slot, dts)
    return t_out[:, :S], dt_out[:, :S], valid[:, :S]


def _lattice_out(rays_o, rays_d, t_out, dt_out, valid, cfg: MarchConfig):
    xyz_out = torch.clamp(rays_o[:, None, :] + t_out[..., None] * rays_d[:, None, :],
                          -cfg.bound, cfg.bound)
    zero = torch.zeros_like(t_out)
    return {
        "t": torch.where(valid, t_out, zero),
        "dt": torch.where(valid, dt_out, zero),
        "valid": valid,
        "xyz": torch.where(valid[..., None], xyz_out, torch.zeros_like(xyz_out)),
    }


def march_rays_plain(rays_o, rays_d, nears, fars, sigma_bytes, cfg: MarchConfig,
                     t_window=None, cull_T: float = 0.0, noises=None, bitfield=None,
                     sigma_grid=None):
    """Plain PyTorch marcher; the arguments and results of ``march_rays``."""
    _check_march_source(sigma_bytes, bitfield, sigma_grid)
    N, dev = rays_o.shape[0], rays_o.device
    S, K = cfg.n_sample_slots, cfg.n_march_iters
    t_lo, t_hi = (nears, fars) if t_window is None else t_window
    t_end = torch.minimum(fars, t_hi)
    if cfg.affine:
        dt = _f32(cfg.dt_min)
        t0, k0 = _affine_start(nears, t_lo, cfg, noises)
        k = k0[:, None] + torch.arange(K, dtype=torch.float32, device=dev)[None, :]
        ts = t0[:, None] + k * dt  # [N, K]
        dts = torch.full_like(ts, dt)
    else:
        t0 = nears
        if noises is not None:
            t0 = t0 + _clamp_dt(t0, cfg) * noises
        # the recurrence, K steps from t0, each op rounded in float32
        ts = torch.empty((N, K), dtype=torch.float32, device=dev)
        dts = torch.empty_like(ts)
        t = t0
        for j in range(K):
            ts[:, j] = t
            dts[:, j] = _clamp_dt(t, cfg)
            t = t + dts[:, j]
    xyz = torch.clamp(rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :],
                      -cfg.bound, cfg.bound)
    log_cull = _f32(-math.log(cull_T)) if cull_T > 0.0 else None
    if bitfield is not None:
        occ = occupancy_lookup(xyz, dts, bitfield, cfg) & (ts < t_end[:, None])
    else:
        byte = sigma_bytes[_cells(xyz, dts, cfg)]
        occ = ((byte & 128) > 0) & (ts < t_end[:, None])
        if log_cull is not None:
            est = torch.where(occ, dequant_sigma(byte & 127) * dts * CULL_SAFETY,
                              torch.zeros_like(ts))
            occ = occ & _running_keep(est, log_cull)

    if cfg.affine:
        # t is affine in the orbit index: select k, then t = t0 + k * dt
        k_sel, _, valid = _select_first(occ, k, dts, S)
        t_out = t0[:, None] + k_sel * dt
        dt_out = torch.full_like(t_out, dt)
    else:
        t_out, dt_out, valid = _select_first(occ, ts, dts, S)
    out = _lattice_out(rays_o, rays_d, t_out, dt_out, valid, cfg)
    if bitfield is not None and sigma_grid is not None and log_cull is not None:
        # the float-grid cull on the selected samples (JAX marching.py:490-509):
        # each one's cell from its own position and step, sigma_hat =
        # max(grid, 0) * 0.25, own = sigma_hat * dt, in slot order
        cell = _cells(out["xyz"], out["dt"], cfg)
        own = torch.clamp(sigma_grid.reshape(-1)[cell], min=0.0) * 0.25 * out["dt"]
        out = _lattice_out(rays_o, rays_d, t_out, dt_out,
                           valid & _running_keep(own, log_cull), cfg)
    out["count"] = occ.sum(dim=1, dtype=torch.int32)
    return out


def _check_march_source(sigma_bytes, bitfield, sigma_grid):
    if (sigma_bytes is None) == (bitfield is None):
        raise ValueError("the march takes sigma bytes or a bitfield, exactly one")
    if sigma_grid is not None and bitfield is None:
        raise ValueError("the float-grid cull (sigma_grid) runs on the bitfield march only")


def march_rays(rays_o, rays_d, nears, fars, sigma_bytes, cfg: MarchConfig,
               t_window=None, cull_T: float = 0.0, noises=None, bitfield=None,
               sigma_grid=None):
    """Fixed-lattice marcher: kernel B on CUDA tensors (B-bitfield with
    ``bitfield``), the plain twin on CPU tensors.

    Args:
      rays_o, rays_d: [N, 3] float32 (unit directions).
      nears, fars: [N] from ``near_far_from_aabb``.
      sigma_bytes: uint8 [cascade * H^3] from ``build_sigma_bytes`` (Morton
        order, cascade-major), or None with ``bitfield``.
      t_window: ([N] t_lo, [N] t_hi): march only this interval (the
        renderer's ``march_window``); the orbit origin stays at ``nears`` so
        samples stay on the lattice. On the general orbit the march starts
        at the origin and only t_hi ends it, as in JAX. None is (nears,
        fars).
      cull_T: with sigma bytes, drop occupied points once the running
        optical-depth bound ``sum(CULL_SAFETY * sigma_lo * dt)`` before
        them exceeds ``-ln(cull_T)``; with a bitfield and ``sigma_grid``,
        the float-grid cull below (0 disables either).
      noises: optional [N] float32 in [0, 1): the orbit origin moves to
        ``nears + clamp(nears * dt_gamma, dt_min, dt_max) * noises``
        (training's perturbation; ``dt`` on the affine orbit); the window's
        first step is taken from the moved origin.
      bitfield: uint8 [cascade * H^3 / 8] (``packbits``) instead of sigma
        bytes: JAX's march without ``sigma_rows``, occupancy from its bits
        and no cull in the walk.
      sigma_grid: float32 [cascade * H^3] density grid (Morton order; the
        state's ``density_grid``), with a bitfield only: after the first-S
        selection a sample is dropped once the running sum, in slot order,
        of ``max(grid[cell], 0) * 0.25 * dt`` over the samples before it
        exceeds ``-ln(cull_T)``, its cell taken from its own position and
        step (JAX ``marching.py:490-509``).

    Returns dict: t, dt [N, S] (0 where invalid), valid [N, S] bool,
      xyz [N, S, 3] (0 where invalid), count [N] int32 occupied points per
      ray before the S truncation and the float-grid cull (its max is the
      ``max_count`` telemetry).
    """
    if rays_o.device.type == "cpu":
        return march_rays_plain(rays_o, rays_d, nears, fars, sigma_bytes, cfg,
                                t_window, cull_T, noises, bitfield, sigma_grid)
    _check_march_source(sigma_bytes, bitfield, sigma_grid)
    N, S, K, H = rays_o.shape[0], cfg.n_sample_slots, cfg.n_march_iters, cfg.grid_size
    if S > MAX_SLOTS:
        raise ValueError(f"kernel B takes at most {MAX_SLOTS} sample slots, not {S}")
    t_lo, t_hi = (nears, fars) if t_window is None else t_window
    refuse_grad("kernel B", rays_o=rays_o, rays_d=rays_d)
    ins = _march_inputs(rays_o, rays_d, nears, fars, t_lo, t_hi, noises)
    cells = cfg.cascade * H**3
    if bitfield is not None:
        name, field = "march_rays_bitfield", bitfield
        ok = bitfield.dtype == torch.uint8 and bitfield.numel() * 8 == cells
        use_cull = cull_T > 0.0 and sigma_grid is not None
        if sigma_grid is not None:
            sigma_grid = sigma_grid.reshape(-1).contiguous()
            ok = ok and sigma_grid.dtype == torch.float32 and sigma_grid.numel() == cells
    else:
        name, field = "march_rays", sigma_bytes
        ok = sigma_bytes.dtype == torch.uint8 and sigma_bytes.numel() == cells
        use_cull = cull_T > 0.0
    if not ok:
        raise ValueError("kernel B takes uint8 [cascade * H^3] sigma bytes, or a uint8 "
                         "[cascade * H^3 / 8] bitfield and float32 [cascade * H^3] grid")
    require_cuda_tensors(*ins, field, *([] if sigma_grid is None else [sigma_grid]))
    t, dt, valid, xyz, count = _march_outputs(N, S, rays_o.device)
    if N > 0:
        ptrs = [v.data_ptr() for v in ins[:6]] + [ins[6].data_ptr() if noises is not None
                                                   else None]
        KERNELS[name].launch(
            "march_rays_fwd", rays_o.device, *ptrs,
            sigma_bytes.data_ptr() if bitfield is None else None,
            None if bitfield is None else bitfield.data_ptr(),
            None if sigma_grid is None else sigma_grid.data_ptr(),
            t.data_ptr(), dt.data_ptr(), valid.data_ptr(), xyz.data_ptr(), count.data_ptr(),
            N, K, S, H, cfg.cascade, _f32(cfg.bound), _f32(cfg.dt_gamma), _f32(cfg.dt_min),
            _f32(cfg.dt_max), int(cfg.affine), int(use_cull),
            _f32(-math.log(cull_T)) if use_cull else 0.0)
    return {"t": t, "dt": dt, "valid": valid, "xyz": xyz, "count": count}


def _march_inputs(rays_o, rays_d, nears, fars, t_lo, t_hi, noises):
    """The march's float32 inputs, contiguous, checked for shape."""
    N = rays_o.shape[0]
    ins = [v.contiguous() for v in (rays_o, rays_d, nears, fars, t_lo, t_hi)]
    if noises is not None:
        ins.append(noises.contiguous())
    shapes = [(N, 3), (N, 3)] + [(N,)] * (len(ins) - 2)
    if any(v.dtype != torch.float32 or v.shape != shape for v, shape in zip(ins, shapes)):
        raise ValueError("kernel B takes float32 rays [N, 3], intervals and noises [N]")
    return ins


def _march_outputs(N, S, dev):
    t = torch.empty((N, S), dtype=torch.float32, device=dev)
    return (t, torch.empty_like(t), torch.empty((N, S), dtype=torch.bool, device=dev),
            torch.empty((N, S, 3), dtype=torch.float32, device=dev),
            torch.empty((N,), dtype=torch.int32, device=dev))


def grouped_march_qualifies(cfg: MarchConfig, group: int = MARCH_GROUP) -> bool:
    """Whether the two-level march takes ``cfg`` (JAX ``run_head``'s rule):
    the affine orbit, cascade 1 and ceil(K / group) <= MAX_GROUPS."""
    return (cfg.cascade == 1 and cfg.affine
            and -(-cfg.n_march_iters // group) <= MAX_GROUPS)


def _check_grouped(cfg: MarchConfig):
    if not grouped_march_qualifies(cfg):
        raise ValueError(
            "the two-level march takes the affine orbit at cascade 1 with ceil(K / "
            f"{MARCH_GROUP}) <= {MAX_GROUPS} groups (JAX march_rays_grouped's asserts); "
            f"got cascade {cfg.cascade}, affine {cfg.affine}, K {cfg.n_march_iters}")


def _grouped_plan(rays_o, rays_d, nears, fars, coarse_bytes, cfg: MarchConfig, t_window,
                  group_slots, cull_T, noises):
    """The coarse pass of the two-level march: each ray's Kg = ceil(K / 4)
    groups from its window's first step, the group centre ``t0 + (k0 + 4 j
    + 1.5) * dt`` looked up in the coarse bytes at grid H / 4, kept where
    occupied, started inside the window, and (with the cull) while the
    float32 running sum of ``sigma_c * f32(4 dt) * 0.5`` before it stays
    within ``-ln(cull_T)``. Returns a dict of t0, k0, t_end [N], the kept
    groups ``kept`` [N, Kg], the ones fine-marched (the first
    ``group_slots`` kept of each ray) ``marched`` [N, Kg] and the walked
    groups' coarse cells ``cells_c`` (for a work count)."""
    _check_grouped(cfg)
    g, K, dev = MARCH_GROUP, cfg.n_march_iters, rays_o.device
    Kg = -(-K // g)
    dt = _f32(cfg.dt_min)
    t_lo, t_hi = t_window
    t0, k0 = _affine_start(nears, t_lo, cfg, noises)
    t_end = torch.minimum(fars, t_hi)
    k_base = k0[:, None] + (torch.arange(Kg, dtype=torch.float32, device=dev) * g)[None, :]
    t_start = t0[:, None] + k_base * dt
    tc = t0[:, None] + (k_base + (g - 1) * 0.5) * dt
    xyz_c = torch.clamp(rays_o[:, None, :] + tc[..., None] * rays_d[:, None, :],
                        -cfg.bound, cfg.bound)
    cfg_c = dataclasses.replace(cfg, grid_size=cfg.grid_size // g)
    walked = t_start < t_end[:, None]
    dt_g = _f32(g * cfg.dt_min)  # one rounding of the double product, as JAX's
    cells_c = _cells(xyz_c, torch.full_like(tc, dt_g), cfg_c)
    byte_c = coarse_bytes[cells_c]
    kept = ((byte_c & 128) > 0) & walked
    if cull_T > 0.0:
        est = torch.where(kept, dequant_sigma(byte_c & 127) * dt_g * CULL_SAFETY,
                          torch.zeros_like(tc))
        kept = kept & _running_keep(est, _f32(-math.log(cull_T)))
    slots = Kg if group_slots is None else group_slots
    marched = kept & (torch.cumsum(kept.to(torch.int32), dim=1) <= slots)
    return {"t0": t0, "k0": k0, "t_end": t_end, "kept": kept, "marched": marched,
            "cells_c": cells_c[walked]}


def _grouped_fine(rays_o, rays_d, sigma_bytes, cfg: MarchConfig, plan):
    """The fine lattice of the two-level march: every group's 4 steps
    [N, Kg * 4] in orbit order, k = (k0 + 4 gid) + i as JAX's fine pass
    forms it; ``looked`` marks the steps the kernel looks up (in a marched
    group, before K and the window's end), ``occ`` those occupied."""
    g, K = MARCH_GROUP, cfg.n_march_iters
    dt = _f32(cfg.dt_min)
    Kg = plan["kept"].shape[1]
    k_rel = torch.arange(Kg * g, device=rays_o.device)
    k = (plan["k0"][:, None] + (k_rel // g * g).float()[None, :]) + (k_rel % g).float()[None, :]
    ts = plan["t0"][:, None] + k * dt
    xyz = torch.clamp(rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :],
                      -cfg.bound, cfg.bound)
    dts = torch.full_like(ts, dt)
    cells = _cells(xyz, dts, cfg)
    looked = plan["marched"].repeat_interleave(g, dim=1) & (k_rel < K)[None, :] \
        & (ts < plan["t_end"][:, None])
    byte = sigma_bytes[cells]
    return {"k": k, "dts": dts, "cells": cells, "byte": byte, "looked": looked,
            "occ": looked & ((byte & 128) > 0)}


def march_rays_grouped_plain(rays_o, rays_d, nears, fars, sigma_bytes, coarse_bytes,
                             cfg: MarchConfig, t_window, group_slots=None,
                             cull_T: float = 0.0, noises=None):
    """Plain PyTorch two-level marcher; the arguments and results of
    ``march_rays_grouped``. The fine steps of every group are laid out
    [N, Kg * 4] in orbit order; steps outside the fine-marched groups are
    unoccupied and add an exact 0 to the cull's running sum."""
    plan = _grouped_plan(rays_o, rays_d, nears, fars, coarse_bytes, cfg, t_window,
                         group_slots, cull_T, noises)
    fine = _grouped_fine(rays_o, rays_d, sigma_bytes, cfg, plan)
    occ, dts = fine["occ"], fine["dts"]
    if cull_T > 0.0:
        est = torch.where(occ, dequant_sigma(fine["byte"] & 127) * dts * CULL_SAFETY,
                          torch.zeros_like(dts))
        occ = occ & _running_keep(est, _f32(-math.log(cull_T)))
    k_sel, _, valid = _select_first(occ, fine["k"], dts, cfg.n_sample_slots)
    dt = _f32(cfg.dt_min)
    out = _lattice_out(rays_o, rays_d, plan["t0"][:, None] + k_sel * dt,
                       torch.full_like(k_sel, dt), valid, cfg)
    out["count"] = occ.sum(dim=1, dtype=torch.int32)
    out["groups"] = plan["kept"].sum(dim=1, dtype=torch.int32)
    return out


def march_rays_grouped(rays_o, rays_d, nears, fars, sigma_bytes, coarse_bytes,
                       cfg: MarchConfig, t_window, group_slots=None, cull_T: float = 0.0,
                       noises=None):
    """The two-level march (JAX ``march_rays_grouped``): kernel B-grouped on
    CUDA tensors, the plain twin on CPU tensors.

    A coarse pass looks up each group of 4 orbit steps at its centre in the
    supercell bytes (``build_coarse_bytes``) and keeps the occupied ones
    (with the cull, while the coarse optical-depth bound allows); the fine
    pass marches the kept groups' steps through the sigma bytes with the
    dense march's cull and first-S selection. With every kept group marched
    the result is ``march_rays``' on the same sigma bytes: the dilated
    coarse bit never skips an occupied fine cell and the eroded code's
    bound never exceeds the fine one. Takes the affine orbit at cascade 1
    with ceil(K / 4) <= 24 groups and a window (``ValueError`` otherwise,
    where JAX asserts). JAX's kept-group buffer (``group_capacity``) has no
    counterpart: the port drops no group but past ``group_slots``.

    Args: those of ``march_rays`` with the sigma bytes, and
      coarse_bytes: uint8 [(H / 4)^3] from ``build_coarse_bytes``.
      group_slots: fine-march only each ray's first ``group_slots`` kept
        groups (None: all).

    Returns dict: t, dt, valid, xyz, count as ``march_rays`` (count after
      the fine cull, within the marched groups), and groups [N] int32 kept
      groups per ray before the ``group_slots`` truncation (the telemetry
      ``n_groups_needed`` is their sum, ``n_group_max`` their max).
    """
    if rays_o.device.type == "cpu":
        return march_rays_grouped_plain(rays_o, rays_d, nears, fars, sigma_bytes,
                                        coarse_bytes, cfg, t_window, group_slots, cull_T,
                                        noises)
    _check_grouped(cfg)
    N, S, K, H = rays_o.shape[0], cfg.n_sample_slots, cfg.n_march_iters, cfg.grid_size
    if S > MAX_SLOTS:
        raise ValueError(f"kernel B-grouped takes at most {MAX_SLOTS} sample slots, not {S}")
    refuse_grad("kernel B-grouped", rays_o=rays_o, rays_d=rays_d)
    ins = _march_inputs(rays_o, rays_d, nears, fars, *t_window, noises)
    Hc = H // MARCH_GROUP
    if sigma_bytes.dtype != torch.uint8 or sigma_bytes.numel() != H**3 \
            or coarse_bytes.dtype != torch.uint8 or coarse_bytes.numel() != Hc**3:
        raise ValueError("kernel B-grouped takes uint8 [H^3] sigma bytes and [(H/4)^3] "
                         "coarse bytes")
    require_cuda_tensors(*ins, sigma_bytes, coarse_bytes)
    t, dt, valid, xyz, count = _march_outputs(N, S, rays_o.device)
    groups = torch.empty_like(count)
    slots = -(-K // MARCH_GROUP) if group_slots is None else max(int(group_slots), 0)
    if N > 0:
        use_cull = cull_T > 0.0
        KERNELS["march_rays_grouped"].launch(
            "march_rays_grouped_fwd", rays_o.device, *[v.data_ptr() for v in ins[:6]],
            ins[6].data_ptr() if noises is not None else None, sigma_bytes.data_ptr(),
            coarse_bytes.data_ptr(), t.data_ptr(), dt.data_ptr(), valid.data_ptr(),
            xyz.data_ptr(), count.data_ptr(), groups.data_ptr(), N, K, S, H, slots,
            _f32(cfg.bound), _f32(cfg.dt_min), _f32(MARCH_GROUP * cfg.dt_min), int(use_cull),
            _f32(-math.log(cull_T)) if use_cull else 0.0)
    return {"t": t, "dt": dt, "valid": valid, "xyz": xyz, "count": count, "groups": groups}


def composite_rays_plain(sigmas, rgbs, dts, ts, valid, ambient,
                         T_thresh: float = 1e-4):
    """Plain PyTorch compositor; the arguments and results of
    ``composite_rays``."""
    N, S = sigmas.shape
    zero = torch.zeros_like(sigmas[:, 0])
    T = torch.ones_like(zero)  # transmittance before the step
    processed = torch.ones_like(valid[:, 0])
    weights_sum, depth, amb = zero, zero, zero
    image = torch.zeros_like(rgbs[:, 0])
    for s in range(S):
        sig = torch.where(valid[:, s], sigmas[:, s], zero)
        alpha = 1.0 - torch.exp(-sig * dts[:, s])
        w = torch.where(processed, alpha * T, zero)
        weights_sum = weights_sum + w
        depth = depth + w * (ts[:, s] + dts[:, s])
        image = image + w[:, None] * rgbs[:, s]
        amb = amb + torch.where(processed & valid[:, s], ambient[:, s], zero)
        T = T * (1.0 - alpha)
        processed = processed & (T >= _f32(T_thresh))
    return {"image": image, "depth": depth, "weights_sum": weights_sum,
            "ambient_sum": amb}


def _composite_kernel(sigmas, rgbs, dts, ts, valid, ambient, T_thresh):
    """Kernel C on checked, contiguous CUDA inputs."""
    N, S = sigmas.shape
    dev = sigmas.device
    image = torch.empty((N, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    weights_sum = torch.empty_like(depth)
    ambient_sum = torch.empty_like(depth)
    if N > 0:
        KERNELS["composite_rays"].launch(
            "composite_rays_fwd", dev, sigmas.data_ptr(), rgbs.data_ptr(), dts.data_ptr(),
            ts.data_ptr(), valid.data_ptr(), ambient.data_ptr(),
            image.data_ptr(), depth.data_ptr(), weights_sum.data_ptr(),
            ambient_sum.data_ptr(), N, S, _f32(T_thresh))
    return image, depth, weights_sum, ambient_sum


def _aligned(v):
    """v contiguous and starting 16-byte aligned, as kernels C and C' take
    their arrays: a view that does not is copied."""
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _check_composite(sigmas, rgbs, dts, ts, valid, ambient):
    N, S = sigmas.shape
    ins = [sigmas, rgbs, dts, ts, ambient]
    shapes = [(N, S), (N, S, 3), (N, S), (N, S), (N, S)]
    if any(v.dtype != torch.float32 or v.shape != shape
           for v, shape in zip(ins, shapes)) \
            or valid.dtype != torch.bool or valid.shape != (N, S):
        raise ValueError("kernel C takes float32 [N, S] samples, [N, S, 3] rgbs "
                         "and a bool mask")
    ins = [_aligned(v) for v in (*ins, valid)]
    require_cuda_tensors(*ins)
    return ins


def composite_rays_backward_plain(sigmas, rgbs, dts, ts, valid, ambient, grads,
                                  T_thresh: float = 1e-4):
    """Plain version of ``composite_rays_backward``: autograd through
    ``composite_rays_plain``."""
    sig, rgb, amb = (v.detach().requires_grad_(True) for v in (sigmas, rgbs, ambient))
    with torch.enable_grad():
        out = composite_rays_plain(sig, rgb, dts, ts, valid, amb, T_thresh)
        keys = ("image", "depth", "weights_sum", "ambient_sum")
        return torch.autograd.grad([out[k] for k in keys], [sig, rgb, amb],
                                   [grads[k] for k in keys])


def composite_rays_backward(sigmas, rgbs, dts, ts, valid, ambient, grads, outputs,
                            T_thresh: float = 1e-4):
    """Gradients of ``composite_rays`` (the semantics of JAX's autodiff of
    ``composite_rays``): ``grads`` holds d image [N, 3], d depth, d
    weights_sum and d ambient_sum [N]; ``outputs`` the forward's image,
    depth and weights_sum. Returns (d sigmas [N, S], d rgbs [N, S, 3],
    d ambient [N, S]); the processed mask carries no gradient and invalid
    steps get zero. Kernel C' on CUDA tensors, the plain version (which does
    not read ``outputs``) on CPU tensors."""
    if sigmas.device.type == "cpu":
        return composite_rays_backward_plain(sigmas, rgbs, dts, ts, valid, ambient, grads,
                                             T_thresh)
    sig, rgb, dt, t, _, ok = _check_composite(sigmas, rgbs, dts, ts, valid, ambient)
    N, S = sig.shape
    keys = ("image", "depth", "weights_sum", "ambient_sum")
    g = [_aligned(grads[k]) for k in keys]
    o = [_aligned(outputs[k]) for k in keys[:3]]
    want = [(N, 3), (N,), (N,), (N,), (N, 3), (N,), (N,)]
    if any(v.dtype != torch.float32 or v.shape != w for v, w in zip(g + o, want)):
        raise ValueError("kernel C' takes float32 image [N, 3] and [N] gradients "
                         "and outputs")
    require_cuda_tensors(sig, *g, *o)
    g_sig = torch.empty_like(sig)
    g_rgb = torch.empty_like(rgb)
    g_amb = torch.empty_like(sig)
    if N > 0:
        KERNELS["composite_rays_backward"].launch(
            "composite_rays_bwd", sig.device, sig.data_ptr(), rgb.data_ptr(), dt.data_ptr(),
            t.data_ptr(), ok.data_ptr(), *[v.data_ptr() for v in o],
            *[v.data_ptr() for v in g], g_sig.data_ptr(), g_rgb.data_ptr(),
            g_amb.data_ptr(), N, S, _f32(T_thresh))
    return g_sig, g_rgb, g_amb


class _CompositeRays(torch.autograd.Function):
    """Kernel C forward, kernel C' backward."""

    @staticmethod
    def forward(ctx, sigmas, rgbs, dts, ts, valid, ambient, T_thresh):
        outs = _composite_kernel(sigmas, rgbs, dts, ts, valid, ambient, T_thresh)
        ctx.save_for_backward(sigmas, rgbs, dts, ts, valid, ambient, *outs[:3])
        ctx.T_thresh = T_thresh
        return outs

    @staticmethod
    def backward(ctx, g_image, g_depth, g_ws, g_amb):
        sigmas, rgbs, dts, ts, valid, ambient, image, depth, ws = ctx.saved_tensors
        grads = {"image": g_image, "depth": g_depth, "weights_sum": g_ws,
                 "ambient_sum": g_amb}
        grads = {k: torch.zeros_like(v) if grads[k] is None else grads[k]
                 for k, v in (("image", image), ("depth", depth),
                              ("weights_sum", ws), ("ambient_sum", ws))}
        g_sig, g_rgb, g_a = composite_rays_backward(
            sigmas, rgbs, dts, ts, valid, ambient, grads,
            {"image": image, "depth": depth, "weights_sum": ws}, ctx.T_thresh)
        need = ctx.needs_input_grad
        return (g_sig if need[0] else None, g_rgb if need[1] else None, None, None, None,
                g_a if need[5] else None, None)


def composite_rays(sigmas, rgbs, dts, ts, valid, ambient,
                   T_thresh: float = 1e-4):
    """Front-to-back compositing of a [N, S] sample lattice: kernel C on CUDA
    tensors, the plain twin on CPU tensors.

    ``alpha = 1 - exp(-sigma*dt)``, ``w = alpha * T`` with T the
    transmittance before the step; a step is processed iff it is the first
    or T after the previous step is >= T_thresh (the crossing step is
    included). depth accumulates ``w * (t + dt)``; ``ambient_sum`` is the
    unweighted sum of ``ambient`` over processed valid steps. Invalid steps
    contribute nothing.

    On CUDA tensors, when autograd wants a gradient for sigmas, rgbs or
    ambient, the call goes through a ``torch.autograd.Function`` whose
    backward is kernel C'; dts and ts take no gradient (a request raises).

    Returns dict: image [N, 3] (premultiplied, no background), depth [N],
      weights_sum [N], ambient_sum [N].
    """
    if sigmas.device.type == "cpu":
        return composite_rays_plain(sigmas, rgbs, dts, ts, valid, ambient, T_thresh)
    args = _check_composite(sigmas, rgbs, dts, ts, valid, ambient)
    refuse_grad("kernel C", dts=dts, ts=ts)
    sig, rgb, dt, t, amb, ok = args
    if torch.is_grad_enabled() and any(v.requires_grad for v in (sig, rgb, amb)):
        outs = _CompositeRays.apply(sig, rgb, dt, t, ok, amb, T_thresh)
    else:
        outs = _composite_kernel(sig, rgb, dt, t, ok, amb, T_thresh)
    return dict(zip(("image", "depth", "weights_sum", "ambient_sum"), outs))
