"""Plain PyTorch ops of the reference: the multiresolution grid encode, the
Morton codes, the occupancy bytes, the march, the compositor, the ray/box
slab test and the direction and frequency encodes.

Frozen copies of the plain twins in ``radnerf_tpu_torch/ops/`` at commit
2a619bf24d8171cdad65a8fd4e01bbb8c7f3f0f8 (``grid_encode.py``
``GridSpec`` / ``_corner_index`` / ``_level_corners`` /
``grid_encode_plain``, ``morton.py``, ``marching.py`` ``MarchConfig`` /
``build_sigma_bytes`` / ``march_rays_plain`` (the affine orbit at cascade
1 only) / ``composite_rays_plain``, ``ray_aabb.py``, ``sh_encode.py``
(degree 4), ``freq_encode.py``, ``activation.py``). Two departures, both
for speed on the card, neither in the arithmetic of a result:

- the table gather's gradient sums each row's terms after a sort
  (``segment_reduce``) instead of ``index_add_``, whose atomics on the rows
  that millions of points share (an untrained ambient field puts every
  point in one cell) take seconds;
- the low precision of a policy is a rounding function ``q`` passed in
  (``None``: float32), so that one copy serves the float32 path, the bf16
  policy and its fp8 control.

It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

_U32 = 1 << 32
_U32_MASK = _U32 - 1
SQRT3 = 1.7320508075688772
CULL_SAFETY = 0.5
FLT_MAX = 3.4028234663852886e38


def _f32(v: float) -> float:
    return float(np.float32(v))


# ---------------------------------------------------------------- grid encode
@dataclasses.dataclass(frozen=True)
class GridSpec:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 16
    per_level_scale: float = 2.0

    @staticmethod
    def create(input_dim, num_levels, level_dim, base_resolution, log2_hashmap_size,
               desired_resolution) -> "GridSpec":
        scale = float(np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1)))
        return GridSpec(input_dim, num_levels, level_dim, base_resolution, log2_hashmap_size,
                        scale)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @functools.cached_property
    def offsets(self) -> tuple:
        offs, offset = [], 0
        for i in range(self.num_levels):
            resolution = int(np.ceil(self.base_resolution * self.per_level_scale**i))
            n = resolution + 1
            params = int(np.ceil(min(1 << self.log2_hashmap_size, n**self.input_dim) / 8) * 8)
            offs.append(offset)
            offset += params
        offs.append(offset)
        return tuple(offs)

    @property
    def n_embeddings(self) -> int:
        return self.offsets[-1]

    def level_scale(self, level: int) -> float:
        s = np.float32(math.log2(self.per_level_scale))
        return float(np.exp2(np.float32(level) * s) * np.float32(self.base_resolution)
                     - np.float32(1.0))

    def level_size(self, level: int) -> int:
        return self.offsets[level + 1] - self.offsets[level]

    def strides(self, level: int) -> list:
        """Per-dim strides of a tiled level; a dim whose running stride
        passes the level's size stops contributing."""
        size = self.level_size(level)
        n = int(np.ceil(self.level_scale(level))) + 2
        out, stride = [], 1
        for _ in range(self.input_dim):
            out.append(stride if stride <= size else 0)
            stride = (stride * n) % _U32
        return out


def corner_rows(spec: GridSpec, level: int, corner_grid: torch.Tensor) -> torch.Tensor:
    """Flat table row of integer corner coords [..., D] (tiled grid)."""
    index = torch.zeros(corner_grid.shape[:-1], dtype=torch.int64, device=corner_grid.device)
    for d, stride in enumerate(spec.strides(level)):
        if stride:
            index = (index + corner_grid[..., d] * stride) & _U32_MASK
    return index % spec.level_size(level) + spec.offsets[level]


def level_corners(x01: torch.Tensor, spec: GridSpec, level: int):
    """[(rows, weight)] of the 2^D corners of each point's cell at a level."""
    D = spec.input_dim
    pos = x01 * spec.level_scale(level) + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pg = pos_grid.to(torch.int64)
    out = []
    for corner in range(1 << D):
        bits = [(corner >> d) & 1 for d in range(D)]
        w = None
        for d, bit in enumerate(bits):
            f = frac[..., d] if bit else (1.0 - frac[..., d])
            w = f if w is None else w * f
        cg = pg + torch.tensor(bits, dtype=torch.int64, device=x01.device)
        out.append((corner_rows(spec, level, cg), w))
    return out


class _GatherRows(torch.autograd.Function):
    """table[rows]; the gradient sums each row's terms after a sort."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.n = table.shape[0]
        return table.index_select(0, rows)

    @staticmethod
    def backward(ctx, grad):
        (rows,) = ctx.saved_tensors
        order = torch.argsort(rows)
        srows = rows[order]
        uniq, counts = torch.unique_consecutive(srows, return_counts=True)
        sums = torch.segment_reduce(grad[order].float(), "sum", lengths=counts, axis=0)
        out = torch.zeros((ctx.n, grad.shape[-1]), dtype=torch.float32, device=grad.device)
        out.index_copy_(0, uniq, sums)
        return out, None


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    flat = rows.reshape(-1)
    return _GatherRows.apply(table, flat).reshape(*rows.shape, table.shape[-1])


def grid_encode(x: torch.Tensor, table: torch.Tensor, spec: GridSpec, bound: float,
                q=None) -> torch.Tensor:
    """Points in [-bound, bound] [..., D] -> [..., L*C] float32; outside the
    box 0. With a rounding ``q`` (the policy's low precision), the table,
    each corner weight and each weighted corner are rounded by it, summed in
    float32 in corner order, and the sum rounded once (the bf16 policy's
    encode at ``q`` = bf16)."""
    x01 = (x.float() + bound) / (2.0 * bound)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    tab = table if q is None else q(table)
    outs = []
    for level in range(spec.num_levels):
        out = None
        for rows, w in level_corners(x01, spec, level):
            e = gather_rows(tab, rows)
            term = ((1.0 - oob.float()) * w)[..., None] * e if q is None \
                else q(q(w)[..., None] * e)
            out = term if out is None else out + term
        outs.append(out if q is None else q(out))
    out = torch.cat(outs, dim=-1)
    return out if q is None else torch.where(oob[..., None], 0.0, out)


# ---------------------------------------------------------------- morton codes
def _expand_bits(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def _compact_bits(x):
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    return (x | (x >> 16)) & 0x0000FFFF


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    c = coords.to(torch.int64)
    return _expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1) | (_expand_bits(c[..., 2]) << 2)


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    i = indices.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([_compact_bits(i), _compact_bits(i >> 1), _compact_bits(i >> 2)], dim=-1)


def morton_dilate(grid: torch.Tensor, H: int) -> torch.Tensor:
    """6-neighbour max over a Morton-ordered grid [C, H^3]."""
    C = grid.shape[0]
    codes = morton3d_invert(torch.arange(H**3, device=grid.device))
    dense = grid.new_empty((C, H, H, H))
    dense[:, codes[:, 0], codes[:, 1], codes[:, 2]] = grid
    out = dense.clone()
    for axis in (1, 2, 3):
        lo, hi = [slice(None)] * 4, [slice(None)] * 4
        lo[axis], hi[axis] = slice(0, H - 1), slice(1, H)
        out[tuple(lo)] = torch.maximum(out[tuple(lo)], dense[tuple(hi)])
        out[tuple(hi)] = torch.maximum(out[tuple(hi)], dense[tuple(lo)])
    return out[:, codes[:, 0], codes[:, 1], codes[:, 2]]


# ---------------------------------------------------------------- the march
@dataclasses.dataclass(frozen=True)
class MarchConfig:
    bound: float = 1.0
    grid_size: int = 128
    max_steps: int = 16
    dt_gamma: float = 1.0 / 256
    march_iters: int | None = None
    sample_slots: int | None = None

    @property
    def dt_max(self) -> float:
        return 2.0 * SQRT3 / self.grid_size

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
        return self.max_steps if self.sample_slots is None else min(self.max_steps,
                                                                      self.sample_slots)

    def check(self):
        if self.bound > 1.0 or not (self.dt_gamma == 0.0 or self.dt_min == self.dt_max):
            raise NotImplementedError("the reference marches the affine orbit at cascade 1")


def build_sigma_bytes(grid: torch.Tensor, thresh) -> torch.Tensor:
    grid = grid.reshape(-1)
    occ = grid > thresh
    q = torch.clamp(torch.floor(4.0 * torch.log2(grid.clamp_min(1e-30))) + 40.0,
                    1.0, 127.0).to(torch.uint8)
    return torch.where(occ, q | 128, torch.zeros_like(q))


def dequant_sigma(q: torch.Tensor) -> torch.Tensor:
    s = torch.exp2((q.float() - 40.0) * 0.25)
    return torch.where(q > 0, s, torch.zeros_like(s))


def _cells(xyz, cfg: MarchConfig):
    H = cfg.grid_size
    mip_bound = _f32(min(1.0, cfg.bound))
    cell = torch.clamp(torch.floor(0.5 * (xyz / mip_bound + 1.0) * H), 0.0, H - 1)
    return morton3d(cell.to(torch.int64).clamp(0, H - 1))


def march_rays(rays_o, rays_d, nears, fars, sigma_bytes, cfg: MarchConfig, t_window,
               cull_T: float, noises=None) -> dict:
    """The first S occupied points of each ray's affine orbit inside its
    window, with the transmittance-bound cull: t, dt, valid, xyz [N, S(, 3)],
    count [N]."""
    cfg.check()
    N, dev = rays_o.shape[0], rays_o.device
    S, K = cfg.n_sample_slots, cfg.n_march_iters
    t_lo, t_hi = t_window
    t_end = torch.minimum(fars, t_hi)
    dt = _f32(cfg.dt_min)
    t0 = nears
    if noises is not None:
        t0 = t0 + torch.full_like(t0, dt) * noises
    k0 = torch.floor((t_lo - t0) / torch.full_like(t0, dt))
    k0 = torch.where(k0 < 0.0, torch.zeros_like(k0), k0)
    k = k0[:, None] + torch.arange(K, dtype=torch.float32, device=dev)[None, :]
    ts = t0[:, None] + k * dt
    dts = torch.full_like(ts, dt)
    xyz = torch.clamp(rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :],
                      -cfg.bound, cfg.bound)
    byte = sigma_bytes[_cells(xyz, cfg)]
    del xyz
    occ = ((byte & 128) > 0) & (ts < t_end[:, None])
    if cull_T > 0.0:
        log_cull = _f32(-math.log(cull_T))
        est = torch.where(occ, dequant_sigma(byte & 127) * dts * CULL_SAFETY,
                          torch.zeros_like(ts))
        incl = torch.zeros_like(est[:, 0])
        keep = torch.empty(est.shape, dtype=torch.bool, device=dev)
        for j in range(K):
            incl = incl + est[:, j]
            keep[:, j] = (incl - est[:, j]) <= log_cull
        occ = occ & keep
    rank = torch.cumsum(occ.to(torch.int32), dim=1)
    slot = torch.where(occ & (rank <= S), rank - 1, torch.full_like(rank, S)).long()
    valid = torch.zeros((N, S + 1), dtype=torch.bool, device=dev)
    valid.scatter_(1, slot, torch.ones_like(occ))
    k_sel = torch.zeros((N, S + 1), dtype=torch.float32, device=dev)
    k_sel.scatter_(1, slot, k)
    valid, k_sel = valid[:, :S], k_sel[:, :S]
    t_out = t0[:, None] + k_sel * dt
    xyz_out = torch.clamp(rays_o[:, None, :] + t_out[..., None] * rays_d[:, None, :],
                          -cfg.bound, cfg.bound)
    zero = torch.zeros_like(t_out)
    return {"t": torch.where(valid, t_out, zero),
            "dt": torch.where(valid, torch.full_like(t_out, dt), zero),
            "valid": valid,
            "xyz": torch.where(valid[..., None], xyz_out, torch.zeros_like(xyz_out)),
            "count": occ.sum(dim=1, dtype=torch.int32)}


def composite_rays(sigmas, rgbs, dts, ts, valid, ambient, T_thresh: float = 1e-4) -> dict:
    """Front-to-back compositing with early stop at T_thresh, in slot order."""
    N, S = sigmas.shape
    zero = torch.zeros_like(sigmas[:, 0])
    T = torch.ones_like(zero)
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
    return {"image": image, "depth": depth, "weights_sum": weights_sum, "ambient_sum": amb}


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float):
    rd = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * rd
    t1 = (aabb[3:] - rays_o) * rd
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = near.clamp_min(min_near)
    big = torch.full_like(near, FLT_MAX)
    return torch.where(miss, big, near), torch.where(miss, big, far)


# ---------------------------------------------------------------- encodes
def sh_encode4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 values) at unit directions."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814),
           -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
           1.0925484305920792 * xy, -1.0925484305920792 * yz,
           0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
           0.54627421529603959 * x2 - 0.54627421529603959 * y2,
           0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
           0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
           0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
           0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, dim=-1)


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    parts = [x]
    for f in range(degree):
        scaled = x * (2.0**f)
        parts += [torch.sin(scaled), torch.cos(scaled)]
    return torch.cat(parts, dim=-1)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
