"""Multiresolution tiled grid encoding (Instant-NGP style).

Counterpart of ``radnerf_tpu/ops/grid_encode.py``. ``GridSpec`` carries the
same level geometry (offsets, the fp32 ``level_scale`` chain, resolutions).
``grid_encode`` is the wrapper of kernel A (``csrc/grid_encode.cu``): on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain twin
``grid_encode_plain``, which follows ``grid_encode01``'s per-corner
arithmetic in the same order. Its gradient on the card is kernel A'
(``csrc/grid_encode_backward.cu``, ``grid_encode_backward``); on the CPU
autograd runs through the twin's plain ops.

Under the bf16 policy (``-O``, ``table_dtype=torch.bfloat16``) the encode
follows ``build_packed_table(dtype=bfloat16)`` + ``grid_encode01_packed``:
the table's values are rounded to bf16, each corner weight comes from the
float32 position and is rounded to bf16, each weight x corner product is
rounded to bf16, the products are summed in float32 in corner order and
the sum is rounded to bf16 once; a point outside the box encodes to 0. That
is where XLA:CPU rounds when JAX runs the function op by op (``jnp.sum``
upcasts bf16 to float32); under ``jit`` XLA keeps the products in float32,
which moves a third of the outputs by one bf16 ulp. Kernel A's bf16 variant
(``grid_encode_fwd_bf16_packed``, its own launch count ``grid_encode_bf16``)
and the plain twin ``grid_encode_plain(..., table_dtype=torch.bfloat16)``
round at the same places. The bf16 kernel reads a corner-packed copy of
the table (``pack_table``: kernel ``grid_pack_bf16``, plain version
``pack_table_plain``), ``build_packed_table(dtype=bfloat16)``'s rows: each
cell's 2^D corner rows side by side, corner-major. A train step's encode
packs its freshly cast table; the network keeps the packed copy of a table
that does not change (``NeRFNetwork.packed_copy``). The gradient (kernel
A'-bf16, ``grid_encode_bwd_bf16_keyed``; twin ``grid_encode_backward_plain``)
takes the bf16 upstream gradient and
returns float32 gradients: the table's summed with float32 atomics (JAX
scatter-adds bf16 products into a bf16 table, which the port deliberately
does not: its sum is the more exact one), x's through the bf16 weights as
if their rounding were the identity (autodiff's view of a cast).

Every ``GridSpec`` the JAX package takes is encoded: tiled and hash grids
(a level whose dense index overflows its table hashes its corners, the
XOR of ``coord_d * prime_d`` in uint32), linear and smoothstep
interpolation, ``align_corners``, any ``input_dim``, ``num_levels`` and
``level_dim``, and so do kernels A and A' on every grid, and the bf16
kernels (and the packing pass) on tiled grids: RAD-NeRF's grids (D in
(2, 3), at most 32 levels of at most 16 channels) through the specialised
kernels, every other through the kernels' general path
(``csrc/grid_common.cuh``). A hash grid has no packed copy (its index is
not additive; JAX's ``build_packed_table`` refuses it too), so the bf16
kernels refuse it; the plain versions take it. A hashed level at D > 7 has
no prime (JAX's ``_PRIMES`` has seven): JAX, the plain versions and the
kernels' wrappers refuse it.
``grid_total_variation`` is the JAX package's TV loss at sampled points.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from ._kernels import KERNELS, require_cuda_tensors

_U32 = 1 << 32
_U32_MASK = _U32 - 1
# the spatial hash's primes, one per dim (reference gridencoder.cu:50-63)
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of one multiresolution grid encoder."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 16
    per_level_scale: float = 2.0
    gridtype: str = "tiled"
    interpolation: str = "linear"
    align_corners: bool = False

    @staticmethod
    def create(input_dim: int = 3, num_levels: int = 16, level_dim: int = 2,
               base_resolution: int = 16, log2_hashmap_size: int = 16,
               desired_resolution: float | None = None,
               per_level_scale: float = 2.0, gridtype: str = "tiled",
               interpolation: str = "linear",
               align_corners: bool = False) -> "GridSpec":
        # desired_resolution overrides per_level_scale (reference grid.py:101-102)
        if desired_resolution is not None:
            per_level_scale = float(np.exp2(
                np.log2(desired_resolution / base_resolution) / (num_levels - 1)))
        return GridSpec(input_dim, num_levels, level_dim, base_resolution,
                        log2_hashmap_size, per_level_scale, gridtype,
                        interpolation, align_corners)

    @property
    def max_params(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @functools.cached_property
    def offsets(self) -> tuple:
        """Per-level start rows in the flat table, plus the total (computed
        once per spec: every kernel launch reads it)."""
        offs, offset = [], 0
        for i in range(self.num_levels):
            resolution = int(np.ceil(self.base_resolution * self.per_level_scale**i))
            n = resolution if self.align_corners else resolution + 1
            params_in_level = int(np.ceil(min(self.max_params, n**self.input_dim) / 8) * 8)
            offs.append(offset)
            offset += params_in_level
        offs.append(offset)
        return tuple(offs)

    @property
    def n_embeddings(self) -> int:
        return self.offsets[-1]

    def level_scale(self, level: int) -> float:
        """Runtime scale ``exp2f(level*S)*H - 1`` in the reference kernel's
        fp32 arithmetic chain, so sample positions match it bit for bit."""
        s = np.float32(math.log2(self.per_level_scale))
        return float(np.exp2(np.float32(level) * s) * np.float32(self.base_resolution)
                     - np.float32(1.0))

    def level_resolution(self, level: int) -> int:
        return int(np.ceil(self.level_scale(level))) + 1

    def active_strides(self, level: int) -> list:
        """Per-dim index strides; a dim stops contributing (stride 0) once the
        running stride exceeds the level's table size (reference
        gridencoder.cu:71-75), and the stride wraps as a uint32."""
        return self._strides(level)[0]

    def hashed(self, level: int) -> bool:
        """True where a hash grid's level overflows its table: its corners
        are hashed (JAX ``_corner_index``: the final uint32 stride exceeds
        the level's size)."""
        return self.gridtype == "hash" and self._strides(level)[1] > self.level_size(level)

    def level_size(self, level: int) -> int:
        return self.offsets[level + 1] - self.offsets[level]

    def _strides(self, level: int):
        """(active strides, the final uint32 stride) of a level."""
        size = self.level_size(level)
        res = self.level_resolution(level)
        n = res if self.align_corners else res + 1
        strides, stride = [], 1
        for _ in range(self.input_dim):
            strides.append(stride if stride <= size else 0)
            stride = (stride * n) % _U32
        return strides, stride

    @property
    def shift(self) -> float:
        """The offset added to ``x01 * scale`` (0 under align_corners)."""
        return 0.0 if self.align_corners else 0.5

    def init(self, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
        """A float32 table drawn from U(-1e-4, 1e-4), as ``GridSpec.init`` in
        JAX (reference grid.py:138-140); torch's draws, not JAX's. It lies on
        ``device``: by default the generator's, or the card without one
        (``device="cpu"`` for the CPU)."""
        if device is None:
            device = generator.device if generator is not None else "cuda"
        t = torch.empty((self.n_embeddings, self.level_dim), device=resolve_device(device))
        return t.uniform_(-1e-4, 1e-4, generator=generator)


def _corner_index(spec: GridSpec, level: int, corner_grid: torch.Tensor) -> torch.Tensor:
    """Table row within the level for integer corner coords [..., D].

    Mirrors the uint32 index of ``get_grid_index`` (reference
    gridencoder.cu:66-84) in int64: the running sum is masked to 32 bits
    after each multiply-add, which is uint32 wraparound; a hashed level
    (``GridSpec.hashed``) takes the XOR of ``coord_d * prime_d`` in uint32.
    """
    size = spec.level_size(level)
    index = torch.zeros(corner_grid.shape[:-1], dtype=torch.int64,
                        device=corner_grid.device)
    if spec.hashed(level):
        _refuse_unprimed(spec)
        for d in range(spec.input_dim):
            index = index ^ ((corner_grid[..., d] * _PRIMES[d]) & _U32_MASK)
        return index % size
    for d, stride in enumerate(spec.active_strides(level)):
        if stride:
            index = (index + corner_grid[..., d] * stride) & _U32_MASK
    return index % size


def _rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table[rows] through ``index_select``, whose gradient is an
    ``index_add_`` (atomics on the card): ``table[rows]``'s, an
    ``index_put_`` that sorts its indices, takes about a minute on the card
    when millions of points share a row (an untrained field's ambient
    points all fall in one cell)."""
    return table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, table.shape[-1])


def _is_bf16(embeddings: torch.Tensor, table_dtype) -> bool:
    if table_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"table_dtype {table_dtype}: float32 or bfloat16 tables only")
    return table_dtype == torch.bfloat16 or embeddings.dtype == torch.bfloat16


def _bf16_round(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 (ties to even), as float32."""
    return v.to(torch.bfloat16).float()


def _level_corners(x01: torch.Tensor, spec: GridSpec, level: int):
    """Per corner of each point's cell at ``level``: (table row, float32
    weight w_0 * ... * w_{D-1} in dim order), and the fractions the weights
    are formed from (under smoothstep ``f * f * (3 - 2 f)`` of the cell
    fractions f, in JAX's op order)."""
    D = spec.input_dim
    pos = x01 * spec.level_scale(level) + spec.shift
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    pg = pos_grid.to(torch.int64)
    corners = []
    for corner in range(1 << D):
        bits = [(corner >> d) & 1 for d in range(D)]
        w = None
        for d, bit in enumerate(bits):
            f = frac[..., d] if bit else (1.0 - frac[..., d])
            w = f if w is None else w * f
        cg = pg + torch.tensor(bits, dtype=torch.int64, device=x01.device)
        corners.append((_corner_index(spec, level, cg) + spec.offsets[level], w))
    return corners, frac


def _grid_encode_plain_bf16(x: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec,
                            bound: float, packed=None) -> torch.Tensor:
    """The bf16 policy's encode (module docstring): bf16 [..., L*C]; with
    ``packed`` (``pack_table``'s copy of the table) each corner's row is read
    from its cell's packed row, as kernel A-bf16 reads it."""
    x01 = (x.float() + bound) / (2.0 * bound)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1, keepdim=True)
    table = embeddings.to(torch.bfloat16).float()
    outs = []
    for level in range(spec.num_levels):
        out = None
        corners = _level_corners(x01, spec, level)[0]
        for c, (rows, w) in enumerate(corners):
            e = table[rows] if packed is None else packed[corners[0][0], c].float()
            term = _bf16_round(_bf16_round(w)[..., None] * e)
            out = term if out is None else out + term
        outs.append(out)
    out = torch.where(oob, 0.0, torch.cat(outs, dim=-1))
    return out.to(torch.bfloat16)


def grid_encode_plain(x: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec,
                      bound: float = 1.0, table_dtype=None, packed=None) -> torch.Tensor:
    """Plain PyTorch grid encoder: points in [-bound, bound] [..., D] ->
    features [..., L*C], level-major; points outside the box encode to 0.

    The arithmetic follows ``radnerf_tpu`` ``grid_encode01`` step for step:
    ``pos = x01*scale + 0.5``, corner weight ``inb * (w_0 * ... * w_{D-1})``
    (inb is 0 or 1, so the grouping rounds nothing), corners summed in order
    0..2^D-1. With ``table_dtype=torch.bfloat16`` (or a bf16 table) it is
    the bf16 policy's encode of the module docstring, with a bf16 result,
    reading the corners from ``packed`` (``pack_table``'s copy) when given.
    """
    if x.shape[-1] != spec.input_dim:
        raise ValueError(f"expected last dim {spec.input_dim}, got {tuple(x.shape)}")
    if _is_bf16(embeddings, table_dtype):
        return _grid_encode_plain_bf16(x, embeddings, spec, bound, packed)
    x01 = (x.float() + bound) / (2.0 * bound)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    inb = 1.0 - oob.float()
    outs = []
    for level in range(spec.num_levels):
        out = None
        for rows, w in _level_corners(x01, spec, level)[0]:
            contrib = (inb * w)[..., None] * _rows(embeddings, rows)
            out = contrib if out is None else out + contrib
        outs.append(out)
    return torch.cat(outs, dim=-1)


_LEVEL_TABLES: dict = {}


def _level_tables(spec: GridSpec, device: torch.device):
    """Per-level kernel parameters, built once per (spec, device): fp32
    scales [L] from the host-side fp32 chain, and int32 rows
    [offset, size, stride_0 .. stride_{D-1}] per level. A hashed level uses
    no stride: its row carries zeros there, and the kernels read its
    dim-0 stride of 0 (a dense level's is 1) as the hash flag."""
    key = (spec, device)
    if key not in _LEVEL_TABLES:
        L, offs, D = spec.num_levels, spec.offsets, spec.input_dim
        scales = np.array([spec.level_scale(l) for l in range(L)], np.float32)
        params = np.array([[offs[l], offs[l + 1] - offs[l],
                            *([0] * D if spec.hashed(l) else spec.active_strides(l))]
                           for l in range(L)], np.int32)
        _LEVEL_TABLES[key] = (torch.from_numpy(scales).to(device),
                              torch.from_numpy(params).to(device))
    return _LEVEL_TABLES[key]


def pack_table_plain(table: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Plain version of ``pack_table``: the corner-packed copy of a table
    in bf16, [n_embeddings, 2^D, C]. Row k of level l holds corner c's row
    ``(k + delta_c) mod T_l`` of the level (T_l its size, delta_c the sum of
    the strides of the dims where c's bit is set): for a cell whose corner 0
    is row k, its 2^D corner rows in corner order. That is JAX's
    ``build_packed_table(dtype=bfloat16)``'s entry k of level l, corner-major
    instead of channel-major and without its appended zero row. A hash
    grid's index is not additive, so it has no packed copy (as in JAX)."""
    if spec.gridtype != "tiled":
        raise ValueError("corner packing requires a tiled grid (hash indices are not additive)")
    table = table.to(torch.bfloat16)
    D, offs = spec.input_dim, spec.offsets
    levels = []
    for level in range(spec.num_levels):
        seg = table[offs[level]:offs[level + 1]]
        strides = spec.active_strides(level)
        k = torch.arange(seg.shape[0], dtype=torch.int64, device=table.device)
        rows = [(k + sum(strides[d] for d in range(D) if (c >> d) & 1)) % seg.shape[0]
                for c in range(1 << D)]
        levels.append(seg[torch.stack(rows, dim=1)])
    return torch.cat(levels)


def _check_packed(packed: torch.Tensor, spec: GridSpec):
    D, C = spec.input_dim, spec.level_dim
    if packed.shape != (spec.n_embeddings, 1 << D, C) or packed.dtype != torch.bfloat16:
        raise ValueError(f"packed table {tuple(packed.shape)} {packed.dtype} does not fit {spec}")
    if not packed.is_contiguous() or packed.data_ptr() % 16:
        raise ValueError("kernel A-bf16 takes a contiguous packed table aligned to 16 bytes")


def pack_table(table: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """The corner-packed bf16 copy kernel A-bf16 reads (``pack_table_plain``
    says what it holds): kernel ``grid_pack_bf16`` on a CUDA table, the plain
    version on a CPU one. table [n_embeddings, C] float32 or bf16 ->
    [n_embeddings, 2^D, C] bf16 (2^D x the bf16 table's bytes)."""
    if table.device.type == "cpu":
        return pack_table_plain(table, spec)
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    table = table.to(torch.bfloat16).contiguous()
    _check_pack_args(table, spec)
    require_cuda_tensors(table)
    packed = torch.empty((spec.n_embeddings, 1 << D, C), dtype=torch.bfloat16,
                         device=table.device)
    params = _level_tables(spec, table.device)[1]
    KERNELS["grid_pack_bf16"].launch("grid_pack_bf16", table.device, table.data_ptr(),
                                     params.data_ptr(), packed.data_ptr(), D, L, C)
    return packed


def _refuse_unprimed(spec: GridSpec):
    """Raise where a hashed level has more dims than the hash has primes
    (JAX's ``_corner_index`` raises an IndexError there)."""
    if spec.input_dim > len(_PRIMES):
        raise ValueError(f"a hashed level takes at most {len(_PRIMES)} dims (one prime "
                         f"each), got {spec}")


def _refuse_kernel_spec(spec: GridSpec, bf16: bool):
    """Raise unless the kernels take this grid: under the bf16 policy a
    tiled grid (a hash grid has no packed copy, as in JAX); no hashed
    level past the hash's seven dims. Every D, level count and channel
    count is taken."""
    if bf16 and spec.gridtype != "tiled":
        raise ValueError(f"the bf16 kernels read corner-packed rows, which a hash grid does "
                         f"not have (nor has JAX's build_packed_table), got {spec}")
    if spec.input_dim > len(_PRIMES) and spec.gridtype == "hash" and \
            any(spec.hashed(l) for l in range(spec.num_levels)):
        _refuse_unprimed(spec)


def _check_pack_args(table: torch.Tensor, spec: GridSpec):
    """Raise unless the packing pass takes this bf16 table: a grid the bf16
    kernels take (``_refuse_kernel_spec``), [n_embeddings, C], aligned to
    the widest unit of at most 16 bytes that divides a row (the pass copies
    each row in that unit)."""
    C = spec.level_dim
    _refuse_kernel_spec(spec, bf16=True)
    if table.shape != (spec.n_embeddings, C) or table.dtype != torch.bfloat16:
        raise ValueError(f"the packing pass takes the [n_embeddings, {C}] bf16 table of "
                         f"{spec}, got {tuple(table.shape)} {table.dtype}")
    if table.data_ptr() % math.gcd(16, 2 * C):
        raise ValueError("the packing pass takes a table aligned to its row unit")


def _check_kernel_args(x: torch.Tensor, table: torch.Tensor, spec: GridSpec):
    """Raise unless kernels A / A' take these points and this table
    (``_refuse_kernel_spec``): float32 points, a float32 or (tiled grids)
    bf16 table aligned to the widest load of a row pair."""
    D, C = spec.input_dim, spec.level_dim
    if x.shape[-1] != D:
        raise ValueError(f"kernel A takes [..., {D}] points for {spec}, got {tuple(x.shape)}")
    _refuse_kernel_spec(spec, bf16=table.dtype == torch.bfloat16)
    if table.shape != (spec.n_embeddings, C):
        raise ValueError(f"embeddings {tuple(table.shape)} do not fit {spec}")
    if x.dtype != torch.float32 or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("kernel A takes float32 points and a float32 or bf16 table")
    # the kernels read (and A' adds) a row, or two adjacent rows, in the
    # widest unit of at most 16 bytes that divides a row pair
    if table.data_ptr() % math.gcd(16, 2 * C * table.element_size()):
        raise ValueError("kernels A and A' take a table aligned to a row pair")


def _grid_encode_kernel(x, table, spec: GridSpec, bound: float, packed=None) -> torch.Tensor:
    """Kernel A: the forward encode of contiguous CUDA float32 points; on a
    bf16 table its bf16 variant, with a bf16 result, reading the table's
    packed copy ``packed`` (``pack_table``; packed here when not given)."""
    _check_kernel_args(x, table, spec)
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    require_cuda_tensors(x, table)
    N = x.numel() // D
    out = torch.empty((*x.shape[:-1], L * C), dtype=table.dtype, device=x.device)
    if N == 0:
        return out
    scales, params = _level_tables(spec, x.device)
    smooth, hashed, shift = _variant_args(spec)
    if table.dtype == torch.bfloat16:
        packed = pack_table(table, spec) if packed is None else packed
        _check_packed(packed, spec)
        require_cuda_tensors(x, packed)
        name, fn, table = "grid_encode_bf16", "grid_encode_fwd_bf16_packed", packed
        variant = (C, smooth, shift)
    else:
        name, fn, variant = "grid_encode", "grid_encode_fwd", (C, smooth, hashed, shift)
    KERNELS[name].launch(
        fn, x.device, x.data_ptr(), table.data_ptr(), scales.data_ptr(), params.data_ptr(),
        out.data_ptr(), N, D, L, *variant, float(bound), float(np.float32(2.0 * bound)))
    return out


def _variant_args(spec: GridSpec):
    """The entry points' variant arguments: smoothstep (0 or 1), hashed (1
    for a hash grid, whose levels may be hashed; the bf16 entry points, on
    tiled grids only, do not take it) and the shift (0.5, or 0 under
    align_corners)."""
    return int(spec.interpolation == "smoothstep"), int(spec.gridtype == "hash"), spec.shift


def _grid_encode_backward_plain_bf16(x, table, grad_out, spec: GridSpec, bound: float,
                                     need_x: bool):
    """Kernel A'-bf16's arithmetic in kernel order: per (point, level) and
    corner the table gradient ``bf16(w) * g`` (exact in float32) added into
    the corner's row, and for x the dot of g with the bf16 row times the
    weight's derivative (float32 fractions), summed over the corners, scaled
    by ``scale / (2 * bound)``, summed over the levels in order."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    x01 = (x.float() + bound) / (2.0 * bound)
    live = ((x01 >= 0.0) & (x01 <= 1.0)).all(dim=-1)
    tb = table.to(torch.bfloat16).float()
    g = grad_out.float().reshape(*x.shape[:-1], L, C)
    g_table = torch.zeros((spec.n_embeddings, C), dtype=torch.float32, device=x.device)
    two_bound = float(np.float32(2.0 * bound))
    g_x = None
    for level in range(L):
        corners, frac = _level_corners(x01, spec, level)
        gl = g[..., level, :]
        gpos = [torch.zeros_like(frac[..., 0]) for _ in range(D)]
        for corner, (rows, w) in enumerate(corners):
            g_table.index_add_(0, rows[live], (_bf16_round(w)[..., None] * gl)[live])
            if not need_x:
                continue
            e = tb[rows]
            dot = gl[..., 0] * e[..., 0]
            for ch in range(1, C):
                dot = dot + gl[..., ch] * e[..., ch]
            for d in range(D):
                dw = None
                for e_ in range(D):
                    if e_ == d:
                        continue
                    f = frac[..., e_] if (corner >> e_) & 1 else (1.0 - frac[..., e_])
                    dw = f if dw is None else dw * f
                if dw is None:  # D = 1: no other dims
                    dw = torch.ones_like(frac[..., 0])
                if not (corner >> d) & 1:
                    dw = -dw
                gpos[d] = gpos[d] + dot * dw
        if need_x:
            xg = torch.stack(gpos, dim=-1)
            if spec.interpolation == "smoothstep":  # d frac / d pos = 6 f (1 - f)
                pos = x01 * spec.level_scale(level) + spec.shift
                f = pos - torch.floor(pos)
                xg = xg * (6.0 * f * (1.0 - f))
            xg = xg * spec.level_scale(level) / two_bound
            xg = torch.where(live[..., None], xg, 0.0)
            g_x = xg if g_x is None else g_x + xg
    return g_table, g_x


def grid_encode_backward_plain(x, embeddings, grad_out, spec: GridSpec, bound: float = 1.0,
                               need_x: bool = True, table_dtype=None):
    """Plain version of ``grid_encode_backward``: autograd through
    ``grid_encode_plain``; under the bf16 policy (a bf16 table, or
    ``table_dtype=torch.bfloat16``) kernel A'-bf16's arithmetic. Returns
    (grad_table float32, grad_x or None)."""
    if _is_bf16(embeddings, table_dtype):
        return _grid_encode_backward_plain_bf16(x, embeddings, grad_out, spec, bound, need_x)
    x = x.detach().requires_grad_(need_x)
    emb = embeddings.detach().requires_grad_(True)
    with torch.enable_grad():
        out = grid_encode_plain(x, emb, spec, bound)
        grads = torch.autograd.grad(out, [emb, x] if need_x else [emb], grad_out)
    return grads[0], (grads[1] if need_x else None)


def grid_encode_backward(x, embeddings, grad_out, spec: GridSpec, bound: float = 1.0,
                         need_table: bool = True, need_x: bool = True, table_dtype=None):
    """Gradients of ``grid_encode`` (the semantics of JAX's autodiff of
    ``grid_encode01``): the table gradient is the scatter-add of
    ``w_corner * grad_out`` into each corner row; the gradient for x flows
    through ``frac`` only, ``d pos / d x = scale_l / (2 * bound)``; points
    outside the box get zero for both. Kernel A' on CUDA tensors, the plain
    version on CPU tensors. Under the bf16 policy (a bf16 table, or
    ``table_dtype=torch.bfloat16`` with the float32 master) grad_out is the
    bf16 upstream gradient, the weights are rounded to bf16 as in the
    forward, and kernel A'-bf16 runs (its table gradient summed through a
    pair-keyed float32 buffer [n_embeddings, 2C] made here: each corner pair
    added whole into the key of its first row, then every row formed from
    two keys; csrc/grid_encode_backward.cu).

    Returns (grad_table [n_embeddings, C] float32 or None, grad_x [..., D]
    float32 or None).
    """
    bf16 = _is_bf16(embeddings, table_dtype)
    if x.device.type == "cpu":
        g_table, g_x = grid_encode_backward_plain(x, embeddings, grad_out, spec, bound,
                                                  need_x, table_dtype)
        return (g_table if need_table else None), g_x
    table = embeddings.to(torch.bfloat16) if bf16 else embeddings
    _check_kernel_args(x, table, spec)
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    if grad_out.shape != (*x.shape[:-1], L * C) or grad_out.dtype != table.dtype:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} {grad_out.dtype} does not fit "
                         f"points {tuple(x.shape)}, a {table.dtype} table and {spec}")
    x, grad_out = x.contiguous(), grad_out.contiguous()
    if grad_out.data_ptr() % 16:  # read a (point, level) at a time, up to 16 B
        grad_out = grad_out.clone()
    require_cuda_tensors(x, table, grad_out)
    # the kernel stores every element of grad_x; A' adds into grad_table
    # (zeroed), A'-bf16 into its pair keys (zeroed) and then stores every
    # row of grad_table
    N = x.numel() // D
    run = N > 0 and (need_table or need_x)
    g_table = None
    if need_table:
        g_table = (torch.empty if run and bf16 else torch.zeros)(
            (spec.n_embeddings, C), dtype=torch.float32, device=x.device)
    g_x = torch.empty_like(x) if need_x else None
    if run:
        scales, params = _level_tables(spec, x.device)
        args = (x.data_ptr(), table.data_ptr(), grad_out.data_ptr(), scales.data_ptr(),
                params.data_ptr())
        outs = (g_table.data_ptr() if need_table else None,
                g_x.data_ptr() if need_x else None, N, D, L, C)
        smooth, hashed, shift = _variant_args(spec)
        geometry = (float(bound), float(np.float32(2.0 * bound)))
        if bf16:
            keys = (torch.zeros((spec.n_embeddings, 2 * C), dtype=torch.float32,
                                device=x.device) if need_table else None)
            KERNELS["grid_encode_backward_bf16"].launch(
                "grid_encode_bwd_bf16_keyed", x.device, *args,
                keys.data_ptr() if need_table else None, *outs, smooth, shift, *geometry)
        else:
            KERNELS["grid_encode_backward"].launch(
                "grid_encode_bwd", x.device, *args, *outs, smooth, hashed, shift, *geometry)
    return g_table, g_x


def grid_total_variation(x01: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec,
                         weight: float = 1e-7) -> torch.Tensor:
    """The scalar total-variation loss of a grid table at sampled points
    (``radnerf_tpu/ops/grid_encode.py grid_total_variation``; the
    reference's grad_total_variation, gridencoder.cu:505-644, as a loss):
    at every level, the squared difference of each point's cell row to its
    +1 neighbour's in every dim, summed, times ``weight``. x01 [..., D] in
    [0, 1]; differentiable through autograd (plain PyTorch, no kernel)."""
    total = None
    for level in range(spec.num_levels):
        pos = torch.floor(x01 * spec.level_scale(level) + spec.shift).to(torch.int64)
        base = embeddings[_corner_index(spec, level, pos) + spec.offsets[level]]
        for d in range(spec.input_dim):
            nb = pos.clone()
            nb[..., d] += 1
            nbv = embeddings[_corner_index(spec, level, nb) + spec.offsets[level]]
            term = torch.sum((nbv - base) ** 2)
            total = term if total is None else total + term
    return weight * total


class _GridEncode(torch.autograd.Function):
    """Kernel A forward, kernel A' backward. Under the bf16 policy
    (``bf16``) the forward casts a float32 master table to a bf16 copy and
    packs it (a train step's encode re-casts and re-packs it, as the JAX
    step re-packs its tables) and the backward returns the master's float32
    gradient; on CPU tensors (the bf16 policy only: the float32 encode's CPU
    autograd runs through the plain ops) both run their plain versions."""

    @staticmethod
    def forward(ctx, x, embeddings, spec, bound, bf16):
        table = embeddings.to(torch.bfloat16) if bf16 else embeddings
        ctx.save_for_backward(x, table)
        ctx.spec, ctx.bound = spec, bound
        if x.device.type == "cpu":
            return _grid_encode_plain_bf16(x, table, spec, bound)
        return _grid_encode_kernel(x, table, spec, bound)

    @staticmethod
    def backward(ctx, grad_out):
        x, table = ctx.saved_tensors
        g_table, g_x = grid_encode_backward(
            x, table, grad_out, ctx.spec, ctx.bound,
            need_table=ctx.needs_input_grad[1], need_x=ctx.needs_input_grad[0])
        return g_x, g_table, None, None, None


def grid_encode(x: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec,
                bound: float = 1.0, table_dtype=None, packed=None) -> torch.Tensor:
    """Encode points in [-bound, bound]: kernel A on CUDA tensors, the plain
    twin on CPU tensors. x [..., D] float32, embeddings [n_embeddings, C]
    float32 -> [..., L*C] float32.

    Under the bf16 policy (``table_dtype=torch.bfloat16`` with the float32
    master table, or a bf16 table) the result is bf16 and the kernel is
    A's bf16 variant, on ``packed`` (``pack_table`` of the bf16 table: a
    caller whose table does not change keeps it; packed in the call when
    not given, and always when autograd wants a gradient).

    When autograd wants a gradient for x or the table, the encode goes
    through a ``torch.autograd.Function`` whose backward is kernel A'
    (``grid_encode_backward``) on CUDA tensors (and, under the bf16 policy,
    its plain version on CPU tensors); the gradient for x is computed only
    when x requires it."""
    bf16 = _is_bf16(embeddings, table_dtype)
    wants_grad = torch.is_grad_enabled() and (x.requires_grad or embeddings.requires_grad)
    if x.device.type == "cpu":
        if bf16 and wants_grad:
            return _GridEncode.apply(x, embeddings, spec, bound, True)
        return grid_encode_plain(x, embeddings, spec, bound, table_dtype, packed)
    x = x.contiguous()
    if wants_grad:
        return _GridEncode.apply(x, embeddings, spec, bound, bf16)
    if bf16:
        embeddings = embeddings.to(torch.bfloat16)
    return _grid_encode_kernel(x, embeddings, spec, bound, packed if bf16 else None)
