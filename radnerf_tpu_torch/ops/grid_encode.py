"""Multiresolution tiled grid encoding (Instant-NGP style).

Counterpart of ``radnerf_tpu/ops/grid_encode.py``. ``GridSpec`` carries the
same level geometry (offsets, the fp32 ``level_scale`` chain, resolutions).
``grid_encode`` is the wrapper of kernel A (``csrc/grid_encode.cu``): on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain twin
``grid_encode_plain``, which follows ``grid_encode01``'s per-corner
arithmetic in the same order. Its gradient on the card is kernel A'
(``csrc/grid_encode_backward.cu``, ``grid_encode_backward``); on the CPU
autograd runs through the twin's plain ops.

Only tiled grids with linear interpolation and ``align_corners=False`` --
the shapes every RAD-NeRF encoder uses -- are supported; anything else
raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ._kernels import KERNELS, require_cuda_tensors

_U32 = 1 << 32
_U32_MASK = _U32 - 1


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
        size = self.offsets[level + 1] - self.offsets[level]
        res = self.level_resolution(level)
        n = res if self.align_corners else res + 1
        strides, stride = [], 1
        for _ in range(self.input_dim):
            strides.append(stride if stride <= size else 0)
            stride = (stride * n) % _U32
        return strides

    def check_supported(self):
        if (self.gridtype != "tiled" or self.interpolation != "linear"
                or self.align_corners):
            raise NotImplementedError(
                "the port encodes tiled grids with linear interpolation and "
                f"align_corners=False only, got {self}")


def _corner_index(spec: GridSpec, level: int, corner_grid: torch.Tensor) -> torch.Tensor:
    """Table row within the level for integer corner coords [..., D].

    Mirrors the uint32 index of ``get_grid_index`` (reference
    gridencoder.cu:66-84) in int64: the running sum is masked to 32 bits
    after each multiply-add, which is uint32 wraparound.
    """
    size = spec.offsets[level + 1] - spec.offsets[level]
    index = torch.zeros(corner_grid.shape[:-1], dtype=torch.int64,
                        device=corner_grid.device)
    for d, stride in enumerate(spec.active_strides(level)):
        if stride:
            index = (index + corner_grid[..., d] * stride) & _U32_MASK
    return index % size


def grid_encode_plain(x: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec,
                      bound: float = 1.0) -> torch.Tensor:
    """Plain PyTorch grid encoder: points in [-bound, bound] [..., D] ->
    features [..., L*C], level-major; points outside the box encode to 0.

    The arithmetic follows ``radnerf_tpu`` ``grid_encode01`` step for step:
    ``pos = x01*scale + 0.5``, corner weight ``inb * w_0 * ... * w_{D-1}``,
    corners summed in order 0..2^D-1.
    """
    spec.check_supported()
    D = spec.input_dim
    if x.shape[-1] != D:
        raise ValueError(f"expected last dim {D}, got {tuple(x.shape)}")
    x01 = (x.float() + bound) / (2.0 * bound)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    inb = 1.0 - oob.float()
    offs = spec.offsets
    outs = []
    for level in range(spec.num_levels):
        pos = x01 * spec.level_scale(level) + 0.5
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        pg = pos_grid.to(torch.int64)
        out = None
        for corner in range(1 << D):
            w = inb
            bits = [(corner >> d) & 1 for d in range(D)]
            for d, bit in enumerate(bits):
                w = w * (frac[..., d] if bit else (1.0 - frac[..., d]))
            cg = pg + torch.tensor(bits, dtype=torch.int64, device=x.device)
            rows = _corner_index(spec, level, cg) + offs[level]
            contrib = w[..., None] * embeddings[rows]
            out = contrib if out is None else out + contrib
        outs.append(out)
    return torch.cat(outs, dim=-1)


_LEVEL_TABLES: dict = {}


def _level_tables(spec: GridSpec, device: torch.device):
    """Per-level kernel parameters, built once per (spec, device): fp32
    scales [L] from the host-side fp32 chain, and int32 rows
    [offset, size, stride_0 .. stride_{D-1}] per level."""
    key = (spec, device)
    if key not in _LEVEL_TABLES:
        L, offs = spec.num_levels, spec.offsets
        scales = np.array([spec.level_scale(l) for l in range(L)], np.float32)
        params = np.array([[offs[l], offs[l + 1] - offs[l], *spec.active_strides(l)]
                           for l in range(L)], np.int32)
        _LEVEL_TABLES[key] = (torch.from_numpy(scales).to(device),
                              torch.from_numpy(params).to(device))
    return _LEVEL_TABLES[key]


def _check_kernel_args(x: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec):
    spec.check_supported()
    D, C = spec.input_dim, spec.level_dim
    if x.shape[-1] != D or D not in (2, 3):
        raise ValueError(f"kernel A takes D in (2, 3) points, got {tuple(x.shape)}")
    if C != 2 or spec.num_levels > 32:
        raise ValueError(f"kernels A and A' take 2 channels and at most 32 levels, got {spec}")
    if embeddings.shape != (spec.n_embeddings, C):
        raise ValueError(f"embeddings {tuple(embeddings.shape)} do not fit {spec}")
    if x.dtype != torch.float32 or embeddings.dtype != torch.float32:
        raise ValueError("kernel A takes float32 points and tables")
    if embeddings.data_ptr() % 16:  # the kernels read and add row pairs as 16 B
        raise ValueError("kernels A and A' take a table aligned to 16 bytes")


def _grid_encode_kernel(x, embeddings, spec: GridSpec, bound: float) -> torch.Tensor:
    """Kernel A: the forward encode of contiguous CUDA float32 points."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    require_cuda_tensors(x, embeddings)
    N = x.numel() // D
    out = torch.empty((*x.shape[:-1], L * C), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    scales, params = _level_tables(spec, x.device)
    KERNELS["grid_encode"].launch(
        "grid_encode_fwd", x.device, x.data_ptr(), embeddings.data_ptr(),
        scales.data_ptr(), params.data_ptr(), out.data_ptr(), N, D, L,
        float(bound), float(np.float32(2.0 * bound)))
    return out


def grid_encode_backward_plain(x, embeddings, grad_out, spec: GridSpec, bound: float = 1.0,
                               need_x: bool = True):
    """Plain version of ``grid_encode_backward``: autograd through
    ``grid_encode_plain``. Returns (grad_table, grad_x or None)."""
    x = x.detach().requires_grad_(need_x)
    emb = embeddings.detach().requires_grad_(True)
    with torch.enable_grad():
        out = grid_encode_plain(x, emb, spec, bound)
        grads = torch.autograd.grad(out, [emb, x] if need_x else [emb], grad_out)
    return grads[0], (grads[1] if need_x else None)


def grid_encode_backward(x, embeddings, grad_out, spec: GridSpec, bound: float = 1.0,
                         need_table: bool = True, need_x: bool = True):
    """Gradients of ``grid_encode`` (the semantics of JAX's autodiff of
    ``grid_encode01``): the table gradient is the scatter-add of
    ``w_corner * grad_out`` into each corner row; the gradient for x flows
    through ``frac`` only, ``d pos / d x = scale_l / (2 * bound)``; points
    outside the box get zero for both. Kernel A' on CUDA tensors, the plain
    version on CPU tensors.

    Returns (grad_table [n_embeddings, C] or None, grad_x [..., D] or None).
    """
    if x.device.type == "cpu":
        g_table, g_x = grid_encode_backward_plain(x, embeddings, grad_out, spec, bound,
                                                  need_x)
        return (g_table if need_table else None), g_x
    _check_kernel_args(x, embeddings, spec)
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    if grad_out.shape != (*x.shape[:-1], L * C) or grad_out.dtype != torch.float32:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not fit points "
                         f"{tuple(x.shape)} and {spec}")
    x, grad_out = x.contiguous(), grad_out.contiguous()
    require_cuda_tensors(x, embeddings, grad_out)
    # the kernel stores every element of grad_x; grad_table takes atomic adds
    g_table = torch.zeros_like(embeddings) if need_table else None
    g_x = torch.empty_like(x) if need_x else None
    N = x.numel() // D
    if N > 0 and (need_table or need_x):
        scales, params = _level_tables(spec, x.device)
        KERNELS["grid_encode_backward"].launch(
            "grid_encode_bwd", x.device, x.data_ptr(), embeddings.data_ptr(),
            grad_out.data_ptr(), scales.data_ptr(), params.data_ptr(),
            g_table.data_ptr() if need_table else None,
            g_x.data_ptr() if need_x else None, N, D, L,
            float(bound), float(np.float32(2.0 * bound)))
    return g_table, g_x


class _GridEncode(torch.autograd.Function):
    """Kernel A forward, kernel A' backward."""

    @staticmethod
    def forward(ctx, x, embeddings, spec, bound):
        ctx.save_for_backward(x, embeddings)
        ctx.spec, ctx.bound = spec, bound
        return _grid_encode_kernel(x, embeddings, spec, bound)

    @staticmethod
    def backward(ctx, grad_out):
        x, embeddings = ctx.saved_tensors
        g_table, g_x = grid_encode_backward(
            x, embeddings, grad_out, ctx.spec, ctx.bound,
            need_table=ctx.needs_input_grad[1], need_x=ctx.needs_input_grad[0])
        return g_x, g_table, None, None


def grid_encode(x: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec,
                bound: float = 1.0) -> torch.Tensor:
    """Encode points in [-bound, bound]: kernel A on CUDA tensors, the plain
    twin on CPU tensors. x [..., D] float32, embeddings [n_embeddings, C]
    float32 -> [..., L*C] float32.

    On CUDA tensors, when autograd wants a gradient for x or the table, the
    encode goes through a ``torch.autograd.Function`` whose backward is
    kernel A' (``grid_encode_backward``); the gradient for x is computed only
    when x requires it."""
    if x.device.type == "cpu":
        return grid_encode_plain(x, embeddings, spec, bound)
    _check_kernel_args(x, embeddings, spec)
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or embeddings.requires_grad):
        return _GridEncode.apply(x, embeddings, spec, bound)
    return _grid_encode_kernel(x, embeddings, spec, bound)
