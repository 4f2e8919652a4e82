"""ER-NeRF's tri-plane encode: a point's three plane projections, each
through its own 2-D grid (ER-NeRF ``nerf_triplane/network.py`` ``encode_x``).

A point x in [-bound, bound]^3 is projected onto the planes (x, y), (y, z)
and (x, z) (ER-NeRF's slices ``xyz[:, :-1]``, ``xyz[:, 1:]``,
``xyz[:, ::2]``); each projection is encoded by a 2-D grid of one shared
``GridSpec`` through its own table, and the three encodes are concatenated
plane-major: [..., 3 L C] in the order xy, yz, xz.

``triplane_encode`` is the wrapper of kernel A-tri
(``csrc/grid_encode.cu`` ``triplane_encode_kernel``), one launch that reads
each point's xyz once and writes the whole [N, 3 L C] result; on CPU tensors
it runs the plain twin ``triplane_encode_plain``: three ``grid_encode_plain``
calls concatenated, whose arithmetic the kernel follows op for op (built
with -fmad=false, as kernel A), so the two agree bit for bit. A-tri has no
backward yet: on the card a gradient is refused; on the CPU autograd runs
through the twin's plain ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ._kernels import GRID_MAX_LEVELS, KERNELS, refuse_grad, require_cuda_tensors
from .grid_encode import GridSpec, _level_tables, grid_encode_plain

# the dims of x each plane takes, in output order: xy, yz, xz
PLANES = ((0, 1), (1, 2), (0, 2))


def triplane_encode_plain(x: torch.Tensor, tables, spec: GridSpec,
                          bound: float = 1.0) -> torch.Tensor:
    """Plain version: x [..., 3] -> [..., 3 L C] float32, the three planes'
    ``grid_encode_plain`` concatenated (each projection outside its square
    encodes to 0)."""
    _check_spec(x, tables, spec)
    return torch.cat([grid_encode_plain(x[..., list(dims)], t, spec, bound)
                      for dims, t in zip(PLANES, tables)], dim=-1)


def _check_spec(x, tables, spec: GridSpec):
    if spec.input_dim != 2 or x.shape[-1] != 3 or len(tables) != 3:
        raise ValueError(f"the tri-plane encode takes points [..., 3], three tables and a 2-D "
                         f"grid, got {tuple(x.shape)}, {len(tables)} tables, {spec}")
    for t in tables:
        if tuple(t.shape) != (spec.n_embeddings, spec.level_dim):
            raise ValueError(f"table {tuple(t.shape)} does not fit {spec}")


def triplane_encode(x: torch.Tensor, tables, spec: GridSpec, bound: float = 1.0
                    ) -> torch.Tensor:
    """Encode points [..., 3] on the three planes: kernel A-tri on CUDA
    tensors, the plain twin on CPU tensors. ``tables``: (xy, yz, xz), each a
    float32 [n_embeddings, C] table of ``spec`` (D = 2). Returns [..., 3 L C]
    float32. The kernel takes ER-NeRF's planes: one channel, linear, not
    aligned, at most ``GRID_MAX_LEVELS`` levels (hashed or dense); and no
    gradient."""
    if x.device.type == "cpu":
        return triplane_encode_plain(x, tables, spec, bound)
    _check_spec(x, tables, spec)
    L = spec.num_levels
    if spec.level_dim != 1 or spec.interpolation != "linear" or spec.align_corners \
            or L > GRID_MAX_LEVELS:
        raise ValueError(f"kernel A-tri takes one-channel linear planes, not aligned, of at "
                         f"most {GRID_MAX_LEVELS} levels, got {spec}")
    refuse_grad("kernel A-tri", x=x, table_xy=tables[0], table_yz=tables[1],
                table_xz=tables[2])
    if x.dtype != torch.float32 or any(t.dtype != torch.float32 for t in tables):
        raise ValueError("kernel A-tri takes float32 points and tables")
    x = x.contiguous()
    require_cuda_tensors(x, *tables)
    # an aligned corner pair is read in one 8-byte load (load_row_pair)
    if any(t.data_ptr() % 8 for t in tables):
        raise ValueError("kernel A-tri takes tables aligned to a row pair")
    N = x.numel() // 3
    out = torch.empty((*x.shape[:-1], 3 * L), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    scales, params = _level_tables(spec, x.device)
    KERNELS["triplane_encode"].launch(
        "triplane_encode_fwd", x.device, x.data_ptr(), *(t.data_ptr() for t in tables),
        scales.data_ptr(), params.data_ptr(), out.data_ptr(), N, L, float(bound),
        float(np.float32(2.0 * bound)))
    return out
