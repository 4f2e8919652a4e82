"""Morton (Z-order) codes and occupancy bit packing.

Counterpart of ``radnerf_tpu/ops/morton.py``. Torch has no uint32
arithmetic, so the bit tricks run in int64; each mask keeps only bits below
2^32, which is what uint32 wraparound would keep.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value out to every 3rd bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] int coords in [0, 1024) -> [...] Morton codes (int64)."""
    c = coords.to(torch.int64)
    return (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2))


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    """[...] Morton codes -> [..., 3] int64 coords."""
    i = indices.to(torch.int64) & _U32
    return torch.stack(
        [_compact_bits(i), _compact_bits(i >> 1), _compact_bits(i >> 2)], dim=-1)


def packbits(grid: torch.Tensor, thresh) -> torch.Tensor:
    """Density grid [C, H^3] -> bitfield uint8 [C*H^3//8]; bit k of byte b is
    flat (Morton) cell b*8+k."""
    occ = (grid.reshape(-1) > thresh).to(torch.uint8).reshape(-1, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=grid.device)
    return torch.bitwise_left_shift(occ, shifts).sum(dim=-1).to(torch.uint8)
