"""The work a call needs, counted from its inputs, and the card's peaks: the
yardstick of the roofline and ``mfu`` metrics.

``row_counts``, ``grid_work``, ``grid_backward_work``, ``_weight_tree_flops``
and ``bound_s`` are frozen copies of ``chip_smoke.py`` at commit
2a619bf24d8171cdad65a8fd4e01bbb8c7f3f0f8 (its table rows from this
package's ``ops.corner_rows``, tiled grids). ``mlp_flops``,
``frame_flops``, ``step_flops`` and ``density_flops`` count the model's own
operations for ``mfu``.
The peaks are NVIDIA's data sheet for one H100 SXM at 700 W: 3.35 TB/s of
HBM, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s dense bf16.
"""

from __future__ import annotations

import torch

from .ops import GridSpec, corner_rows

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def row_counts(x, spec: GridSpec, bound: float):
    """(contributions each table row takes from the in-bounds points, the
    number of in-bounds points)."""
    D, L = spec.input_dim, spec.num_levels
    x01 = (x.float() + bound) / (2.0 * bound)
    inb = ((x01 >= 0) & (x01 <= 1)).all(dim=-1)
    x01 = x01[inb]
    counts = torch.zeros(spec.n_embeddings, dtype=torch.int64, device=x.device)
    for level in range(L):
        pg = torch.floor(x01 * spec.level_scale(level) + 0.5).long()
        for corner in range(1 << D):
            bits = torch.tensor([(corner >> d) & 1 for d in range(D)], device=x.device)
            counts += torch.bincount(corner_rows(spec, level, pg + bits),
                                     minlength=spec.n_embeddings)
    return counts, int(inb.sum())


def _weight_tree_flops(D):
    return (1 << (D + 1)) - 4


def grid_work(x, spec: GridSpec, bound: float, elem: int = 4, counts=None):
    """(bytes, flops) of a grid encode: the points, the output, each touched
    row read once; 4D + tree + 2C a corner flops a (point, level)."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    counts, n_in = counts or row_counts(x, spec, bound)
    n_rows = int((counts > 0).sum())
    n_bytes = x.numel() * 4 + x.shape[0] * L * C * elem + n_rows * C * elem
    n_flops = n_in * L * (4 * D + _weight_tree_flops(D) + (1 << D) * 2 * C)
    return n_bytes, n_flops


def grid_backward_work(x, spec: GridSpec, bound: float, need_x: bool, elem: int = 4,
                       counts=None):
    """(bytes, flops) of a grid encode's backward: the points and grad_out
    read once, each touched row of the float32 table gradient written once
    (with the x gradient, each touched row read and grad_x written)."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    counts, n_in = counts or row_counts(x, spec, bound)
    n_rows = int((counts > 0).sum())
    n_bytes = x.numel() * 4 + x.shape[0] * L * C * elem + n_rows * C * 4
    tree = _weight_tree_flops(D)
    per_point, per_corner = 4 * D + tree, C
    if need_x:
        n_bytes += n_rows * C * elem + x.numel() * 4
        per_point += tree + 2 * D
        per_corner += 2 * C + 2
    return n_bytes, n_in * L * (per_point + (1 << D) * per_corner)


def bound_s(n_bytes: float, n_flops: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the precision's peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FLOPS[dtype])


def mlp_flops(arch) -> dict:
    """Multiply-add flops (2 a weight) of one forward through each MLP, a
    sample (the head's ambient, sigma and colour nets) or a pixel (the
    torso's two)."""
    def mlp(i, o, h, n):
        dims = [i] + [h] * (n - 1) + [o]
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))

    g, w = arch.grid.output_dim, arch.ambient.output_dim
    out = {"ambient": mlp(g + arch.audio_dim, arch.ambient_dim, arch.hidden_ambient,
                          arch.num_layers_ambient),
           "sigma": mlp(g + w + int(arch.exp_eye), 1 + arch.geo_feat, arch.hidden,
                        arch.num_layers),
           "color": mlp(16 + arch.geo_feat + arch.ind_dim, 3, arch.hidden_color,
                        arch.num_layers_color)}
    out["head"] = out["ambient"] + out["sigma"] + out["color"]
    if arch.torso:
        t = arch.torso_grid.output_dim
        out["torso"] = mlp(42 + 54 + arch.ind_dim_torso, 2, 64, 3) \
            + mlp(t + 42 + 54 + arch.ind_dim_torso, 4, 32, 3)
    return out


def encode_flops(spec: GridSpec) -> int:
    """A grid encode's flops a point (``grid_work``'s count)."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    return L * (4 * D + _weight_tree_flops(D) + (1 << D) * 2 * C)


def encode_backward_flops(spec: GridSpec, need_x: bool) -> int:
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    tree = _weight_tree_flops(D)
    per_point, per_corner = 4 * D + tree, C
    if need_x:
        per_point += tree + 2 * D
        per_corner += 2 * C + 2
    return L * (per_point + (1 << D) * per_corner)


def frame_flops(arch, n_samples: int, n_pixels: int) -> int:
    """The model's flops of one frame: the head's MLPs and two encodes on
    every marched sample, the torso's MLPs and encode on every pixel."""
    f = mlp_flops(arch)
    head = n_samples * (f["head"] + encode_flops(arch.grid) + encode_flops(arch.ambient))
    torso = n_pixels * (f["torso"] + encode_flops(arch.torso_grid)) if arch.torso else 0
    return head + torso


def step_flops(arch, n_samples: int) -> int:
    """The model's flops of one head-stage training step on ``n_samples``
    marched samples: the MLPs forward and backward (3x the forward: the
    input and the weight gradients), both encodes forward, the spatial
    encode's table gradient and the ambient encode's table and x
    gradients."""
    f = mlp_flops(arch)["head"]
    return n_samples * (3 * f + encode_flops(arch.grid) + encode_flops(arch.ambient)
                        + encode_backward_flops(arch.grid, False)
                        + encode_backward_flops(arch.ambient, True))


def density_flops(arch, n_points: int) -> int:
    """The model's flops of an upkeep's density queries: the ambient and
    sigma nets and both encodes at every point."""
    f = mlp_flops(arch)
    return n_points * (f["ambient"] + f["sigma"] + encode_flops(arch.grid)
                       + encode_flops(arch.ambient))
