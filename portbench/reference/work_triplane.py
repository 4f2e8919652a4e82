"""The work of ER-NeRF's frame, counted from its inputs: kernel A-tri's bytes
and flops (the yardstick of ``triplane_fwd_roofline``) and the frame's model
flops (``mfu``), by ``work.py``'s rules: each point read once, each feature
written once, each distinct table row touched read once; 4 D + the weight
tree + 2 C flops a corner for each (point, level) in the box
(``work.encode_flops``); 2 flops a weight of every MLP a frame runs."""

from __future__ import annotations

import torch

from . import field_triplane as ftri
from .work import _weight_tree_flops, encode_flops


def plane_rows_touched(x2, spec, bound: float):
    """(distinct rows of a plane's table its in-box points read, the number
    of in-box points): x2 [N, 2]."""
    x01 = (x2.float() + bound) / (2.0 * bound)
    x01 = x01[((x01 >= 0) & (x01 <= 1)).all(dim=-1)]
    hit = torch.zeros(spec.n_embeddings, dtype=torch.bool, device=x2.device)
    for level in range(spec.num_levels):
        pg = torch.floor(x01 * spec.level_scale(level) + 0.5).long()
        for corner in range(4):
            bits = torch.tensor([corner & 1, (corner >> 1) & 1], device=x2.device)
            hit[ftri.plane_rows(spec, level, pg + bits)] = True
    return int(hit.sum()), int(x01.shape[0])


def triplane_work(x, spec, bound: float):
    """(bytes, flops) of one A-tri call on points x [N, 3]: the points, the
    [N, 3 L C] features, each plane's touched rows read once; each plane's
    encode flops on its in-box points."""
    L, C = spec.num_levels, spec.level_dim
    n_bytes = x.numel() * 4 + x.shape[0] * 3 * L * C * 4
    per_point = L * (4 * 2 + _weight_tree_flops(2) + 4 * 2 * C)
    n_flops = 0
    for dims in ftri.PLANES:
        rows, n_in = plane_rows_touched(x[:, list(dims)], spec, bound)
        n_bytes += rows * C * 4
        n_flops += n_in * per_point
    return n_bytes, n_flops


def mlp_flops(arch: ftri.Arch) -> dict:
    """2 flops a weight of one forward through each MLP a frame runs."""
    def mlp(i, o, h, n):
        dims = [i] + [h] * (n - 1) + [o]
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))

    return {name: mlp(*shape) for name, shape in arch.mlps().items()}


def frame_flops(arch: ftri.Arch, n_samples: int, n_pixels: int) -> int:
    """The model's flops of one frame: the head's MLPs (attention, eye,
    density, colour) and the tri-plane encode on every marched sample, the
    torso's two MLPs and its grid encode on every pixel."""
    f = mlp_flops(arch)
    head = sum(v for k, v in f.items() if not k.startswith("torso"))
    out = n_samples * (head + 3 * encode_flops(arch.plane))
    if arch.torso:
        out += n_pixels * (f["torso_deform_net"] + f["torso_net"]
                           + encode_flops(arch.torso_grid))
    return out
