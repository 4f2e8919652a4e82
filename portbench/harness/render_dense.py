"""Traffic of kind ``render_dense``: the ``render`` kind's offline video
(``render.py``, driven as it is: the same avatar field, track, audio, eye
values, window and comparison) on the density grid of a field early in
training, where every cell of the 128^3 grid is still marked occupied.

Each cell of that grid holds a value drawn from the seed just above the
occupancy threshold (``density_thresh`` times U(``grid_over_thresh``)), so
the threshold (the lesser of the grid's mean and ``density_thresh``) keeps
every cell, and the march's transmittance cull, which sums the grid's
values along a ray, never stops a ray inside its ``max_steps`` samples:
every ray that crosses the box marches all of them, 16 a ray at 512x512
(4,194,304 a frame). The field the samples are composited from is the
avatar's, so the image is the avatar's seen through every sample."""

from __future__ import annotations

import numpy as np

from ..reference import scene as rscene
from . import heap
from . import render as hrender

check = hrender.check
controls = hrender.controls


def early_grid(occ, seed: int, thresh: float, over) -> "torch.Tensor":
    """A density grid shaped as ``occ`` whose every cell is ``thresh``
    times a seeded draw from U(over[0], over[1])."""
    import torch

    rng = np.random.default_rng(seed)
    v = rng.uniform(float(over[0]), float(over[1]), occ.numel()).astype(np.float32) * thresh
    return torch.from_numpy(v).reshape(occ.shape).to(occ.device)


def run(ctx: dict, seed: int, seconds: float, trace: bool) -> dict:
    """``render.run`` with the avatar's density grid replaced by
    ``early_grid`` (the torso grid kept)."""
    heap.keep_host_heap()
    thresh = float(ctx["config"]["render"]["density_thresh"])
    over = ctx["traffic"]["grid_over_thresh"]
    avatar = rscene.avatar_grids

    def grids(device, G=128):
        occ, torso = avatar(device, G)
        return early_grid(occ, seed, thresh, over), torso

    rscene.avatar_grids = grids
    try:
        return hrender.run(ctx, seed, seconds, trace)
    finally:
        rscene.avatar_grids = avatar
