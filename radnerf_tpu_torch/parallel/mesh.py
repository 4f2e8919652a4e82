"""Data parallelism over ``torch.distributed`` (counterpart of
``radnerf_tpu/parallel/mesh.py``; the reference's dormant DDP surface,
nerf/utils.py:621-623).

The JAX package replicates the parameters and the renderer state over a
device mesh, shards each ray batch over its ``dp`` axis and lets XLA insert
the gradient psum. Here the mesh is the world of the initialised default
process group, one rank per process:

- the network and the renderer state are broadcast from rank 0 once
  (``replicate``), and every rank then evolves them identically;
- every rank draws the same global batch and keeps its contiguous
  ``1/world_size`` of the rays (``shard_rays``, ``shard_batch``);
- after ``backward`` the gradients are averaged over the ranks with one
  ``all_reduce`` (``all_reduce_mean``): with equal shards the mean of the
  per-rank mean losses is the global mean loss, so every rank takes the step
  the one-rank trainer takes on the whole batch;
- a frame renders each rank's rays with no collective inside the render and
  gathers image and depth to every rank in ray order (``render_frame_dp``).

The gather is a sum ``all_reduce`` into a zeroed full-size buffer in which
each rank has written its own rows: gloo takes ``all_reduce`` and
``broadcast`` on CUDA tensors but not ``all_gather``, and the sum works on
NCCL and gloo, on the CPU and on the card, without a copy to the host.

The caller starts the process group (``torchrun``, or its own spawned
ranks) and picks the backend: NCCL where each rank has its own card, gloo
on the CPU or for ranks that share one card. Nothing here starts a group,
and nothing catches a collective's failure to go on alone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

World = Tuple[int, int]  # (rank, world_size)

# the per-ray arrays of a training batch (JAX mesh.py:49-50)
_RAY_KEYS = ("rays_o", "rays_d", "bg_coords", "bg_color", "images",
             "face_mask", "bg_torso_color")
# telemetry reduced by max over the ranks; every other n_* count is summed
_TELEMETRY_MAX = ("n_k_span", "n_max_count", "n_group_max")


def create_mesh() -> Optional[World]:
    """(rank, world_size) of the initialised default process group; None
    when no group is up or it has one rank (JAX's ``mesh is None``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    return None if n == 1 else (dist.get_rank(), n)


def local_device(device="cuda") -> torch.device:
    """A rank's device: a bare ``"cuda"`` becomes ``cuda:<LOCAL_RANK>``
    (torchrun's variable, 0 without it); any other device as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _tensors(obj):
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate(obj):
    """Broadcast every tensor of ``obj`` (a tensor, a module's parameters and
    buffers, a dataclass, dict, list or tuple of them) from rank 0 in place;
    returns ``obj``. Bool tensors travel as uint8 (gloo has no bool)."""
    for t in _tensors(obj):
        if t.dtype == torch.bool:
            u = t.to(torch.uint8)
            dist.broadcast(u, src=0)
            t.copy_(u.bool())
        else:
            dist.broadcast(t.data, src=0)
    return obj


def shard_rays(t: torch.Tensor, world: Optional[World] = None) -> torch.Tensor:
    """This rank's contiguous ``1/world_size`` slice of the leading (ray)
    axis; the ray count must divide the world (pad with
    ``pad_to_multiple``)."""
    rank, n = world or create_mesh()
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rays do not divide a world of {n}")
    k = t.shape[0] // n
    return t[rank * k:(rank + 1) * k]


def shard_batch(batch: dict, world: Optional[World] = None) -> dict:
    """The batch with its per-ray arrays (``_RAY_KEYS``) sharded and every
    other key as it is (the audio window, pose, eye and index are shared);
    a ray array whose length does not divide the world stays whole (JAX
    mesh.py:53-71)."""
    world = world or create_mesh()
    n = world[1]
    return {k: shard_rays(v, world)
            if (k in _RAY_KEYS and v is not None and hasattr(v, "shape") and len(v.shape) >= 1
                and v.shape[0] % n == 0) else v
            for k, v in batch.items()}


def pad_to_multiple(a: np.ndarray, multiple: int, axis: int = 0, value=0):
    """Pad an array so axis length is divisible by ``multiple``; returns
    (the padded array, the original length)."""
    n = a.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return a, n
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, rem)
    return np.pad(a, pad, constant_values=value), n


def all_reduce_mean(tensors, world: Optional[World] = None):
    """Replace each tensor by its mean over the ranks, one ``all_reduce``
    per dtype over a flat buffer; None entries are skipped (every rank must
    pass the same list)."""
    n = (world or create_mesh())[1]
    by_dtype = {}
    for t in tensors:
        if t is not None:
            by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def reduce_telemetry(results: dict) -> dict:
    """The ``n_*`` telemetry of a render over the whole world: counts
    summed, maxima (``n_k_span``, ``n_max_count``, ``n_group_max``) the max
    over the ranks; other keys as they are."""
    keys = sorted(k for k in results if k.startswith("n_"))
    out = dict(results)
    for op, names in ((dist.ReduceOp.SUM, [k for k in keys if k not in _TELEMETRY_MAX]),
                      (dist.ReduceOp.MAX, [k for k in keys if k in _TELEMETRY_MAX])):
        if not names:
            continue
        buf = torch.stack([results[k].to(torch.int64).reshape(()) for k in names])
        dist.all_reduce(buf, op=op)
        for k, v in zip(names, buf):
            out[k] = v.to(results[k].dtype)
    return out


def gather_rays(local: torch.Tensor, n_total: int, world: Optional[World] = None
                ) -> torch.Tensor:
    """Every rank's contiguous ray shard joined in ray order on every rank:
    each rank writes its rows into a zeroed [n_total, ...] buffer and a sum
    ``all_reduce`` fills the rest (gloo has no ``all_gather`` on CUDA)."""
    rank, _ = world or create_mesh()
    k = local.shape[0]
    buf = local.new_zeros((n_total, *local.shape[1:]))
    buf[rank * k:(rank + 1) * k] = local
    dist.all_reduce(buf)
    return buf


@torch.no_grad()
def render_frame_dp(net, render_cfg, state, batch: dict, world: Optional[World] = None):
    """One frame's rays rendered across the world (JAX
    ``make_render_frame_dp``): each rank runs ``render_rays(training=False)``
    on its ray shard with no collective inside the render, then image [N, 3]
    and depth [N] are gathered to every rank in ray order and the telemetry
    reduced. The ray count must divide the world (pad the rays with
    ``pad_to_multiple``). The state the render leaves (the audio code's EMA)
    evolves identically on every rank from the same inputs.

    Returns ({"image", "depth", n_* telemetry}, the state)."""
    from ..models import render_rays

    world = world or create_mesh()
    n = batch["rays_o"].shape[0]
    local = shard_batch(batch, world)
    if local["rays_o"].shape[0] * world[1] != n:
        raise ValueError(f"{n} rays do not divide a world of {world[1]}")
    results, state = render_rays(
        net, render_cfg, state, local["rays_o"], local["rays_d"], local.get("auds"),
        local["bg_coords"], local["poses"], local.get("eye"), local["index"],
        local["bg_color"])
    out = reduce_telemetry({k: v for k, v in results.items() if k.startswith("n_")})
    out["image"] = gather_rays(results["image"], n, world)
    out["depth"] = gather_rays(results["depth"], n, world)
    return out, state
