"""Parallelism layer of the port: data parallelism over torch.distributed."""

from .mesh import (
    all_reduce_mean,
    create_mesh,
    gather_rays,
    local_device,
    pad_to_multiple,
    reduce_telemetry,
    render_frame_dp,
    replicate,
    shard_batch,
    shard_rays,
)

__all__ = ["all_reduce_mean", "create_mesh", "gather_rays", "local_device", "pad_to_multiple",
           "reduce_telemetry", "render_frame_dp", "replicate", "shard_batch", "shard_rays"]
