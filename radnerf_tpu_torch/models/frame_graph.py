"""Captured stretches of the inference frame (``renderer._render_graphed``).

A ``Segment`` is a function of tensors whose shapes and addresses do not
change from frame to frame. On the card it is captured once as a CUDA graph
and replayed, each replay writing the same output tensors; on the CPU it is
called again at each replay and its results copied into the outputs its
first call made, so the CPU tests walk the same buffers and the same
bookkeeping as the card. A frame's segments share one memory pool and
replay in the order they were captured.

``engages(rays_o)`` says whether an inference frame takes this path.

The hand-written kernels' launch counts (``ops._kernels``) count the
host's launches: a warm-up's and a capture's, and none for a replay, whose
kernels the card runs from the graph. ``graph_stats()`` counts captures and
replays (one per segment) and the frames rendered without a graph
(``eager``); ``reset_graph_stats()`` zeroes them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.tracing import span

_STATS = {"captures": 0, "replays": 0, "eager": 0}


def graph_stats() -> dict:
    """{"captures", "replays", "eager"}: segments captured and replayed, and
    frames (training steps included) rendered eagerly, since the last reset."""
    return dict(_STATS)


def reset_graph_stats():
    for k in _STATS:
        _STATS[k] = 0


def count_eager():
    _STATS["eager"] += 1


def engages(rays_o) -> bool:
    """Whether an inference frame takes the captured path: CUDA rays,
    outside data parallelism (an initialised group of more than one rank,
    where every rank renders its shard, or the whole frame, eagerly) and
    outside another capture."""
    if not rays_o.is_cuda:
        return False
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return False
    return not torch.cuda.is_current_stream_capturing()


def can_capture(device: torch.device) -> bool:
    """Whether a frame can be captured now: on the CPU always (the
    segments run eagerly); on the card not while a profiler traces (its
    ranges cannot be captured)."""
    return device.type != "cuda" or not torch.autograd._profiler_enabled()


def warm_up(device: torch.device, fn):
    """Run ``fn`` once on a side stream before a capture, as PyTorch asks
    (lazy initialisations, cuBLAS workspaces); nothing on the CPU."""
    if device.type != "cuda":
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


class Segment:
    """``fn`` (no arguments -> dict of tensors) captured on ``device``:
    ``outputs`` are the tensors every ``replay`` writes."""

    def __init__(self, name: str, fn, device: torch.device, pool=None):
        self.name, self.fn, self.graph = name, fn, None
        if device.type == "cuda":
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.outputs = fn()
        else:
            self.outputs = fn()
        _STATS["captures"] += 1

    def replay(self):
        with span("render.graph." + self.name):
            if self.graph is not None:
                self.graph.replay()
            else:
                for k, v in self.fn().items():
                    self.outputs[k].copy_(v)
        _STATS["replays"] += 1
