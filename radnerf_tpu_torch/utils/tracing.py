"""Named host ranges of the frame and the step on the profiler's timeline.

``span(name)`` marks a layer of the frame or the step as the range
``radnerf.<name>``; ``sync(site)`` marks a statement that blocks the host
on the device as ``radnerf.sync.<site>``. A running ``torch.profiler`` is the
switch: inside one each is a ``torch.profiler.record_function``, on the same
clock as the kernels and copies it traces, so every gap of the device can be
put down to what the host was doing; outside one each is one shared
``nullcontext`` (about half a microsecond). Nothing else turns them on.

    with torch.profiler.profile(activities=[...]) as prof:
        trainer.test_step(batch)     # radnerf.frame, radnerf.render.*, ...
    prof.export_chrome_trace("frame.json")
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "radnerf."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The range ``radnerf.<name>`` while a profiler runs, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def sync(site: str):
    """The range ``radnerf.sync.<site>`` around a blocking read-back."""
    return span("sync." + site)
