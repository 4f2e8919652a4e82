"""The traced window: torch.profiler over a fixed run of frames or steps,
read back from its Chrome trace into device intervals, kernel times by
name, the benchmark's own host spans, and idle gaps named by what the host
was doing."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")
# the longest idle gaps named by the host op around them; the rest are summed
N_NAMED_GAPS = 4000


def span(name: str):
    """A host range the trace keeps (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block; on exit ``out`` holds the parsed trace
    (``summarise``) and the block's host seconds."""
    import torch

    act = torch.profiler.ProfilerActivity
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    prof = torch.profiler.profile(activities=[act.CPU, act.CUDA] if cuda else [act.CPU])
    prof.__enter__()
    t0 = time.perf_counter()
    try:
        with span("portbench.window"):
            yield
            sync()
        out["window_s"] = time.perf_counter() - t0
    finally:
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.update(summarise(events))


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarise(events: list, n_top: int = 10) -> dict:
    """From Chrome-trace events (microseconds): the device's busy seconds
    inside the window annotation, kernel seconds by name, the host spans of
    the benchmark (``portbench.*``) by name, the top device operations and
    the longest idle gaps by what the host was doing."""
    win = [e for e in events if e.get("name") == "portbench.window"
           and e.get("cat", "").lower() == "user_annotation"]
    w0 = min(e["ts"] for e in win) if win else min(e.get("ts", 0) for e in events if "ts" in e)
    w1 = max(e["ts"] + e["dur"] for e in win) if win else max(
        e.get("ts", 0) + e.get("dur", 0) for e in events)
    dev, host, spans = [], [], defaultdict(list)
    by_name = defaultdict(float)
    for e in events:
        cat = e.get("cat", "").lower()
        if "dur" not in e or "ts" not in e:
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                by_name[e["name"]] += (t - s) * 1e-6
        elif cat == "user_annotation" and e["name"].startswith("portbench."):
            spans[e["name"]].append(float(e["dur"]) * 1e-6)
            if e["name"] != "portbench.window":
                host.append((s, t, e["name"], 0))
        elif cat == "cpu_op":
            host.append((s, t, e["name"], 1))
    busy = _union(dev)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    named = defaultdict(float)
    starts = np.array([h[0] for h in host])
    ends = np.array([h[1] for h in host])
    lengths = ends - starts
    gaps.sort(key=lambda g: g[0] - g[1])
    for g0, g1 in gaps[:N_NAMED_GAPS]:
        mid = 0.5 * (g0 + g1)
        around = np.nonzero((starts <= mid) & (ends > mid))[0] if len(host) else []
        span_names = [host[i][2] for i in around if host[i][3] == 0]
        ops = sorted((i for i in around if host[i][3] == 1), key=lambda i: lengths[i])
        parts = span_names[-1:] + ([host[ops[0]][2]] if ops else [])
        named["/".join(parts) or "host"] += (g1 - g0) * 1e-6
    rest = sum(g1 - g0 for g0, g1 in gaps[N_NAMED_GAPS:]) * 1e-6
    if rest > 0:
        named["shorter gaps"] += rest
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:n_top]
    return {"busy_s": busy_s, "traced_s": (w1 - w0) * 1e-6, "kernel_s": dict(by_name),
            "spans": dict(spans),
            "breakdown": {"device_ops": [[n[:160], v] for n, v in top],
                          "idle_gaps": [[n[:160], v] for n, v in idle]}}


def kernel_seconds(trace: dict, needles) -> float:
    """Device seconds of the kernels whose names hold one of ``needles``."""
    return sum(v for k, v in trace["kernel_s"].items() if any(n in k for n in needles))
