"""Arithmetic the metric readers share: the program's grid spec as the
reference's, and the work of the recorded encodes."""

from __future__ import annotations

from portbench.reference.ops import GridSpec
from portbench.reference.work import bound_s, grid_backward_work, grid_work


def spec_of(program_spec) -> GridSpec:
    """The reference's spec of a program grid (tiled, linear, not aligned)."""
    s = program_spec
    if s.gridtype != "tiled" or s.interpolation != "linear" or s.align_corners:
        raise ValueError(f"the benchmark counts tiled linear grids only, not {s}")
    return GridSpec(s.input_dim, s.num_levels, s.level_dim, s.base_resolution,
                    s.log2_hashmap_size, s.per_level_scale)


def encodes_bound_s(calls, backward: bool) -> float:
    """The least seconds the card could take for these recorded encodes (or
    their backward passes): bytes over HBM bandwidth or float32 operations
    over the float32 peak, whichever is larger, summed over the calls."""
    total = 0.0
    for c in calls:
        spec, elem = spec_of(c["spec"]), 2 if c["bf16"] else 4
        if backward:
            b, f = grid_backward_work(c["x"], spec, c["bound"], c["need_x"], elem)
        else:
            b, f = grid_work(c["x"], spec, c["bound"], elem)
        total += bound_s(b, f, "float32")
    return total


def idle_share(ctx):
    t = ctx.get("trace") or {}
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def batch_ms(ctx):
    spans = (ctx.get("trace") or {}).get("spans", {}).get("portbench.batch")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
