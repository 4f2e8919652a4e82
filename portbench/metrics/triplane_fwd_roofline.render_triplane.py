"""Kernel A-tri against its roofline over the traced window: the least time
of the frame's tri-plane encodes (``reference/work_triplane.py``
``triplane_work`` of each recorded call's points: bytes over HBM bandwidth
or float32 operations over the float32 peak, whichever is larger) over the
device time of ``triplane_encode_kernel``."""

from portbench.harness.trace import kernel_seconds
from portbench.reference.ops import GridSpec
from portbench.reference.work import bound_s
from portbench.reference.work_triplane import triplane_work

KERNELS = ("triplane_encode_kernel",)


def _spec(s) -> GridSpec:
    if s.gridtype != "hash" or s.interpolation != "linear" or s.align_corners:
        raise ValueError(f"the benchmark counts ER-NeRF's linear hash planes only, not {s}")
    return GridSpec(s.input_dim, s.num_levels, s.level_dim, s.base_resolution,
                    s.log2_hashmap_size, s.per_level_scale)


def read(ctx):
    calls = (ctx.get("counts") or {}).get("triplane", [])
    t = ctx.get("trace") or {}
    dev = kernel_seconds(t, KERNELS) if t else 0.0
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(bound_s(*triplane_work(c["x"], _spec(c["spec"]), c["bound"]))
                       for c in calls) / dev
