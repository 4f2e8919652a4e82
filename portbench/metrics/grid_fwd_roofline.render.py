"""Kernel A (or A-bf16 with its packing pass) against its roofline over
the traced window: the least time of the frame's three encodes (the
frozen ``grid_work`` of each recorded call's inputs) over the device time
of the kernels that implement them."""

from portbench.harness.trace import kernel_seconds
from portbench.metrics._shared import encodes_bound_s

KERNELS = ("grid_encode_kernel", "pack_kernel")


def read(ctx):
    calls = (ctx.get("counts") or {}).get("encodes", [])
    t = ctx.get("trace") or {}
    dev = kernel_seconds(t, KERNELS) if t else 0.0
    if not calls or dev <= 0:
        return None
    return 100.0 * encodes_bound_s(calls, backward=False) / dev
