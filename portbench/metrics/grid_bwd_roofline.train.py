"""Kernel A' (or A'-bf16) against its roofline over the traced window: the
least time of the grid-gradient work its calls need (the frozen
``grid_backward_work`` of each recorded training encode's inputs) over the
device time of the kernels that implement them."""

from portbench.harness.trace import kernel_seconds
from portbench.metrics._shared import encodes_bound_s

KERNELS = ("grid_encode_bwd",)


def read(ctx):
    calls = [c for c in (ctx.get("counts") or {}).get("encodes", []) if c["grad"]]
    t = ctx.get("trace") or {}
    dev = kernel_seconds(t, KERNELS) if t else 0.0
    if not calls or dev <= 0:
        return None
    return 100.0 * encodes_bound_s(calls, backward=True) / dev
