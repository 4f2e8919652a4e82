"""The traced window's model FLOPs over its seconds times the peak of the
configuration's precision (67 TFLOP/s float32, TF32 off; 989 TFLOP/s
bf16; one H100 SXM at 700 W): each step's MLPs forward and backward and
grid encodes on the samples it marched, and each upkeep's density queries
(``reference/work.py``)."""

from portbench.reference.work import PEAK_FLOPS, density_flops, step_flops


def read(ctx):
    counts, t = ctx.get("counts") or {}, ctx.get("trace") or {}
    calls = counts.get("samples") or []
    if not calls or not t.get("window_s"):
        return None
    arch = ctx["arch"]
    flops = sum(step_flops(arch, s) for s, _, _ in calls)
    upkeep = [c for c in counts.get("encodes", []) if not c["grad"]
              and c["spec"].input_dim == 3]
    flops += sum(density_flops(arch, c["x"].shape[0]) for c in upkeep)
    return 100.0 * flops / (t["window_s"] * PEAK_FLOPS[ctx["precision"]])
