"""The traced window's model FLOPs of ER-NeRF's frames over its seconds
times the float32 peak (67 TFLOP/s, TF32 off; one H100 SXM at 700 W): each
frame's head MLPs and tri-plane encode on the samples it marched and the
torso's MLPs and encode on every pixel (``reference/work_triplane.py``)."""

from portbench.reference.work import PEAK_FLOPS
from portbench.reference.work_triplane import frame_flops


def read(ctx):
    calls = (ctx.get("counts") or {}).get("samples") or []
    t = ctx.get("trace") or {}
    if not calls or not t.get("window_s"):
        return None
    flops = sum(frame_flops(ctx["arch"], s, n) for s, n, _ in calls)
    return 100.0 * flops / (t["window_s"] * PEAK_FLOPS[ctx["precision"]])
