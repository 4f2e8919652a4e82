"""The traced window's model FLOPs over its seconds times the peak of the
configuration's precision (67 TFLOP/s float32, TF32 off; 989 TFLOP/s
bf16; one H100 SXM at 700 W): each frame's head MLPs and encodes on the
samples it marched and the torso's on every pixel (``reference/work.py``)."""

from portbench.reference.work import PEAK_FLOPS, frame_flops


def read(ctx):
    calls = (ctx.get("counts") or {}).get("samples") or []
    t = ctx.get("trace") or {}
    if not calls or not t.get("window_s"):
        return None
    flops = sum(frame_flops(ctx["arch"], s, n) for s, n, _ in calls)
    return 100.0 * flops / (t["window_s"] * PEAK_FLOPS[ctx["precision"]])
