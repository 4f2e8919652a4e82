"""Device ms a frame of the kernels and copies launched inside the
program's ``radnerf.render.field`` range and its children (A-tri, the
attention MLPs and density head, the colour MLP, the compaction's gathers
and scatters), each tied to its launch through the trace's correlation id
(``harness/render_triplane.py`` ``field_device_seconds``)."""


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("field_device_s") or not ctx.get("frames"):
        return None
    return 1e3 * t["field_device_s"] / ctx["frames"]
