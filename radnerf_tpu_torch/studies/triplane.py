"""Kernel A-tri (ER-NeRF's tri-plane encode, one launch) in turns against
what it replaces: three kernel A launches on the planes' slices of the
points and their concatenation, on the points of the ER-NeRF bench frame
(``scene.build_scene(arch="ernerf")``: 512x512, the avatar occupancy at
128^3, 16 samples a ray), on the card:

    python3 -m radnerf_tpu_torch.studies.triplane <out.json>

Each side is timed by ``chip_smoke.device_ms`` (20 calls queued behind a
sleep kernel: the card alone) in the order A-tri, three A + cat, three A
alone (the points already sliced), then back; A-tri is held bit for bit to
both the three launches and the plain twin. Its bound is
``chip_smoke.triplane_work``'s: the larger of its bytes over HBM bandwidth
and its float32 operations over the peak (the points read once, the
[N, 36] features written once, each distinct table row its in-box points
touch read once; the three 2-D encodes' operations).
The frame's device ms by kernel (a 3-frame profile) go beside them."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from radnerf_tpu_torch.ops.triplane_encode import PLANES


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("triplane study: no CUDA device", file=sys.stderr)
        sys.exit(1)
    out_json = Path(argv[0])
    out_json.parent.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as S

    import radnerf_tpu_torch.models.network_triplane as tri
    from radnerf_tpu_torch.main import float32_matmuls
    from radnerf_tpu_torch.models import render_rays
    from radnerf_tpu_torch.ops import _kernels, grid_encode, triplane_encode, \
        triplane_encode_plain
    from radnerf_tpu_torch.scene import build_scene

    float32_matmuls()
    logs = _kernels.build_all()
    result = {"nvidia_smi": S.nvidia_smi_line(),
              "ptxas": [line.strip() for line in logs["grid_encode"].splitlines()
                        if "registers" in line or "triplane" in line]}
    net, rc, state, b, auds = build_scene(512, 512, device="cuda", arch="ernerf")
    calls = []
    enc0 = tri.triplane_encode

    def record(x, tables, spec, bound=1.0):
        calls.append(x.detach().clone())
        return enc0(x, tables, spec, bound)

    def frame(i):
        return render_rays(net, rc, state, b["rays_o"], b["rays_d"], auds[i % auds.shape[0]],
                           b["bg_coords"], b["poses"], b["eye"], 0, b["bg_color"],
                           poses_matrix=b["poses_matrix"])

    tri.triplane_encode = record
    try:
        with torch.no_grad():
            frame(0)
    finally:
        tri.triplane_encode = enc0
    x = calls[0]
    tables = [t.detach() for t in (net.encoder_xy, net.encoder_yz, net.encoder_xz)]
    spec, bound = net.plane_spec, net.cfg.bound
    sliced = [x[:, list(d)].contiguous() for d in PLANES]

    def a_tri():
        return triplane_encode(x, tables, spec, bound)

    def three_a_cat():
        return torch.cat([grid_encode(x[:, list(d)], t, spec, bound)
                          for d, t in zip(PLANES, tables)], dim=-1)

    def three_a():
        return [grid_encode(s, t, spec, bound) for s, t in zip(sliced, tables)]

    _kernels.reset_launches()
    got = a_tri()
    result["a_tri_launches"] = _kernels.launches()["triplane_encode"]
    result["bit_for_bit"] = {"three_a_cat": bool(torch.equal(got, three_a_cat())),
                             "plain_twin": bool(torch.equal(
                                 got, triplane_encode_plain(x, tables, spec, bound)))}
    sides = {"a_tri": a_tri, "three_a_cat": three_a_cat, "three_a": three_a}
    order = list(sides) + list(sides)[::-1]
    turns = {k: [] for k in sides}
    for k in order:
        turns[k].append(S.device_ms(sides[k], 20))
    n_bytes, n_flops = S.triplane_work(x, spec, bound)
    bound_ms, by = S.bound_ms(n_bytes, n_flops)
    a_ms = float(np.mean(turns["a_tri"]))
    result.update(points=int(x.shape[0]), device_ms_in_turns=turns, bytes=n_bytes,
                  flops=n_flops, bound_ms=bound_ms, bound_by=by,
                  roofline_share=100.0 * bound_ms / a_ms,
                  speedup_vs_three_a_cat=float(np.mean(turns["three_a_cat"])) / a_ms)
    with torch.no_grad():
        for i in range(4):  # past the capture
            frame(i)
        _, events = S.device_profile(frame, 3)
    result["frame_device_ms_by_kernel"] = [[e.key[:120], e.self_device_time_total / 3e3]
                                           for e in events[:15]]
    result["frame_device_ms_by_class"] = S.ms_by_class(events, 3)
    out_json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
