"""CPU tests of the ER-NeRF render cell (``render512_ernerf_fp32``: traffic
kind ``render_triplane``) and of the dense RAD-NeRF render cell
(``render512_dense_fp32``: kind ``render_dense``): their files found, the
generators' tiny cells measured and traced on the CPU against the plain
reference, and the new readers on given counts.

    python -m pytest portbench/tests/test_portbench_triplane.py -q
"""

from __future__ import annotations

import argparse
import copy
import json

import pytest
import torch

from portbench import run as prun
from portbench.harness import common
from portbench.harness import render_triplane as hrt
from portbench.reference import field_triplane as ftri
from portbench.reference import work, work_triplane

BENCH = common.load_benchmark()
CELLS = ("render512_ernerf_fp32", "render512_dense_fp32")


def tiny(cell: str) -> dict:
    """The cell at 64x64: a 20-frame track, 10 frames a second, one warm-up
    frame (the second frame of a key captures on the card; on the CPU the
    segments replay eagerly), 3 traced frames, 2 compared."""
    ctx = copy.deepcopy(common.find_cell(BENCH, cell))
    ctx["traffic"].update(H=64, W=64, track_frames=20, warmup_frames=1, trace_frames=3,
                          sample_frames=2, check_within=3, window_per_s=10)
    return ctx


def measure(cell: str, trace_: int = 0, seed: int = 2**31 + 23) -> dict:
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=trace_)
    ctx = tiny(cell)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "require_cards", lambda n: None)
        mp.setattr(common, "device", lambda: torch.device("cpu"))
        mp.setattr(common, "prepare_program", lambda: None)
        mp.setattr(common, "find_cell", lambda bench, name: ctx)
        return prun.measure(args)


@pytest.mark.parametrize("cell", CELLS)
def test_the_new_cells_find_their_files(cell):
    ctx = common.find_cell(BENCH, cell)
    gen = common.generator(ctx["traffic"]["kind"])
    assert all(callable(getattr(gen, f)) for f in ("run", "check", "controls"))
    assert set(prun.load_limits(cell)) == {"frame_rmse", "frame_max_abs"}
    assert {m["name"] for m in ctx["end_to_end"]} == {"render_fps", "frame_ms_p95", "setup_s"}
    for m in ctx["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_the_dense_cell_is_render512_on_an_early_grid():
    base = json.load(open(common.BENCH / "traffic" / "render512.json"))
    dense = json.load(open(common.BENCH / "traffic" / "render512_dense.json"))
    assert {k for k in base if base[k] != dense.get(k)} == {"kind", "occupancy",
                                                           "window_per_s"}
    assert set(dense) - set(base) == {"grid_over_thresh"}
    assert dense["kind"] == "render_dense" and 1.0 < min(dense["grid_over_thresh"])


def test_the_tiny_dense_cell_marches_every_sample_and_matches_the_reference():
    """Every cell just above the threshold: each ray marches max_steps
    samples but those whose chord through the box is shorter (a few corner
    rays: 65,002 of 65,536 at 64x64), and the frames are the reference's."""
    out = measure("render512_dense_fp32", trace_=1)
    assert out["correct"], out["checks"]
    assert out["res"]["checks"]["frame_max_abs"] == 0.0
    S = json.load(open(common.BENCH / "configs" / "radnerf_fp32.json"))["render"]["max_steps"]
    for n_samples, n_rays, _ in out["res"]["counts"]["samples"]:
        assert 0.98 * n_rays * S < n_samples <= n_rays * S
    from portbench.reference import scene as rscene
    from portbench.harness import render_dense

    assert rscene.avatar_grids is not render_dense.early_grid  # put back after the run


def test_every_ernerf_configuration_key_reaches_the_program():
    from portbench.harness import program

    ctx = common.find_cell(BENCH, "render512_ernerf_fp32")
    opt, net_cfg, _ = program.configs(ctx["config"], ctx["traffic"])
    for k, v in ctx["config"]["model"].items():
        got = [getattr(o, k) for o in (opt, net_cfg) if hasattr(o, k)]
        assert got and all(g == v for g in got), (k, v, got)
    assert net_cfg.arch == "ernerf" and opt.audio_in_dim == net_cfg.audio_in_dim == 29


def test_the_tiny_ernerf_cell_matches_the_reference():
    """The same float32 ops on the CPU but for the pose inverse (the
    program's adjugate against linalg.inv: the last bits of APE's six
    numbers), which the torso grid's finest levels (U(-4, 4) tables, cells
    of 1/1024) magnify to about 1e-4 of a pixel."""
    out = measure("render512_ernerf_fp32")
    assert out["correct"], out["checks"]
    checks = out["res"]["checks"]
    assert checks["frames_compared"] == 2
    assert checks["frame_max_abs"] < 1e-3, checks
    assert set(out["metrics"]) == {"render_fps", "frame_ms_p95", "setup_s"}


def test_the_traced_ernerf_cell_reports_its_per_layer_metrics():
    out = measure("render512_ernerf_fp32", trace_=1)
    assert out["correct"], out["checks"]
    # on the CPU the trace has no device time: the device metrics are left
    # out, never 0
    assert {"batch_ms.render", "mfu.render_triplane"} <= set(out["metrics"])
    assert "triplane_fwd_roofline.render_triplane" not in out["metrics"]
    counts = out["res"]["counts"]
    assert len(counts["triplane"]) == 3 and len(counts["samples"]) == 3


def test_the_readers_on_given_counts():
    cfg = json.load(open(common.BENCH / "configs" / "ernerf_fp32.json"))
    arch = ftri.Arch(cfg["model"], torso=True)
    from radnerf_tpu_torch.models.network_triplane import triplane_spec

    x = torch.rand(2000, 3) * 2.2 - 1.1
    b, f = work_triplane.triplane_work(x, arch.plane, 1.0)
    assert b > x.numel() * 4 + 2000 * 36 * 4 and f > 0
    ctx = {"counts": {"triplane": [{"x": x, "spec": triplane_spec(1.0), "bound": 1.0}],
                      "samples": [(1000, 64, 16)]},
           "trace": {"kernel_s": {"void triplane_encode_kernel<1, false, true>(...)": 1e-3},
                     "window_s": 0.5, "busy_s": 0.1, "field_device_s": 0.006},
           "arch": arch, "precision": "float32", "frames": 3}
    roof = common.metric_reader("triplane_fwd_roofline.render_triplane")(ctx)
    assert roof == pytest.approx(100.0 * work.bound_s(b, f) / 1e-3)
    mfu = common.metric_reader("mfu.render_triplane")(ctx)
    assert mfu == pytest.approx(100.0 * work_triplane.frame_flops(arch, 1000, 64)
                                / (0.5 * 67e12))
    assert common.metric_reader("field_device_ms.render_triplane")(ctx) == pytest.approx(2.0)
    empty = {"counts": {}, "trace": {}, "frames": 3}
    for name in ("triplane_fwd_roofline.render_triplane", "mfu.render_triplane",
                 "field_device_ms.render_triplane"):
        assert common.metric_reader(name)(empty) is None


def test_the_field_range_claims_its_launches_kernels():
    """Launches inside radnerf.render.field (or a child) count their
    kernels' device time; one outside does not."""
    us = 1e6
    ev = [{"name": "radnerf.render.field", "cat": "user_annotation", "ts": 0, "dur": 100},
          {"name": "radnerf.render.field.triplane", "cat": "user_annotation", "ts": 10,
           "dur": 20},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 15, "dur": 2,
           "args": {"correlation": 1}},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 50, "dur": 2,
           "args": {"correlation": 2}},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 150, "dur": 2,
           "args": {"correlation": 3}},
          {"name": "k1", "cat": "kernel", "ts": 20, "dur": 0.5 * us, "args": {"correlation": 1}},
          {"name": "k2", "cat": "kernel", "ts": 60, "dur": 0.25 * us, "args": {"correlation": 2}},
          {"name": "k3", "cat": "kernel", "ts": 160, "dur": 9 * us, "args": {"correlation": 3}}]
    assert hrt.field_device_seconds(ev) == pytest.approx(0.75)
    assert hrt.field_device_seconds(ev[3:]) == 0.0


def test_a_radnerf_configuration_is_refused_by_the_triplane_generator():
    ctx = tiny("render512_ernerf_fp32")
    ctx["config"] = json.load(open(common.BENCH / "configs" / "radnerf_fp32.json"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "device", lambda: torch.device("cpu"))
        with pytest.raises(common.Refused):
            hrt.run(ctx, 1, 0.5, False)
