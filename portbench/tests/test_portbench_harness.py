"""CPU tests of the benchmark's own arithmetic, discovery and result line,
and of its reference against the program's plain path at 64x64.

    python -m pytest portbench/tests -q

Tests marked ``cuda`` need the card and skip here; whether there is one is
decided inside a fixture."""

from __future__ import annotations

import argparse
import copy
import json
import sys

import pytest
import torch

from portbench import run as prun
from portbench.harness import common, program, trace
from portbench.reference import field as fld
from portbench.reference import work

BENCH = common.load_benchmark()
# cells whose files are kept but which BENCHMARK.json does not run
UNLISTED = {"render512_O": {"name": "render512_O", "config": "radnerf_O", "traffic": "render512",
                            "chips": 1},
            "train_head_O": {"name": "train_head_O", "config": "radnerf_O", "traffic": "train_head",
                             "chips": 1}}
O_CONFIG = {"name": "radnerf_O", "file": "portbench/configs/radnerf_O.json"}


def tiny(cell: str) -> dict:
    """The cell at 64x64 (render: a 20-frame track, 10 frames a second;
    train: 4 frames, 512 rays a step, an upkeep every 3 steps, the window
    opening on the third upkeep), small enough for the CPU."""
    bench = BENCH
    if cell in UNLISTED and all(w["name"] != cell for w in BENCH["workloads"]):
        bench = dict(BENCH, workloads=BENCH["workloads"] + [UNLISTED[cell]])
        if all(c["name"] != O_CONFIG["name"] for c in bench["configs"]):
            bench["configs"] = bench["configs"] + [O_CONFIG]
    ctx = copy.deepcopy(common.find_cell(bench, cell))
    t = ctx["traffic"]
    if t["kind"] == "render":
        t.update(H=64, W=64, track_frames=20, warmup_frames=1, trace_frames=3, sample_frames=2,
                 check_within=3, window_per_s=10)
    else:
        t.update(H=64, W=64, frames=4, warmup_steps=6, trace_steps=3, window_per_s=10)
        t["options"]["num_rays"] = 512
        ctx["config"]["train"]["update_extra_interval"] = 3
    return ctx


def on_the_cpu(mp, ctx=None):
    """A run's set-up with the card check, the device and the kernel build
    put aside (and the cell's context given)."""
    mp.setattr(common, "require_cards", lambda n: None)
    mp.setattr(common, "device", lambda: torch.device("cpu"))
    mp.setattr(common, "prepare_program", lambda: None)
    if ctx is not None:
        mp.setattr(common, "find_cell", lambda bench, name: ctx)


def measure(cell: str, trace_: int = 0, seed: int = 2**31 + 11) -> dict:
    """``run.measure`` of the tiny cell on the CPU."""
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=trace_)
    ctx = tiny(cell)
    with pytest.MonkeyPatch.context() as mp:
        on_the_cpu(mp, ctx)
        return prun.measure(args)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# ---------------------------------------------------------------- arithmetic
def test_percentile_is_over_every_value():
    values = list(range(1, 101))
    assert common.percentile(values, 95) == pytest.approx(95.05)
    assert common.percentile([3.0], 95) == 3.0
    assert common.percentile([1.0, 2.0], 50) == 1.5


def test_idle_share_and_gaps_from_synthetic_intervals():
    us = 1e6
    ev = [{"name": "portbench.window", "cat": "user_annotation", "ts": 0, "dur": 1.0 * us},
          {"name": "k1", "cat": "kernel", "ts": 0.1 * us, "dur": 0.2 * us},
          {"name": "k2", "cat": "kernel", "ts": 0.2 * us, "dur": 0.2 * us},
          {"name": "k1", "cat": "kernel", "ts": 0.8 * us, "dur": 0.1 * us},
          {"name": "portbench.batch", "cat": "user_annotation", "ts": 0.45 * us,
           "dur": 0.3 * us},
          {"name": "aten::nonzero", "cat": "cpu_op", "ts": 0.5 * us, "dur": 0.2 * us}]
    s = trace.summarise(ev)
    assert s["busy_s"] == pytest.approx(0.4)
    assert s["kernel_s"]["k1"] == pytest.approx(0.3)
    assert s["breakdown"]["idle_gaps"][0] == ["portbench.batch/aten::nonzero",
                                              pytest.approx(0.4)]
    ctx = {"trace": dict(s, window_s=1.0)}
    reader = common.metric_reader("device_idle_share.render")
    assert reader(ctx) == pytest.approx(60.0)
    assert common.metric_reader("batch_ms.render")(ctx) == pytest.approx(300.0)


def test_roofline_and_mfu_from_given_counts():
    arch = fld.Arch(json.load(open(common.BENCH / "configs" / "radnerf_fp32.json"))["model"],
                    torso=True)
    x = torch.rand(1000, 3) * 2 - 1
    b, f = work.grid_work(x, arch.grid, 1.0)
    want = 100.0 * work.bound_s(b, f) / 2e-3

    class Spec:
        gridtype, interpolation, align_corners = "tiled", "linear", False
        input_dim, num_levels, level_dim = 3, 16, 2
        base_resolution, log2_hashmap_size = 16, 16
        per_level_scale = arch.grid.per_level_scale

    ctx = {"counts": {"encodes": [{"x": x, "spec": Spec, "bound": 1.0, "bf16": False,
                                   "need_x": False, "grad": False}],
                      "samples": [(1000, 64, 16)]},
           "trace": {"kernel_s": {"void grid_encode_kernel<3, 2>(...)": 2e-3,
                                  "void grid_encode_bwd_kernel<3, 2>(...)": 9.0},
                     "window_s": 0.5, "busy_s": 0.1},
           "arch": arch, "precision": "float32"}
    assert common.metric_reader("grid_fwd_roofline.render")(ctx) == pytest.approx(want)
    mfu = common.metric_reader("mfu.render")(ctx)
    assert mfu == pytest.approx(100.0 * work.frame_flops(arch, 1000, 64) / (0.5 * 67e12))
    assert common.metric_reader("slot_fill.train")(ctx) == pytest.approx(100.0 * 1000 / 1024)
    # a reader with nothing to read returns nothing, never 0
    assert common.metric_reader("grid_bwd_roofline.train")(ctx) is None
    assert common.metric_reader("batch_ms.train")({"trace": {}}) is None


# ---------------------------------------------------------------- discovery
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    ctx = common.find_cell(BENCH, cell)
    gen = common.generator(ctx["traffic"]["kind"])
    assert all(callable(getattr(gen, f)) for f in ("run", "check", "controls"))
    assert ctx["config"]["name"] == ctx["cell"]["config"]
    assert set(prun.load_limits(cell))
    names = {m["name"] for m in ctx["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert ctx["per_layer"]
    for m in ctx["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_an_unknown_traffic_kind_is_refused():
    with pytest.raises(common.Refused):
        common.generator("live")


@pytest.mark.parametrize("section", ["model", "render", "train"])
def test_every_configuration_key_reaches_the_program(section):
    """Each key of a section sets the field of its name; one that names no
    field is refused."""
    ctx = common.find_cell(BENCH, "train_head_fp32")
    cfg = copy.deepcopy(ctx["config"])
    opt, net_cfg, render_cfg = program.configs(cfg, ctx["traffic"])
    for k, v in cfg[section].items():
        got = [getattr(o, k) for o in (opt, net_cfg, render_cfg) if hasattr(o, k)]
        assert got and all(g == v for g in got), (k, v, got)
    cfg[section]["no_such_width"] = 1
    with pytest.raises(common.Refused):
        program.configs(cfg, ctx["traffic"])


def test_the_window_is_a_fixed_amount_of_work():
    t = {"window_per_s": 45}
    assert common.window_count(t, 10, 3) == 450
    assert common.window_count(t, 0.01, 3) == 3


def test_result_line_meets_the_contract():
    line = common.result_line(True, 10, 0, {"render_fps": {"value": 1.5, "unit": "frames/s"}},
                              {"platform": "gpu", "kind": "x", "count": 1,
                               "memory_peak_bytes": 5}, [("frame_rmse", 1e-6, 1e-4)],
                              {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["frame_rmse"] == {"value": 1e-6, "limit": 1e-4}


@pytest.mark.parametrize("name,banned", [("jax.numpy", True), ("radnerf_tpu.ops", True),
                                         ("jaxlib", True), ("flax.linen", True),
                                         ("radnerf_tpu_torch", False),
                                         ("radnerf_tpu_torch.ops", False), ("jaxtyping", False)])
def test_jax_import_check(monkeypatch, name, banned):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in common.banned_modules()) == banned


def test_no_card_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(common.Refused):
        common.require_cards(1)


# ---------------------------------------------------------------- the reference
@pytest.mark.parametrize("cell", ["render512_fp32", "render512_O"])
def test_frozen_reference_matches_the_plain_render_path(cell):
    out = measure(cell)
    assert out["correct"], out["checks"]
    if cell == "render512_fp32":  # the same float32 ops on the CPU
        assert out["res"]["checks"]["frame_max_abs"] == 0.0


@pytest.mark.parametrize("cell", ["train_head_fp32", "train_head_O"])
def test_frozen_reference_matches_the_plain_training_path(cell):
    """Both stretches: the first steps from the seed, and the window's first
    steps (an upkeep with an adaptation) from the snapshot."""
    out = measure(cell)
    assert out["correct"], out["checks"]
    checks = out["res"]["checks"]
    assert checks["caps_window"] == list(out["res"]["caps_after_upkeep"])
    if cell == "train_head_fp32":
        assert checks["loss_rel"] == 0.0 and checks["window.loss_rel"] == 0.0


def test_traced_run_reports_the_per_layer_metrics():
    out = measure("train_head_fp32", trace_=1)
    assert {"batch_ms.train", "slot_fill.train", "mfu.train"} <= set(out["metrics"])
