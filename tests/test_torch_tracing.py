"""The port's spans (``radnerf_tpu_torch/utils/tracing.py``) on the CPU.

Under ``torch.profiler`` one frame through ``Trainer.test_step`` (a torso
trainer on a dense head grid, so every layer of the frame runs) and two
``Trainer.step`` calls (the first with an upkeep that adapts the
capacities) open every span of the frame and the step, each inside the
span the layers nest in; with no profiler running a span is one shared
``nullcontext``, and the frame and the steps give the traced run's numbers
bit for bit. The dataset is tests/test_train.py's 64x64 one on disk."""

import contextlib
import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.data import TalkingHeadDataset
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig, make_state
from radnerf_tpu_torch.ops import _kernels
from radnerf_tpu_torch.train import Trainer
from radnerf_tpu_torch.utils import tracing

from test_torch_train import SMALL
from test_train import data_dir  # noqa: F401  (the on-disk dataset fixture)

OPT = dict(num_rays=256, exp_eye=True, iters=100, dt_gamma=0.0, update_extra_interval=2)
RC = dict(grid_size=32, max_steps=8, dt_gamma=0.0)
# span -> the span it lies in (by the nearest enclosing program span), in
# the frame and in the steps; None: outermost
FRAME = {
    "radnerf.batch": None,
    "radnerf.frame": None,
    "radnerf.sync.aabb": "radnerf.frame",
    "radnerf.render.audio": "radnerf.frame",
    "radnerf.render.march": "radnerf.frame",
    "radnerf.render.field": "radnerf.frame",
    "radnerf.sync.compact": "radnerf.render.field",
    "radnerf.render.composite": "radnerf.frame",
    "radnerf.render.torso": "radnerf.frame",
    "radnerf.sync.image": "radnerf.frame",
    "radnerf.sync.depth": "radnerf.frame",
}
STEP = {
    "radnerf.step": None,
    "radnerf.upkeep": "radnerf.step",
    "radnerf.upkeep.adapt": "radnerf.upkeep",
    "radnerf.sync.telemetry": "radnerf.upkeep.adapt",
    "radnerf.sync.occ_radius": "radnerf.upkeep.adapt",
    "radnerf.upkeep.grid": "radnerf.upkeep",
    "radnerf.sync.upload_audio": "radnerf.upkeep.grid",
    "radnerf.sync.upload_eye": "radnerf.upkeep.grid",
    "radnerf.sync.occ_bbox": "radnerf.upkeep.grid",
    "radnerf.sync.occ_sphere": "radnerf.upkeep.grid",
    "radnerf.sync.mean_density": "radnerf.upkeep.grid",
    "radnerf.batch": "radnerf.step",
    "radnerf.forward": "radnerf.step",
    "radnerf.sync.aabb": "radnerf.forward",
    "radnerf.render.audio": "radnerf.forward",
    "radnerf.render.march": "radnerf.forward",
    "radnerf.render.field": "radnerf.forward",
    "radnerf.sync.compact": "radnerf.render.field",
    "radnerf.render.composite": "radnerf.forward",
    "radnerf.backward": "radnerf.step",
    "radnerf.optimizer": "radnerf.step",
}
# the blocking read-backs of one frame
FRAME_SYNCS = {"radnerf.sync.aabb", "radnerf.sync.compact", "radnerf.sync.image",
               "radnerf.sync.depth"}


def _frame(data_dir, traced: bool):
    """One torso-stage frame of a fresh trainer on a dense head grid:
    (the numbers it gave, its program spans or None)."""
    opt = Options(path=data_dir, torso=True, **OPT)
    rc = RenderConfig(torso=True, **RC)
    tr = Trainer(opt, NetworkConfig(**SMALL, torso=True), rc, device="cpu", mute=True)
    grid = torch.full((rc.cascade, rc.grid_size**3), 20.0)
    tr.state = make_state(rc, grid, torch.zeros(rc.grid_size**2), 20.0, 0.0)
    ds = TalkingHeadDataset(opt, split="val", device="cpu")
    with _profiled(traced) as spans:
        pred, depth = tr.test_step(tr.next_batch(ds, 0))
    return {"pred": torch.from_numpy(pred), "depth": torch.from_numpy(depth)}, spans


def _steps(data_dir, traced: bool):
    """Two untraced steps of a fresh head trainer (an upkeep without
    telemetry, then a plain step), then two steps, traced or not: one whose
    upkeep adapts the capacities to the step before, one without an upkeep.
    Returns (the numbers they gave, the traced steps' program spans or None)."""
    opt = Options(path=data_dir, **OPT)
    tr = Trainer(opt, NetworkConfig(**SMALL), RenderConfig(**RC), device="cpu", mute=True)
    ds = TalkingHeadDataset(opt, split="train", device="cpu")
    order = ds.epoch_indices()
    losses = [tr.step(ds, order[0]), tr.step(ds, order[1], tr.telemetry)]
    with _profiled(traced) as spans:
        for i in (2, 3):
            losses.append(tr.step(ds, order[i], tr.telemetry))
    out = {f"loss{i}": v for i, v in enumerate(losses)}
    out.update({f"param.{k}": v.detach() for k, v in tr.net.named_parameters()})
    out.update({f"telemetry.{k}": v for k, v in tr.telemetry.items()})
    out["grid"] = tr.state.density_grid
    assert tr._adapt_count >= 1
    return out, spans


@contextlib.contextmanager
def _profiled(traced: bool):
    """Profile the block on the CPU when ``traced``; yields a list that then
    holds its program spans as (name, nearest enclosing program span)."""
    spans = []
    if not traced:
        assert not torch.autograd._profiler_enabled()
        yield None
        return
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        yield spans
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            up = e.cpu_parent
            while up is not None and not up.name.startswith(tracing.PREFIX):
                up = up.cpu_parent
            spans.append((e.name, None if up is None else up.name))


RUNS = {"frame": _frame, "step": _steps}


@pytest.fixture(scope="module")
def runs(data_dir):  # noqa: F811
    """Each run traced and untraced, on the same seed."""
    return {kind: (fn(data_dir, True), fn(data_dir, False)) for kind, fn in RUNS.items()}


@pytest.mark.parametrize("kind,name,parent",
                         [("frame", n, p) for n, p in FRAME.items()]
                         + [("step", n, p) for n, p in STEP.items()])
def test_span_lies_in_its_layer(runs, kind, name, parent):
    spans = runs[kind][0][1]
    parents = {p for n, p in spans if n == name}
    assert parents == {parent}, (name, parents)


@pytest.mark.parametrize("kind,table", [("frame", FRAME), ("step", STEP)])
def test_no_span_outside_the_table(runs, kind, table):
    assert {n for n, _ in runs[kind][0][1]} == set(table)


def test_frame_has_its_blocking_read_backs_once_each(runs):
    syncs = [n for n, _ in runs["frame"][0][1] if n.startswith(tracing.PREFIX + "sync.")]
    assert sorted(syncs) == sorted(FRAME_SYNCS)


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_untraced_run_gives_the_traced_numbers(runs, kind):
    (traced, _), (plain, spans) = runs[kind]
    assert spans is None and traced.keys() == plain.keys()
    for k in traced:
        assert torch.equal(traced[k], plain[k]), k


@pytest.mark.parametrize("fn,arg", [(tracing.span, "step"), (tracing.sync, "compact")])
def test_a_span_is_the_shared_nullcontext_with_no_profiler(fn, arg):
    assert fn(arg) is fn("other") is tracing._OFF
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]):
        assert isinstance(fn(arg), torch.profiler.record_function)


def test_a_library_load_is_a_span(monkeypatch):
    """``Kernel._load`` opens the library inside ``radnerf.kernels.load``
    (here the C library in place of a built kernel: nothing to build)."""
    path = ctypes.util.find_library("c")
    if path is None:
        pytest.skip("no C library to load")
    k = _kernels.Kernel("libc", {})
    monkeypatch.setattr(k, "library_path", lambda: _AlwaysThere(path))
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        assert isinstance(k._load(), ctypes.CDLL)
        k._load()  # loaded: no second span
    assert [e.name for e in prof.events()
            if e.name.startswith(tracing.PREFIX)] == ["radnerf.kernels.load"]


class _AlwaysThere(str):
    """A library path that ``start_build`` finds built."""

    def exists(self):
        return True
