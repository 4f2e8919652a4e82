"""The port's adaptive capacities (``radnerf_tpu_torch/train/capacity.py``
and the trainer's use of it) against the JAX package's, on the CPU.

``adapt_render_config`` equals JAX's on every case, in all seven fields. The
trainers: tests/test_train.py's 64x64 on-disk dataset, tests/test_torch_train.py's
narrow model (grid 32, max_steps 8), both at their default capacities with
``auto_capacity`` on, 3 epochs of 4 steps with an upkeep every 2 steps, so
that the upkeeps at steps 2, 6 and 10 adapt from the step before. Each upkeep
installs the same blob grid on both sides, shrinking from upkeep to upkeep
(the grid upkeep itself is held to JAX's in tests/test_torch_train.py), and
the port's march takes JAX's noises: then both see the same samples, and the
capacities, losses and telemetry of the two loops can be compared step by
step. JAX's trainer recompiles its step at each adaptation, so there is one
JAX run, shared by the tests that read it."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.data import TalkingHeadDataset as JTalkingHeadDataset
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import init_params
from radnerf_tpu.train import Trainer as JTrainer
from radnerf_tpu.train.capacity import adapt_render_config as j_adapt_render_config

from radnerf_tpu_torch import main as port_main
from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import load_jax_params, state_from_numpy
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig, render_rays
from radnerf_tpu_torch.train import Trainer, load_checkpoint

from test_torch_main import small  # noqa: F401  (the narrow model through the CLI)
from test_torch_train import GRID, SMALL, _blob_state_j
from test_train import _blob_grid, data_dir  # noqa: F401  (the on-disk dataset fixture)

FIELDS = ("ray_capacity_frac", "sample_capacity_mult", "march_iters", "sample_slots",
          "torso_capacity_frac", "march_group_mult", "march_group_slots")
TELEMETRY = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span", "n_groups_needed",
             "n_group_max")
OPT = dict(num_rays=512, exp_eye=True, iters=100, dt_gamma=0.0, update_extra_interval=2)
RC = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0)
EPOCHS = 3
# the blob each upkeep installs (radius in the unit box): the scene shrinks,
# so capacities sized from a step before an upkeep cover the steps after it
RADII = (0.6, 0.6, 0.35, 0.35, 0.15, 0.15)


def _caps(rc) -> tuple:
    return tuple(getattr(rc, f) for f in FIELDS)


# ------------------------------------------------------ adapt_render_config
BASE = dict(grid_size=128, max_steps=16, dt_gamma=0.0, ray_capacity_frac=0.5,
            sample_capacity_mult=2.0, march_iters=32, sample_slots=8)
GROUP = dict(BASE, march_group=True, march_group_mult=2.0)
# name -> (RenderConfig fields, (n_hit, n_needed, n_max, n_rays, occ_radius), keywords)
CASES = {
    "ray-frac-grows": (BASE, (600, 1000, 4, 1024, 0.7), {}),
    "ray-frac-shrinks": (dict(BASE, ray_capacity_frac=1.0, sample_capacity_mult=8.0),
                         (64, 128, 4, 1024, 0.7), {}),
    "ray-frac-holds-in-band": (BASE, (220, 1000, 4, 1024, 0.7), {"n_k_span": 30}),
    "mult-grows": (BASE, (300, 2000, 6, 1024, 0.7), {"n_k_span": 30}),
    "mult-shrinks-past-half-step": (dict(BASE, sample_capacity_mult=6.0),
                                    (300, 600, 6, 1024, 0.7), {"n_k_span": 30}),
    "mult-holds-within-half-step": (dict(BASE, sample_capacity_mult=2.25),
                                    (300, 800, 6, 1024, 0.7), {"n_k_span": 30}),
    "k-grows": (BASE, (1000, 2000, 4, 4096, 0.7), {"n_k_span": 45}),
    "k-shrinks": (BASE, (1000, 2000, 4, 4096, 0.7), {"n_k_span": 5}),
    "k-holds-in-band": (BASE, (1000, 2000, 4, 4096, 0.7), {"n_k_span": 20}),
    "k-sphere-fallback": (BASE, (1000, 2000, 4, 4096, 1.0), {}),
    "k-zero-span-fallback": (BASE, (1000, 2000, 4, 4096, 0.8), {"n_k_span": 0}),
    "k-from-none": (dict(BASE, march_iters=None), (1000, 2000, 4, 4096, 0.7),
                    {"n_k_span": 40}),
    "k-capped-at-full": (dict(BASE, march_iters=None), (1000, 2000, 4, 4096, 0.7),
                         {"n_k_span": 500}),
    "k-general-orbit": (dict(BASE, bound=2.0, max_steps=128, dt_gamma=1 / 256,
                             march_iters=None, sample_slots=None),
                        (3000, 9000, 40, 4096, 1.4), {}),
    "slots-grow-when-saturated": (BASE, (1000, 2000, 9, 4096, 0.7), {"n_k_span": 30}),
    "slots-capped-at-max-steps": (dict(BASE, sample_slots=16), (1000, 2000, 16, 4096, 0.7),
                                  {"n_k_span": 30}),
    "slots-shrink": (dict(BASE, sample_slots=16), (1000, 2000, 5, 4096, 0.7),
                     {"n_k_span": 30}),
    "slots-hold": (BASE, (1000, 2000, 5, 4096, 0.7), {"n_k_span": 30}),
    "slots-from-none": (dict(BASE, sample_slots=None), (1000, 2000, 2, 4096, 0.7),
                        {"n_k_span": 30}),
    "no-change": (dict(BASE, ray_capacity_frac=0.375, sample_capacity_mult=2.25),
                  (1000, 2000, 5, 4096, 0.7), {"n_k_span": 30}),
    "fresh": (dict(BASE, march_iters=None, sample_slots=None),
              (1000, 2000, 3, 4096, 0.7), {"n_k_span": 27, "fresh": True}),
    "fresh-bench-headroom": (dict(BASE, ray_capacity_frac=1.0, sample_capacity_mult=4.0,
                                  march_iters=None, sample_slots=None),
                             (90_000, 250_000, 3, 262_144, 0.5),
                             {"n_k_span": 28, "headroom": 1.1, "fresh": True}),
    "fresh-no-change-is-none": (dict(BASE, ray_capacity_frac=0.375,
                                     sample_capacity_mult=0.9375, march_iters=28,
                                     sample_slots=4),
                                (1000, 1300, 3, 4096, 0.7),
                                {"n_k_span": 26, "headroom": 1.1, "fresh": True}),
    "group-fresh": (GROUP, (1000, 2000, 4, 4096, 0.7),
                    {"n_groups": int(2048 * 3.2), "n_group_max": 9, "n_k_span": 30,
                     "fresh": True}),
    "group-grows": (dict(GROUP, march_group_slots=4), (1000, 2000, 4, 4096, 0.7),
                    {"n_groups": 9000, "n_group_max": 6, "n_k_span": 30}),
    "group-shrinks": (dict(GROUP, march_group_mult=4.0, march_group_slots=8),
                      (1000, 2000, 4, 4096, 0.7),
                      {"n_groups": 1000, "n_group_max": 2, "n_k_span": 30}),
    "group-holds-in-band": (dict(GROUP, march_group_slots=6), (1000, 2000, 4, 4096, 0.7),
                            {"n_groups": 3000, "n_group_max": 4, "n_k_span": 30}),
    "group-slots-from-none": (dict(GROUP, march_group_slots=None), (1000, 2000, 4, 4096, 0.7),
                              {"n_groups": 3000, "n_group_max": 3, "n_k_span": 30}),
    "group-off-ignores-telemetry": (dict(march_iters=32), (1000, 2000, 4, 4096, 0.7),
                                    {"n_groups": 99999, "n_group_max": 9}),
    "torso-grows": (dict(BASE, torso=True), (1000, 2000, 4, 4096, 0.7),
                    {"n_torso": 3000, "n_k_span": 30}),
    "torso-shrinks": (dict(BASE, torso=True, torso_capacity_frac=1.0),
                      (1000, 2000, 4, 4096, 0.7), {"n_torso": 200, "n_k_span": 30}),
    "torso-holds-in-band": (dict(BASE, torso=True, torso_capacity_frac=0.5),
                            (1000, 2000, 4, 4096, 0.7), {"n_torso": 900, "n_k_span": 30}),
    "torso-off-ignores-telemetry": (BASE, (1000, 2000, 4, 4096, 0.7),
                                    {"n_torso": 3000, "n_k_span": 30}),
    "no-rays": (BASE, (0, 0, 0, 0, 0.7), {"n_k_span": 30}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adapt_render_config_matches_jax(case):
    """The port's adapt_render_config returns None exactly where JAX's does,
    and else the same seven capacity fields, on each case: the ray, sample,
    orbit, lattice, group and torso rules, their hysteresis bands, the
    sphere-diameter fallback, ``fresh`` (at the trainer's headroom and at
    the bench's 1.1), and the cases of tests/test_train.py's
    test_adapt_render_config_k_span_rule and _group_rules."""
    from radnerf_tpu_torch.train.capacity import adapt_render_config

    fields, args, kw = CASES[case]
    got = adapt_render_config(RenderConfig(**fields), *args, **kw)
    want = j_adapt_render_config(JRenderConfig(**fields), *args, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        assert _caps(got) == _caps(want)
        for f in FIELDS:
            assert type(getattr(got, f)) is type(getattr(want, f)), f


def test_capacity_helpers_match_jax():
    """RenderConfig.ray_capacity / sample_capacity equal JAX's, and the
    RenderConfig carries JAX's four buffer fields with its defaults."""
    from radnerf_tpu_torch.train.capacity import CAPACITY_FIELDS

    assert CAPACITY_FIELDS == FIELDS
    for n, frac in ((1, 1.0), (512, 0.3), (4096, 1.5), (262_144, 0.375), (1000, 0.125)):
        assert RenderConfig.ray_capacity(n, frac) == JRenderConfig.ray_capacity(n, frac)
        for mult in (0.0625, 2.75, 16.0):
            assert RenderConfig.sample_capacity(n, mult) == \
                JRenderConfig.sample_capacity(n, mult)
    assert _caps(RenderConfig()) == _caps(JRenderConfig())
    opt = Options(sample_capacity_mult=16.0, ray_capacity_frac=0.5, march_iters=40)
    assert _caps(RenderConfig.from_options(opt)) == _caps(JRenderConfig.from_options(
        JOptions(sample_capacity_mult=16.0, ray_capacity_frac=0.5, march_iters=40)))


# --------------------------------------------------------------- the CLI
@pytest.mark.parametrize("flags", [
    [],
    ["--sample_capacity_mult", "16", "--ray_capacity_frac", "1.0"],
    ["--march_iters", "64"],
    ["--march_iters", "24", "--ray_capacity_frac", "0.5", "-O"],
], ids=["none", "buffers", "march_iters", "all-O"])
def test_cli_records_cap_overrides_as_jax(flags):
    """The port's CLI takes JAX's capacity flags, records the ones typed in
    ``Options.cap_overrides`` and keeps the defaults of the others, as JAX's
    options_from_args does; RenderConfig.from_options carries them."""
    import main as jmain

    from radnerf_tpu_torch.main import build_parser, options_from_args

    opt = options_from_args(build_parser().parse_args(["data/x", *flags]))
    jopt = jmain.options_from_args(jmain.build_parser().parse_args(["data/x", *flags]))
    assert opt.cap_overrides == jopt.cap_overrides
    for f in ("sample_capacity_mult", "march_iters", "ray_capacity_frac", "auto_capacity"):
        assert getattr(opt, f) == getattr(jopt, f), f
    assert _caps(RenderConfig.from_options(opt)) == _caps(JRenderConfig.from_options(jopt))
    assert opt.auto_capacity is True


def test_unknown_cap_override_raises():
    """Trainer(cap_overrides=...) names only capacity fields, as JAX's."""
    with pytest.raises(ValueError, match="unknown capacity fields"):
        Trainer(Options(), NetworkConfig(**SMALL), RenderConfig(**RC), device="cpu",
                cap_overrides=["march_iter"])
    tr = Trainer(Options(cap_overrides=("march_iters",)), NetworkConfig(**SMALL),
                 RenderConfig(**RC), device="cpu", cap_overrides=["sample_slots"])
    assert tr._user_cap_fields == {"march_iters", "sample_slots"}


# -------------------------------------------------------- the loops
@pytest.fixture(scope="module")
def params():
    # JAX draws its parameters op by op (~14 s of compiles): a jitted draw
    return jax.jit(lambda k: init_params(k, JNetworkConfig(**SMALL)))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_loop(data_dir, params, tmp_path_factory):  # noqa: F811
    """JAX's trainer at its defaults (auto_capacity on) over EPOCHS epochs;
    each upkeep installs the next blob of RADII. Returns a dict: the trainer,
    its checkpoint, the capacities at each upkeep (after its adaptation), each
    step's loss, telemetry and noises, its log lines."""
    ws = str(tmp_path_factory.mktemp("capacity_jax"))
    jt = JTrainer("ngp", JOptions(path=data_dir, workspace=ws, **OPT),
                  net_cfg=JNetworkConfig(**SMALL), render_cfg=JRenderConfig(exp_eye=True, **RC),
                  params=params, workspace=ws, use_tensorboard=False, mute=True)
    assert jt.opt.auto_capacity
    out = {"caps": [], "loss": [], "telemetry": [], "noises": []}

    def upkeep(dataset):
        jt.state = _blob_state_j(jt.render_cfg, _blob_grid(GRID, RADII[len(out["caps"])]),
                                 1.0)
        out["caps"].append((jt.global_step, _caps(jt.render_cfg)))

    get_step = jt._get_train_step

    def recording_step(sig):
        fn = get_step(sig)

        def step(params, opt_state, state, batch, global_step, key):
            res = fn(params, opt_state, state, batch, global_step, key)
            out["noises"].append(np.asarray(jax.random.uniform(key, (batch["rays_o"].shape[0],))))
            out["loss"].append(float(res[3]))
            out["telemetry"].append([int(v) for v in np.asarray(res[4])])
            return res

        return step

    jt._update_extra_state = upkeep
    jt._get_train_step = recording_step
    ds = JTalkingHeadDataset(jt.opt, split="train")
    for epoch in range(1, EPOCHS + 1):
        jt.epoch = epoch
        jt.train_one_epoch(ds)
    jt.save_checkpoint(full=True)
    out["trainer"], out["ckpt"] = jt, jt.stats["checkpoints"][-1]
    with open(jt.log_path) as fh:
        out["log"] = fh.read().splitlines()
    return out


@pytest.fixture(scope="module")
def port_loop(data_dir, params, jax_loop, tmp_path_factory):  # noqa: F811
    """The port's trainer at its defaults over the same epochs, upkeeps and
    noises, from the same parameters; the same dict as ``jax_loop``."""
    ws = str(tmp_path_factory.mktemp("capacity_port"))
    tr = Trainer(Options(path=data_dir, **OPT), NetworkConfig(**SMALL), RenderConfig(**RC),
                 device="cpu", workspace=ws, use_checkpoint="scratch", mute=True,
                 use_tensorboard=False)
    assert tr.opt.auto_capacity
    load_jax_params(tr.net, jax.tree_util.tree_map(np.asarray, params))
    out = {"caps": [], "loss": [], "telemetry": []}
    noises = iter(jax_loop["noises"])

    def upkeep(dataset):
        tr.state = state_from_numpy(tr.render_cfg, _blob_grid(GRID, RADII[len(out["caps"])]),
                                    np.zeros(GRID * GRID, np.float32), 1.0, 0.0, thresh=1.0,
                                    device="cpu")
        out["caps"].append((tr.global_step, _caps(tr.render_cfg)))

    train_step = tr.train_step

    def recording_step(batch):
        loss = train_step(batch)
        out["loss"].append(float(loss))
        out["telemetry"].append([int(tr.telemetry[k]) for k in TELEMETRY])
        return loss

    tr.update_extra_state = upkeep
    tr.draw_noises = lambda n: torch.from_numpy(np.array(next(noises)))
    tr.train_step = recording_step
    # JAX's dataset: the same batches bit for bit (the port's own rays may
    # differ by an ulp, tests/test_torch_data.py)
    ds = JTalkingHeadDataset(JOptions(path=data_dir, **OPT), split="train")
    for epoch in range(1, EPOCHS + 1):
        tr.epoch = epoch
        tr.train_one_epoch(ds)
    tr.save_checkpoint(full=True)
    out["trainer"], out["ckpt"] = tr, tr.stats["checkpoints"][-1]
    with open(tr.log_path) as fh:
        out["log"] = fh.read().splitlines()
    return out


def test_trainer_adapts_capacities_as_jax(jax_loop, port_loop):
    """At their defaults both trainers adapt at the upkeeps inside epochs
    (steps 2, 6, 10; not at 0, 4, 8, where an epoch starts) and hold the
    same seven capacities after each upkeep; the lattice changed (K set from
    the measured span, S shrunk with the scene), and each adaptation's log
    line is JAX's."""
    want, got = jax_loop["caps"], port_loop["caps"]
    assert [s for s, _ in want] == [0, 2, 4, 6, 8, 10]
    assert got == want
    default = _caps(RenderConfig(**RC))
    assert want[0][1] == default
    changes = [a != b for (_, a), (_, b) in zip(want, want[1:])]
    assert changes[0] and sum(changes) >= 2, want  # the first adaptation sets K
    assert want[-1][1][FIELDS.index("sample_slots")] < RC["max_steps"]
    adapt_j = [l for l in jax_loop["log"] if l.startswith("[INFO] adapt capacities")]
    adapt_p = [l for l in port_loop["log"] if l.startswith("[INFO] adapt capacities")]
    assert adapt_p == adapt_j and len(adapt_j) == sum(changes)


def test_trainer_loop_losses_and_telemetry_match_jax(jax_loop, port_loop):
    """Every step's telemetry is JAX's exactly (the same samples on the
    adapted lattices) and every loss agrees to rel 1e-5. JAX's capacities
    never bound a step here (its result is exhaustive, as the port's), and
    each epoch's line gives the same hits and samples beside the same
    capacities, with no [DROPPING] marker."""
    assert len(port_loop["telemetry"]) == len(jax_loop["telemetry"]) == 4 * EPOCHS
    assert port_loop["telemetry"] == jax_loop["telemetry"]
    np.testing.assert_allclose(port_loop["loss"], jax_loop["loss"], rtol=1e-5)

    def notes(log):
        return [l.split("steps/s")[1] for l in log if l.startswith("==> Finished Epoch")]

    assert notes(port_loop["log"]) == notes(jax_loop["log"])
    assert len(notes(jax_loop["log"])) == EPOCHS
    assert not any("[DROPPING]" in n for n in notes(jax_loop["log"]))


def test_checkpoints_carry_all_capacities_both_ways(jax_loop, port_loop, params, tmp_path):
    """Both trainers' checkpoints record all seven capacities; the port
    restores JAX's, and JAX restores the port's, field for field."""
    for loop in (jax_loop, port_loop):
        meta = load_checkpoint(loop["ckpt"])[4]
        assert set(meta["render_cfg"]) == set(FIELDS)
        assert tuple(meta["render_cfg"][f] for f in FIELDS) == _caps(loop["trainer"].render_cfg)

    tr = Trainer(Options(**OPT), NetworkConfig(**SMALL), RenderConfig(**RC), device="cpu")
    tr.load_checkpoint(jax_loop["ckpt"])
    assert _caps(tr.render_cfg) == _caps(jax_loop["trainer"].render_cfg) != \
        _caps(RenderConfig(**RC))
    jt = JTrainer("ngp", JOptions(workspace=str(tmp_path), **OPT),
                  net_cfg=JNetworkConfig(**SMALL), render_cfg=JRenderConfig(exp_eye=True, **RC),
                  params=params, use_tensorboard=False, mute=True)
    jt.load_checkpoint(port_loop["ckpt"])
    assert _caps(jt.render_cfg) == _caps(port_loop["trainer"].render_cfg)


def test_adapt_cap_and_its_warning_match_jax(jax_loop, port_loop):
    """_adapt_capacities on the same telemetry: below the cap both take the
    same configuration and log the same line; once the cap binds, both keep
    the configuration and log the same [WARN] where the telemetry exceeds
    JAX's capacities, and nothing where it does not."""
    jt, tr = jax_loop["trainer"], port_loop["trainer"]
    rc_j, rc_p, count_j, count_p = jt.render_cfg, tr.render_cfg, jt._adapt_count, \
        tr._adapt_count
    lines_j, lines_p = [], []
    log_j, log_p = jt.log, tr.log
    jt.log, tr.log = lines_j.append, lines_p.append
    try:
        for stats, n_rays, capped in (([400, 1500, 7, 9, 0, 0], 512, False),
                                      ([500, 5000, 8, 30, 0, 0], 512, True),
                                      ([10, 20, 2, 3, 0, 0], 512, True)):
            jt.render_cfg = rc_j
            tr.render_cfg = rc_p
            jt._adapt_count = tr._adapt_count = jt._adapt_cap if capped else 0
            jt._adapt_capacities(np.asarray(stats), n_rays)
            tr._adapt_capacities({k: torch.tensor(v) for k, v in zip(TELEMETRY, stats)},
                                 n_rays)
            assert _caps(tr.render_cfg) == _caps(jt.render_cfg)
            assert lines_p == lines_j
        assert tr._adapt_cap == jt._adapt_cap == 6
        assert sum(l.startswith("[WARN] adaptive-capacity cap") for l in lines_j) == 1
        assert sum(l.startswith("[INFO] adapt capacities") for l in lines_j) == 1
    finally:
        jt.log, tr.log = log_j, log_p
        jt.render_cfg, tr.render_cfg, jt._adapt_count, tr._adapt_count = \
            rc_j, rc_p, count_j, count_p


def test_auto_capacity_off_and_train_gui_keep_the_lattice(data_dir, params):  # noqa: F811
    """With auto_capacity off the epoch loop keeps its capacities, and
    train_gui never adapts (as JAX's), whatever the interval."""
    for opt, burst in ((Options(auto_capacity=False, **OPT), False),
                       (Options(**OPT), True)):
        tr = Trainer(opt, NetworkConfig(**SMALL), RenderConfig(**RC), device="cpu")
        load_jax_params(tr.net, jax.tree_util.tree_map(np.asarray, params))
        ds = JTalkingHeadDataset(JOptions(path=data_dir, **OPT), split="train")
        tr.update_extra_state = lambda dataset: None
        tr.state = state_from_numpy(tr.render_cfg, _blob_grid(GRID, 0.5),
                                    np.zeros(GRID * GRID, np.float32), 1.0, 0.0, thresh=1.0,
                                    device="cpu")
        if burst:
            tr.train_gui(ds, step=6)
        else:
            tr.train_one_epoch(ds)
        assert tr._adapt_count == 0 and _caps(tr.render_cfg) == _caps(RenderConfig(**RC))


# ------------------------------------------------------------ the repair
def test_explicit_march_iters_beats_checkpoint(small, data_dir, jax_loop, params,  # noqa: F811
                                               tmp_path):
    """A capacity the user set beats the checkpoint's record: JAX's trainer
    adapted and saved; the port's ``main --test --march_iters 2`` and JAX's
    trainer on options from its own CLI's same flags both load that
    checkpoint, keep K = 2 with the same [WARN], restore the other six
    capacities, and render the same test frame (>= 60 dB), which K = 2
    truncates."""
    import main as jmain

    ckpt = jax_loop["ckpt"]
    saved = load_checkpoint(ckpt)[4]["render_cfg"]
    user_k = 2
    assert saved["march_iters"] is not None and saved["march_iters"] > user_k
    flags = [data_dir, "--exp_eye", "--ind_num", "8", "--dt_gamma", "0", "--test",
             "--ckpt", ckpt, "--march_iters", str(user_k)]
    ws = str(tmp_path / "port")
    tr = port_main.main([*flags, "--workspace", ws], device="cpu")
    assert tr.render_cfg.march_iters == user_k
    for f in FIELDS:
        if f != "march_iters":
            assert getattr(tr.render_cfg, f) == saved[f], f

    jopt = jmain.options_from_args(jmain.build_parser().parse_args(
        [*flags, "--workspace", str(tmp_path / "jax")]))
    assert jopt.cap_overrides == ("march_iters",) == tr.opt.cap_overrides
    jt = JTrainer("ngp", jopt, net_cfg=JNetworkConfig(**SMALL),
                  render_cfg=dataclasses.replace(JRenderConfig.from_options(jopt),
                                                 grid_size=GRID, max_steps=8),
                  params=params, use_tensorboard=False, mute=True)
    jt.load_checkpoint(ckpt)
    assert _caps(jt.render_cfg) == _caps(tr.render_cfg)

    with open(os.path.join(ws, "log_ngp.txt")) as fh:
        warn_p = [l for l in fh.read().splitlines() if l.startswith("[WARN] checkpoint carries")]
    with open(jt.log_path) as fh:
        warn_j = [l for l in fh.read().splitlines() if l.startswith("[WARN] checkpoint carries")]
    assert warn_p == warn_j and len(warn_p) == 1 and "'march_iters'" in warn_p[0]

    test_j = JTalkingHeadDataset(jopt, split="test")
    test_j.training, test_j.num_rays = False, -1
    batch = test_j.collate(0)
    got = tr.eval_step(tr.to_device(batch))[0]
    want = jt.eval_step(jt._to_device(batch))[0]
    err = float(np.mean((np.float64(got) - want) ** 2))
    assert 10.0 * np.log10(1.0 / max(err, 1e-20)) >= 60.0
    # K = 2 cuts windows of this frame: at the checkpoint's K it differs
    b = tr.to_device(batch)
    full, _ = render_rays(tr.net, dataclasses.replace(tr.render_cfg,
                                                      march_iters=saved["march_iters"]),
                          tr.state, b["rays_o"], b["rays_d"], b.get("auds"), b["bg_coords"],
                          b["poses"], b.get("eye"), b["index"], b["bg_color"])
    assert int(full["n_k_span"]) > user_k
    assert not np.array_equal(full["image"].reshape(got.shape).numpy(), got)


# ------------------------------------------------------ the fresh lattice
@pytest.mark.parametrize("group", [False, True], ids=["dense", "march_group"])
def test_fresh_lattice_frame_is_bit_for_bit(group):
    """The bench scene's frame (radnerf_tpu_torch/scene.py at 48x48) sized by
    fresh_render_config (JAX bench.py's two fresh passes at headroom 1.1,
    replayed through JAX's adapt_render_config on the same telemetry: the
    same seven fields) marches a shorter orbit on a narrower lattice and
    renders the default lattice's frame bit for bit: the same samples in
    the same ray-major order, with fewer empty slots. With march_group the
    sized K qualifies the two-level march, and its frame is the same too."""
    from radnerf_tpu_torch.scene import build_scene
    from radnerf_tpu_torch.train.capacity import fresh_render_config

    net, rc, state, b, auds = build_scene(48, 48, device="cpu")
    rc = dataclasses.replace(rc, march_group=group)
    seen = []

    def render(cfg):
        with torch.no_grad():
            return render_rays(net, cfg, state, b["rays_o"], b["rays_d"], auds[0],
                               b["bg_coords"], b["poses"], b["eye"], b["index"],
                               b["bg_color"])[0]

    def telemetry(cfg):
        seen.append({k: int(v) for k, v in render(cfg).items() if k.startswith("n_")})
        return seen[-1]

    n, radius = b["rays_o"].shape[0], float(state.occ_sphere[3])
    sized = fresh_render_config(rc, telemetry, n, radius)
    want = JRenderConfig(**{f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)})
    for t, kw in ((seen[0], {}), (seen[1], {"n_groups": seen[1]["n_groups_needed"] or None,
                                            "n_group_max": seen[1]["n_group_max"] or None})):
        want = j_adapt_render_config(want, t["n_hit"], t["n_samples_needed"], t["n_max_count"],
                                     n, radius, n_torso=t["n_torso_mask"],
                                     n_k_span=t["n_k_span"], headroom=1.1, fresh=True,
                                     **kw) or want
    assert _caps(sized) == _caps(want)
    assert sized.march_iters < rc.march_config().n_march_iters
    assert sized.sample_slots < rc.max_steps
    assert seen[0]["n_max_count"] < sized.sample_slots and \
        seen[0]["n_k_span"] <= sized.march_iters  # nothing truncated
    base = render(dataclasses.replace(rc, march_group=False))
    got = render(sized)
    assert int(got["n_samples_needed"]) == int(base["n_samples_needed"]) > 0
    if group:
        assert int(got["n_groups_needed"]) > 0 and sized.march_group_slots is not None
    for k in ("image", "depth", "weights_sum", "torso_alpha"):
        assert torch.equal(got[k], base[k]), k
