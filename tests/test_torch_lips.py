"""The port's lips finetune and patch training (the LPIPS term of the head
loss), the -O checkpoints and the -O / --finetune_lips CLI, against the JAX
package on the CPU: the same numpy inputs, the same weights, the JAX
LPIPS's filters loaded into the port's.

Tolerances: a lips-rect step and a patch step in float32 to the head step's
standard of tests/test_torch_train.py
(loss rel 1e-5, every gradient within 1e-4 of its parameter's largest:
float32 GEMM, convolution and scatter sums in another order), against
JAX's step run op by op: under jit XLA contracts a grid level's x * scale +
0.5 into an FMA, which can move a sample of the patch into the next cell,
where the encode's slope, and with it the ambient MLP's gradient through
the x gradient, is another (8e-4 of that gradient's largest in the patch
case; the first call compiles every primitive, ~60 s of JAX here). The
weights are tests/test_torch_train.py's (that standard was set on them):
on another draw (the port's, seed 11) the same step, without the LPIPS term
too, differs by up to 5e-3 of the spatial table's largest gradient and
1.3e-3 of the ambient MLP's, because float32 GEMM-order differences in the
ambient MLP move an ambient sample across a fine cell boundary. The
batch kinds over four lips steps equal to JAX's, and every group's learning
rate to rel 1e-5 (optax's Adam on a unit gradient scales to 1 within a few
float32 roundings). A -O checkpoint renders in the other package within
50 dB of the writer's frame (both in bf16; JAX jitted keeps some bf16
intermediates in float32)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.data import TalkingHeadDataset as JTalkingHeadDataset
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import render_rays as j_render_rays
from radnerf_tpu.train import Trainer as JTrainer
from radnerf_tpu.train.losses import head_loss as j_head_loss
from radnerf_tpu.train.metrics import LPIPS as JLPIPS

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import _state_dict_from_jax, network_from_jax, state_from_numpy
from radnerf_tpu_torch.data import TalkingHeadDataset
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig, render_rays
from radnerf_tpu_torch.train import Trainer, head_loss
from radnerf_tpu_torch.train.metrics import LPIPS

from test_torch_metrics import _weights_from_jax
from test_torch_train import GRID, SMALL, TELEMETRY, _blob_state_j, head_params  # noqa: F401
from test_train import data_dir  # noqa: F401  (the on-disk dataset fixture)


def _T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def lpips_pair():
    """The JAX LPIPS (seed 4) and a port LPIPS holding its filters."""
    jl = JLPIPS(seed=4)
    port = LPIPS(device="cpu")
    port.load_torch_weights(*_weights_from_jax(jl))
    return jl, port


@pytest.mark.parametrize("mode", ["rect", "patch"])
def test_lpips_step_matches_jax(head_params, lpips_pair, mode):  # noqa: F811
    """One float32 head step with the LPIPS term on 1,024 rays of a 48x48
    frame: "rect", a 32x32 lips rect as one image at weight 0.01; "patch", one
    32x32 patch (patch_size 32) at 0.001. Against JAX's step run op by op
    (the module docstring says why): the same telemetry, the loss to rel
    1e-5, every gradient within 1e-4 of its parameter's largest; the LPIPS
    term finite and positive."""
    from radnerf_tpu.data.rays import get_bg_coords, get_rays
    from test_train import _blob_grid

    jl, port_lpips = lpips_pair
    rng = np.random.default_rng(61 if mode == "rect" else 62)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    intr = (80.0, 80.0, 24.0, 24.0)
    if mode == "rect":
        rays = get_rays(pose, intr, 48, 48, rect=[8, 40, 8, 40], rng=rng)
        shape, weight = (32, 32), 0.01
    else:
        rays = get_rays(pose, intr, 48, 48, 1024, patch_size=32, rng=rng)
        shape, weight = (32, 32), 0.001
    n = rays["rays_o"].shape[0]
    assert n == 1024
    f = dict(rays_o=rays["rays_o"], rays_d=rays["rays_d"],
             bg_coords=get_bg_coords(48, 48)[rays["inds"]],
             pose6=np.zeros((1, 6), np.float32),
             auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
             bg_color=rng.random((n, 3)).astype(np.float32),
             eye=np.array([[0.25]], np.float32),
             images=rng.random((n, 3)).astype(np.float32),
             noises=rng.random(n).astype(np.float32))
    face_mask = rng.random(n) < 0.5
    index, step, iters = 2, 30, 100
    grid = _blob_grid(GRID)
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, exp_eye=True,
                         sample_capacity_mult=16.0, ray_capacity_frac=1.0, cull_T=1e-6)
    state_j = _blob_state_j(rc_j, grid, 1.0)
    cfg_j = JNetworkConfig(**SMALL)
    a = {k: jnp.asarray(v) for k, v in f.items()}
    lpips_fn = jl.loss_fn()

    def loss_fn(p):
        res, _ = j_render_rays(p, cfg_j, rc_j, state_j, a["rays_o"], a["rays_d"], a["auds"],
                               a["bg_coords"], a["pose6"], a["eye"],
                               jnp.asarray(index, jnp.int32), a["bg_color"],
                               noises=a["noises"], training=True)
        loss = j_head_loss(res, a["images"], jnp.asarray(face_mask),
                           jnp.asarray(step, jnp.float32), iters, 0.1, lpips_fn=lpips_fn,
                           lpips_shape=shape, lpips_weight=weight)
        return loss, {k: res[k] for k in TELEMETRY}

    with jax.disable_jit():
        (loss_j, tel_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, head_params))

    net = network_from_jax(head_params, NetworkConfig(**SMALL), device="cpu")
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=1e-6)
    state = state_from_numpy(rc, grid, np.zeros(GRID * GRID, np.float32), 1.0, 0.0,
                             thresh=1.0, device="cpu")
    t = {k: _T(v) for k, v in f.items()}
    res, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"], t["bg_coords"],
                         t["pose6"], t["eye"], index, t["bg_color"], noises=t["noises"],
                         training=True)
    parts = {}
    loss = head_loss(res, t["images"], _T(face_mask), step, iters, 0.1, lpips=port_lpips,
                     lpips_shape=shape, lpips_weight=weight, parts=parts)
    loss.backward()

    for k in TELEMETRY:
        assert int(res[k]) == int(tel_j[k]), k
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    term = float(parts["lpips"].detach())
    assert np.isfinite(term) and term > 0.0
    want = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(net.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].grad
        tol = 1e-4 * float(np.abs(w).max()) + 1e-7
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"{name}: max |g - g_jax| {err} > {tol}"


def _lips_options(cls, data_dir, ws, **kw):  # noqa: F811
    return cls(path=data_dir, workspace=ws, num_rays=256, exp_eye=True, iters=100,
               dt_gamma=0.0, finetune_lips=True, update_extra_interval=10**9, **kw)


def test_lips_stage_batch_kinds_and_rates_match_jax(data_dir, tmp_path):  # noqa: F811
    """Four steps of the lips finetune on the on-disk dataset: the port's
    batch kinds alternate as JAX's trainer chooses them (its loop with the
    step itself stubbed: the kinds come from its dataset's collate and its
    flip of the shared options), and each step's learning rate of every
    group equals the JAX optimizer's, base * 0.05 ** (step / iters)."""
    jopt = _lips_options(JOptions, data_dir, str(tmp_path / "j"))
    jds = JTalkingHeadDataset(jopt, split="train")
    jt = JTrainer("ngp", jopt, net_cfg=JNetworkConfig(**SMALL),
                  render_cfg=JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0),
                  use_tensorboard=False, mute=True, use_checkpoint="scratch")
    kinds_j = []

    def recording_step(sig):
        kinds_j.append(sig[0])
        return lambda params, opt_state, state, batch, gs, key: (
            params, opt_state, state, jnp.zeros(()), jnp.zeros(6, jnp.int32))

    jt._get_train_step = recording_step
    jt._update_extra_state = lambda ds: None
    jt.train_one_epoch(jds)

    opt = _lips_options(Options, data_dir, str(tmp_path / "p"))
    ds = TalkingHeadDataset(opt, split="train", device="cpu")
    tr = Trainer(opt, NetworkConfig(**SMALL), RenderConfig(grid_size=GRID, max_steps=8,
                                                            dt_gamma=0.0), device="cpu")
    rates = []
    step = tr.optimizer.step

    def recording(*a, **kw):
        rates.append({g["name"]: g["lr"] for g in tr.optimizer.param_groups})
        return step(*a, **kw)

    tr.optimizer.step = recording
    tr.train_one_epoch(ds)

    assert kinds_j == ["rect", "none", "rect", "none"]
    assert tr.stats["loss_mode"] == kinds_j
    assert opt.finetune_lips and jopt.finetune_lips  # four flips
    assert [s for s, _ in tr.stats["lpips_term"]] == [1, 3]
    assert all(np.isfinite(v) and v > 0 for _, v in tr.stats["lpips_term"])
    assert np.all(np.isfinite(tr.stats["step_loss"]))

    # JAX's per-group rate at each count: optax's Adam on a unit gradient
    # scales to exactly 1, so the update is -rate
    params = jax.tree_util.tree_map(jnp.asarray, jt.params)
    ones = jax.tree_util.tree_map(jnp.ones_like, params)
    st = jt.tx.init(params)
    probe = {"grid": ("encoder",), "net": ("sigma_net", "layers", 0, "w"),
             "att": ("audio_att_net", "fc", "w")}
    for k in range(4):
        updates, st = jt.tx.update(ones, st, params)
        for group, path in probe.items():
            u = updates
            for key in path:
                u = u[key]
            np.testing.assert_allclose(rates[k][group], -float(np.asarray(u).flat[0]),
                                       rtol=1e-5)
            base = {"grid": opt.lr, "net": opt.lr_net, "att": 5 * opt.lr_net}[group]
            np.testing.assert_allclose(rates[k][group], base * 0.05 ** (k / opt.iters),
                                       rtol=1e-12)


@pytest.mark.parametrize("patch_size", [2, 16, 31])
def test_small_patches_are_refused(patch_size):
    """patch_size in (1, 32) raises in the port's Trainer, as in JAX's (the
    alex-LPIPS receptive field); 32 builds."""
    small, rc = NetworkConfig(**SMALL), RenderConfig(grid_size=16)
    with pytest.raises(ValueError, match="patch_size"):
        Trainer(Options(patch_size=patch_size), small, rc, device="cpu")
    with pytest.raises(ValueError, match="patch_size"):
        JTrainer("ngp", JOptions(patch_size=patch_size, workspace=""),
                 net_cfg=JNetworkConfig(**SMALL), render_cfg=JRenderConfig(grid_size=16),
                 use_tensorboard=False, mute=True)
    tr = Trainer(Options(patch_size=32), small, rc, device="cpu")
    assert tr.lpips is not None and tr.decay_base == 0.1


# ------------------------------------------------------- -O checkpoints
SMALL_O = dict(SMALL, torso=True, compute_dtype="bfloat16")
RC = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0, torso=True)
RC_J = dict(RC, exp_eye=True, sample_capacity_mult=16.0, ray_capacity_frac=1.0,
            torso_capacity_frac=1.0)


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


def _o_frames(net, state, params_j, state_j):
    """The 48x48 -O frame rendered by the port and by JAX (jitted)."""
    from radnerf_tpu.data.rays import get_bg_coords, get_rays

    H = W = 48
    rng = np.random.default_rng(63)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, W / 2, H / 2), H, W, -1)
    f = dict(rays_o=rays["rays_o"], rays_d=rays["rays_d"],
             bg_coords=np.asarray(get_bg_coords(H, W)),
             pose6=rng.normal(size=(1, 6)).astype(np.float32) * 0.3,
             auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
             bg_color=np.full((H * W, 3), 0.7, np.float32), eye=np.array([[0.25]], np.float32))
    t = {k: _T(v) for k, v in f.items()}
    got, _ = render_rays(net, RenderConfig(**RC), state, t["rays_o"], t["rays_d"], t["auds"],
                         t["bg_coords"], t["pose6"], t["eye"], 0, t["bg_color"])
    a = {k: jnp.asarray(v) for k, v in f.items()}
    want, _ = jax.jit(lambda p, s: j_render_rays(
        p, JNetworkConfig(**SMALL_O), JRenderConfig(**RC_J), s, a["rays_o"], a["rays_d"],
        a["auds"], a["bg_coords"], a["pose6"], a["eye"], jnp.zeros((), jnp.int32),
        a["bg_color"], training=False))(params_j, state_j)
    for k in ("n_hit", "n_samples_needed", "n_torso_mask"):
        assert int(got[k]) == int(want[k]), k
    assert int(got["n_samples_needed"]) > 100
    return _psnr(got["image"].numpy().astype(np.float64), np.asarray(want["image"], np.float64))


def _no_bf16_in(path):
    with np.load(path) as z:
        return all(z[k].dtype != np.dtype("V2") and z[k].dtype.itemsize != 2 for k in z.files) \
            and not any("_packed" in k for k in z.files)


def test_bf16_checkpoints_cross_both_ways(tmp_path):
    """A -O checkpoint written by the port loads into JAX's -O trainer and
    the reverse: float32 parameters equal bit for bit, the 48x48 -O frame of
    the loaded parameters within 50 dB of the writer's, and neither file
    holds a bf16 table."""
    from radnerf_tpu.config import Options as JO
    from test_train import _blob_grid

    grid = _blob_grid(GRID)
    torso_grid = np.random.default_rng(64).uniform(0.0, 0.2, GRID * GRID).astype(np.float32)
    # the port writes: a -O trainer whose network has run (its bf16 table
    # copies made), the checkpoint after
    ws = str(tmp_path / "p")
    tr = Trainer(Options(torso=True, iters=100, dt_gamma=0.0).apply_O(),
                 NetworkConfig(**SMALL_O), RenderConfig(**RC), device="cpu", workspace=ws,
                 use_checkpoint="scratch")
    for k in ("encoder", "encoder_ambient", "torso_encoder"):
        with torch.no_grad():
            getattr(tr.net, k).uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(5))
    tr.state = state_from_numpy(tr.render_cfg, grid, torso_grid, 1.0, 0.05, thresh=1.0,
                                device="cpu")
    tr.epoch = 1
    with torch.no_grad():
        tr.net.table_copy("encoder")
    tr.save_checkpoint(full=True)
    path = tr.stats["checkpoints"][-1]
    assert _no_bf16_in(path)
    jt = JTrainer("ngp", JO(workspace=ws, torso=True, iters=100, dt_gamma=0.0).apply_O(),
                  net_cfg=JNetworkConfig(**SMALL_O), render_cfg=JRenderConfig(**RC_J),
                  use_tensorboard=False, mute=True, use_checkpoint="latest")
    assert jt.epoch == 1
    saved = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jt.params))
    for name, p in tr.net.named_parameters():
        np.testing.assert_array_equal(saved[name], p.detach().numpy(), err_msg=name)
    assert _o_frames(tr.net, tr.state, jt._eval_params(), jt.state) >= 50.0

    # JAX writes (its eval params carry bf16 packed tables), the port loads
    jt.epoch = 2
    jt._eval_params()
    jt.save_checkpoint(full=True)
    path_j = jt.stats["checkpoints"][-1]
    assert _no_bf16_in(path_j)
    tp = Trainer(Options(torso=True, iters=100, dt_gamma=0.0).apply_O(),
                 NetworkConfig(**SMALL_O), RenderConfig(**RC), device="cpu")
    tp.load_checkpoint(path_j)
    assert tp.epoch == 2
    for name, p in tp.net.named_parameters():
        np.testing.assert_array_equal(saved[name], p.detach().numpy(), err_msg=name)
    assert _o_frames(tp.net, tp.state, jt._eval_params(), jt.state) >= 50.0


# ------------------------------------------------------------------ CLI
def test_main_runs_the_lips_finetune_under_o(data_dir, tmp_path, monkeypatch):  # noqa: F811
    """``main([dir, -O, --finetune_lips, ...], device="cpu")`` on the narrow
    model: the bf16 policy, the rect and full batches alternating, a finite,
    non-zero LPIPS term on the rect steps, the 0.05 decay, and the epoch and
    best checkpoints written."""
    import dataclasses

    from radnerf_tpu_torch.main import main

    net_from, rc_from = NetworkConfig.from_options, RenderConfig.from_options
    narrow = {k: v for k, v in SMALL.items() if k not in ("exp_eye", "ind_num")}
    monkeypatch.setattr(NetworkConfig, "from_options",
                        staticmethod(lambda opt: dataclasses.replace(net_from(opt), **narrow)))
    monkeypatch.setattr(RenderConfig, "from_options", staticmethod(
        lambda opt: dataclasses.replace(rc_from(opt), grid_size=GRID, max_steps=8)))
    ws = str(tmp_path / "ws")
    tr = main([data_dir, "--workspace", ws, "-O", "--finetune_lips", "--num_rays", "256",
               "--dt_gamma", "0", "--iters", "4", "--ckpt", "scratch"], device="cpu")
    assert tr.net_cfg.compute_dtype == "bfloat16" and tr.opt.fp16 and tr.opt.exp_eye
    assert tr.global_step == 4 and tr.decay_base == 0.05
    assert tr.stats["loss_mode"] == ["rect", "none", "rect", "none"]
    assert len(tr.stats["lpips_term"]) == 2
    assert all(np.isfinite(v) and v > 0 for _, v in tr.stats["lpips_term"])
    assert np.all(np.isfinite(tr.stats["step_loss"]))
    assert sorted(os.listdir(tr.ckpt_path)) == ["ngp.npz", "ngp_ep0001.npz"]
