"""The port's torso stage against the JAX package's, on the CPU: the torso
grid's upkeep, the torso loss, one torso-stage train step (frozen head) and
a port Trainer's torso run from a port-written head checkpoint on the JAX
package's on-disk dataset. The model is tests/test_torch_train.py's narrow
one with the torso; JAX runs at exhaustive capacities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import init_params
from radnerf_tpu.models import render_rays as j_render_rays
from radnerf_tpu.models import update_torso_grid as j_update_torso_grid
from radnerf_tpu.models.renderer import RendererState as JRendererState
from radnerf_tpu.train.losses import torso_loss as j_torso_loss

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import _state_dict_from_jax, network_from_jax, state_from_numpy
from radnerf_tpu_torch.models import (
    NetworkConfig,
    RenderConfig,
    RendererState,
    render_rays,
    update_torso_grid,
)
from radnerf_tpu_torch.train import Trainer, build_optimizer, torso_loss
from radnerf_tpu_torch.train import checkpoint as ckpt_lib
from radnerf_tpu_torch.train import trainer as trainer_mod

from test_torch_train import GRID, SMALL, _blob_state_j
from test_train import data_dir  # noqa: F401  (the on-disk dataset fixture)

SMALL_T = dict(SMALL, torso=True)
TORSO_KEYS = ("torso_deform_net", "torso_encoder", "torso_net", "individual_codes_torso")
TELEMETRY = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span", "n_torso_mask")


def _T(a):
    return torch.from_numpy(np.array(a))


def _is_torso(name):
    return name.split(".")[0] in TORSO_KEYS


@pytest.fixture(scope="module")
def torso_params():
    """JAX init_params of the narrow head+torso model, its grid tables drawn
    U(-1, 1) (the init's U(-1e-4, 1e-4) times 1e4); numpy leaves."""
    cfg = JNetworkConfig(**SMALL_T)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: init_params(k, cfg))(jax.random.PRNGKey(13)))
    for k in ("encoder", "encoder_ambient", "torso_encoder"):
        params[k] = params[k] * 1e4
    return params


def test_update_torso_grid_matches_jax(torso_params):
    """update_torso_grid at grid 32 with JAX's own jitter draw, JAX op by
    op: the grid within 1e-6 (alphas in [0, 1] through float32 GEMMs in
    another order), its mean to 1e-6 relative; the pooled alphas really
    replace part of the decayed grid."""
    rng = np.random.default_rng(81)
    rc_j = JRenderConfig(grid_size=GRID, torso=True)
    rc = RenderConfig(grid_size=GRID, torso=True)
    grid0 = rng.uniform(0.0, 1.0, GRID * GRID).astype(np.float32)
    pose6 = rng.normal(size=(1, 6)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    params_j = jax.tree_util.tree_map(jnp.asarray, torso_params)
    state_j = JRendererState.create(rc_j).replace(density_grid_torso=jnp.asarray(grid0))
    want = j_update_torso_grid(params_j, JNetworkConfig(**SMALL_T), rc_j, state_j,
                               jnp.asarray(pose6), params_j["individual_codes_torso"][5], key)
    half = 1.0 / GRID
    jitter = _T(jax.random.uniform(key, (GRID * GRID, 2), minval=-half, maxval=half))

    net = network_from_jax(torso_params, NetworkConfig(**SMALL_T), device="cpu")
    state = RendererState.create(rc, device="cpu")
    state.density_grid_torso = _T(grid0)
    got = update_torso_grid(net, rc, state, _T(pose6), net.individual_codes_torso[5],
                            jitter=jitter)
    g_j = np.asarray(want.density_grid_torso)
    np.testing.assert_allclose(got.density_grid_torso.numpy(), g_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got.mean_density_torso), float(want.mean_density_torso),
                               rtol=1e-6)
    assert 0.05 < (g_j > grid0 * 0.95 + 1e-6).mean() < 0.95


def test_torso_loss_matches_jax():
    rng = np.random.default_rng(82)
    n = 300
    res = {"torso_color": rng.random((n, 3)).astype(np.float32),
           "torso_alpha": np.concatenate([[[0.0], [1.0]], rng.random((n - 2, 1))])
           .astype(np.float32)}
    gt = rng.random((n, 3)).astype(np.float32)
    want = j_torso_loss({k: jnp.asarray(v) for k, v in res.items()}, jnp.asarray(gt))
    got = torso_loss({k: _T(v) for k, v in res.items()}, _T(gt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("flags", [
    {},
    # flags no other port test reaches at a value off their defaults
    {"ind_dim_torso": 4, "torso_shrink": 0.6},
], ids=["default", "code4-shrink"])
def test_torso_train_step_matches_jax(torso_params, flags):
    """One torso-stage train step on the 48x48 blob scene, 512 rays, frame
    index 3, JAX's value_and_grad under jit at exhaustive capacities, the same
    noises: loss to rel 1e-5, identical telemetry (n_torso_mask included),
    every torso parameter's gradient within 1e-4 * max|g_jax| + 1e-7
    (through the torso MLPs, the clamp and the 2-D encode's x gradient), the
    torso code rows other than 3 exactly 0, and no gradient on the frozen
    head. The second case takes a 4-wide torso code (``--ind_dim_torso``)
    and a torso shrink of 0.6 (``--torso_shrink``), as the options map them
    into both packages' network configs."""
    from radnerf_tpu.data.rays import get_bg_coords, get_rays
    from test_train import _blob_grid

    small_t = dict(SMALL_T, **flags)
    for cfg in (NetworkConfig.from_options(Options(torso=True, **flags)),
                JNetworkConfig.from_options(JOptions(torso=True, **flags))):
        assert all(getattr(cfg, k) == v for k, v in flags.items())
    params = torso_params
    if flags:
        params = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: init_params(k, JNetworkConfig(**small_t)))(jax.random.PRNGKey(13)))
        for k in ("encoder", "encoder_ambient", "torso_encoder"):
            params[k] = params[k] * 1e4
    rng = np.random.default_rng(83)
    n = 512
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, 24.0, 24.0), 48, 48, n, rng=rng)
    f = dict(
        rays_o=rays["rays_o"], rays_d=rays["rays_d"],
        bg_coords=get_bg_coords(48, 48)[rays["inds"]],
        pose6=rng.normal(size=(1, 6)).astype(np.float32) * 0.3,
        auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
        bg_color=rng.random((n, 3)).astype(np.float32),
        eye=np.array([[0.25]], np.float32),
        torso_gt=rng.random((n, 3)).astype(np.float32),
        noises=rng.random(n).astype(np.float32),
    )
    index = 3
    grid = _blob_grid(GRID)
    torso_grid = rng.uniform(0.0, 0.02, GRID * GRID).astype(np.float32)
    mean_t = 0.01
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, exp_eye=True, torso=True,
                         sample_capacity_mult=16.0, ray_capacity_frac=1.0,
                         torso_capacity_frac=1.0, cull_T=1e-6)
    state_j = _blob_state_j(rc_j, grid, 1.0).replace(
        density_grid_torso=jnp.asarray(torso_grid),
        mean_density_torso=jnp.asarray(mean_t, jnp.float32))
    cfg_j = JNetworkConfig(**small_t)
    a = {k: jnp.asarray(v) for k, v in f.items()}

    def loss_fn(p):
        res, _ = j_render_rays(p, cfg_j, rc_j, state_j, a["rays_o"], a["rays_d"], a["auds"],
                               a["bg_coords"], a["pose6"], a["eye"],
                               jnp.asarray(index, jnp.int32), a["bg_color"],
                               noises=a["noises"], training=True)
        return j_torso_loss(res, a["torso_gt"]), {k: res[k] for k in TELEMETRY}

    (loss_j, tel_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))

    net = network_from_jax(params, NetworkConfig(**small_t), device="cpu")
    assert net.individual_codes_torso.shape[1] == small_t.get("ind_dim_torso", 8)
    build_optimizer(net, Options(torso=True))  # freezes the head
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=1e-6, torso=True)
    state = state_from_numpy(rc, grid, torso_grid, 1.0, mean_t, thresh=1.0, device="cpu")
    t = {k: _T(v) for k, v in f.items()}
    res, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"], t["bg_coords"],
                         t["pose6"], t["eye"], index, t["bg_color"], noises=t["noises"],
                         training=True)
    loss = torso_loss(res, t["torso_gt"])
    loss.backward()

    assert 0 < int(res["n_torso_mask"]) < n and int(res["n_samples_needed"]) > 300
    for k in TELEMETRY:
        assert int(res[k]) == int(tel_j[k]), k
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    want = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    for name, p in net.named_parameters():
        if not _is_torso(name):
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name]
        tol = 1e-4 * float(np.abs(w).max()) + 1e-7
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= tol, f"{name}: max |g - g_jax| {err} > {tol}"
        assert float(np.abs(w).max()) > 0, name
    codes = net.individual_codes_torso.grad.numpy()
    assert np.all(np.delete(codes, index, axis=0) == 0.0) and np.abs(codes[index]).max() > 0


def test_trainer_torso_stage_from_port_head_checkpoint(data_dir, tmp_path,  # noqa: F811
                                                       monkeypatch):
    """The reference's workflow on the JAX package's on-disk dataset: a port
    Trainer trains the head and saves it, a torso Trainer loads it with
    freeze_loaded_head and trains: the head's parameters stay as saved and
    its grid as well (only mark_untrained_grid's -1 cells may differ), the
    torso's parameters move, the torso grid fills, each upkeep takes the
    pose JAX's _update_extra_state draws at that step; a missing head
    checkpoint raises FileNotFoundError."""
    from radnerf_tpu.data import TalkingHeadDataset
    from radnerf_tpu.train import Trainer as JTrainer

    common = dict(num_rays=512, exp_eye=True, iters=100, dt_gamma=0.0, update_extra_interval=2)
    rc = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    ds_h = TalkingHeadDataset(JOptions(path=data_dir, workspace=str(tmp_path), **common),
                              split="train")
    tr_h = Trainer(Options(**common), NetworkConfig(**SMALL), RenderConfig(**rc),
                   device="cpu", workspace=str(tmp_path / "h"))
    tr_h.train(ds_h, max_epochs=1)
    head_ckpt = tr_h.stats["checkpoints"][-1]
    assert head_ckpt.endswith("ngp_ep0001.npz")

    ds_t = TalkingHeadDataset(JOptions(path=data_dir, workspace=str(tmp_path), torso=True,
                                       **common), split="train")
    assert "bg_torso_color" in ds_t.collate(0)
    tr = Trainer(Options(torso=True, head_ckpt=head_ckpt, **common), NetworkConfig(**SMALL_T),
                 RenderConfig(torso=True, **rc), device="cpu")
    tr.freeze_loaded_head()
    head = dict(tr_h.net.named_parameters())
    before = {k: v.detach().clone() for k, v in tr.net.named_parameters()}
    upkeeps = []

    def recording(net, cfg, state, pose6, code, **kw):
        upkeeps.append((tr.global_step, code.clone(), net.individual_codes_torso.detach().clone()))
        return update_torso_grid(net, cfg, state, pose6, code, **kw)

    monkeypatch.setattr(trainer_mod, "update_torso_grid", recording)
    tr.train(ds_t, max_epochs=1)

    for name, p in tr.net.named_parameters():
        if _is_torso(name):
            assert not torch.equal(p, before[name]), name
        else:
            assert not p.requires_grad and torch.equal(p, head[name]), name
    assert float(tr.state.mean_density_torso) > 0 and tr.stats["mean_density"] == []
    grid_ckpt = ckpt_lib.load_checkpoint(head_ckpt)[1]["density_grid"].reshape(1, -1)
    differ = tr.state.density_grid.numpy() != grid_ckpt
    assert np.all(tr.state.density_grid.numpy()[differ] == -1.0)

    # the pose index JAX's trainer draws at each upkeep's step
    jt = JTrainer("ngp", JOptions(path=data_dir, workspace=str(tmp_path / "j"), torso=True,
                                  **common),
                  net_cfg=JNetworkConfig(**SMALL_T),
                  render_cfg=JRenderConfig(torso=True, exp_eye=True, **rc),
                  use_checkpoint="scratch", use_tensorboard=False, mute=True)
    drawn = []
    jt._get_maintenance_fn = lambda kind: (
        lambda params, state, pose6, pidx, key: drawn.append(int(pidx)) or state)
    assert [u[0] for u in upkeeps] == [0, 2]
    for step, code, codes in upkeeps:
        jt.global_step = step
        jt._update_extra_state(ds_t)
        rows = [i for i in range(codes.shape[0]) if torch.equal(codes[i], code)]
        assert rows == [drawn[-1]], (step, rows, drawn)

    with pytest.raises(FileNotFoundError, match="head_ckpt"):
        tr.freeze_loaded_head(str(tmp_path / "nope.npz"))
