"""Learnt camera offsets (``--train_camera``) in the port against the JAX
package, on the CPU: a training render of tests/test_torch_train.py's
48x48 blob scene with seeded, non-zero ``camera_dR`` / ``camera_dT`` and the
same noises, the loss of one head step and its gradients (the camera's
and the tables'), the camera parameters through the port's checkpoints,
``convert``, JAX's Adam state and the torso stage's freeze, and
``main --train_camera`` taking steps."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import render_rays as j_render_rays
from radnerf_tpu.models.network import param_groups as j_param_groups
from radnerf_tpu.train.losses import head_loss as j_head_loss

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import (
    _state_dict_from_jax,
    jax_from_state_dict,
    network_from_jax,
    network_to_jax,
    state_from_numpy,
)
from radnerf_tpu_torch.main import main
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig, param_groups, render_rays
from radnerf_tpu_torch.models.renderer import camera_offsets, sample_positions
from radnerf_tpu_torch.train import Trainer, head_loss, load_checkpoint

from test_torch_main import _args, small  # noqa: F401  (the narrowing fixture)
from test_torch_train import GRID, SMALL, TELEMETRY, _blob_state_j, head_params  # noqa: F401
from test_train import _blob_grid, data_dir  # noqa: F401  (the on-disk dataset fixture)

N_RAYS, INDEX, STEP, ITERS = 512, 3, 40, 100
CAM = dict(SMALL, train_camera=True)
RC = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=1e-6)
RC_J = dict(RC, exp_eye=True, sample_capacity_mult=16.0, ray_capacity_frac=1.0)


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((np.float64(a) - b) ** 2)), 1e-20))


@pytest.fixture(scope="module")
def cam_params(head_params):
    """The narrow head model with seeded camera offsets: a few degrees of
    rotation and a few hundredths of translation per frame."""
    rng = np.random.default_rng(31)
    ind_num = SMALL["ind_num"]
    return dict(head_params,
                camera_dR=rng.uniform(-3.0, 3.0, (ind_num, 3)).astype(np.float32),
                camera_dT=rng.uniform(-0.03, 0.03, (ind_num, 3)).astype(np.float32))


def _j_offsets(p, index, rays_o, rays_d):
    """The offsets as the JAX package applies them (renderer.py:432-448), as
    a function of the parameters: the reference for the chain rule into
    ``camera_dR`` / ``camera_dT``."""
    dT = p["camera_dT"][index]
    ang = p["camera_dR"][index] / 180.0 * jnp.pi + 1e-8
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    rx = jnp.array([[1, 0, 0], [0, ca[0], -sa[0]], [0, sa[0], ca[0]]])
    ry = jnp.array([[ca[1], 0, sa[1]], [0, 1, 0], [-sa[1], 0, ca[1]]])
    rz = jnp.array([[ca[2], -sa[2], 0], [sa[2], ca[2], 0], [0, 0, 1]])
    return rays_o + dT, rays_d @ (rx @ ry @ rz)


@pytest.fixture(scope="module")
def step_run(cam_params):
    """One training render and head loss of 512 rays of the blob scene at
    frame INDEX through the port, the same noises as JAX's, and JAX's
    counterparts, op by op (inside ``jit`` XLA:CPU contracts ``o + t * d``
    into an FMA):

    - "own": JAX's render with its camera offsets, forward;
    - "grad": the loss and its gradients at the port's offset rays, which
      can sit one float32 ulp from JAX's (XLA:CPU sums the 3x3 product's
      columns in orders no single PyTorch expression follows), their
      gradient into the camera taken through ``_j_offsets`` (a straight-
      through term: its value is 0). A position one ulp away can cross a
      grid cell, where the encode's x gradient jumps, so the gradients are
      held at the same rays.
    """
    from radnerf_tpu.data.rays import get_bg_coords, get_rays

    rng = np.random.default_rng(32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, 24.0, 24.0), 48, 48, N_RAYS, rng=rng)
    f = dict(rays_o=rays["rays_o"], rays_d=rays["rays_d"],
             bg_coords=get_bg_coords(48, 48)[rays["inds"]],
             pose6=np.zeros((1, 6), np.float32),
             auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
             bg_color=rng.random((N_RAYS, 3)).astype(np.float32),
             eye=np.array([[0.25]], np.float32),
             images=rng.random((N_RAYS, 3)).astype(np.float32),
             noises=rng.random(N_RAYS).astype(np.float32))
    face_mask = rng.random(N_RAYS) < 0.5
    grid = _blob_grid(GRID)

    net = network_from_jax(cam_params, NetworkConfig(**CAM), device="cpu")
    rc = RenderConfig(**RC)
    state = state_from_numpy(rc, grid, np.zeros(GRID * GRID, np.float32), 1.0, 0.0,
                             thresh=1.0, device="cpu")
    t = {k: torch.from_numpy(np.array(v)) for k, v in f.items()}
    res, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"], t["bg_coords"],
                         t["pose6"], t["eye"], INDEX, t["bg_color"], noises=t["noises"],
                         training=True)
    loss = head_loss(res, t["images"], torch.from_numpy(face_mask), STEP, ITERS, 0.1)
    loss.backward()
    with torch.no_grad():
        rays_port = [v.numpy() for v in camera_offsets(net, INDEX, t["rays_o"], t["rays_d"])]

    rc_j = JRenderConfig(**RC_J)
    state_j = _blob_state_j(rc_j, grid, 1.0)
    a = {k: jnp.asarray(v) for k, v in f.items()}

    def loss_fn(p, rays_o, rays_d, camera):
        res, _ = j_render_rays(p, JNetworkConfig(**SMALL, train_camera=camera), rc_j, state_j,
                               rays_o, rays_d, a["auds"], a["bg_coords"], a["pose6"], a["eye"],
                               jnp.asarray(INDEX, jnp.int32), a["bg_color"],
                               noises=a["noises"], training=True)
        loss = j_head_loss(res, a["images"], jnp.asarray(face_mask),
                           jnp.asarray(STEP, jnp.float32), ITERS, 0.1)
        return loss, {k: res[k] for k in (*TELEMETRY, "image")}

    def at_port_rays(p):
        o, d = _j_offsets(p, INDEX, a["rays_o"], a["rays_d"])
        o = jnp.asarray(rays_port[0]) + (o - jax.lax.stop_gradient(o))
        d = jnp.asarray(rays_port[1]) + (d - jax.lax.stop_gradient(d))
        return loss_fn(p, o, d, False)

    p_j = jax.tree_util.tree_map(jnp.asarray, cam_params)
    with jax.disable_jit():
        jax_rays = [np.asarray(v) for v in _j_offsets(p_j, INDEX, a["rays_o"], a["rays_d"])]
        own = loss_fn(p_j, a["rays_o"], a["rays_d"], True)
        grad = jax.value_and_grad(at_port_rays, has_aux=True)(p_j)
    return {"own": own, "grad": grad, "rays": (jax_rays, rays_port)}, \
        (loss, res, net), (t, rc, state)


def test_camera_training_render_matches_jax(step_run):
    """The offset rays within one float32 ulp of JAX's (the origins equal,
    the directions within an ulp of each one's largest component);
    the training render's image within 60 dB of JAX's, the same telemetry,
    the loss within rel 1e-5; the offsets really move the render."""
    j, (loss, res, net), (t, rc, state) = step_run
    (o_j, d_j), (o, d) = j["rays"]
    np.testing.assert_array_equal(o, o_j)
    # the rows are unit vectors: within one ulp of each row's largest value
    assert np.all(np.abs(d - d_j) <= np.spacing(np.abs(d_j).max(axis=1, keepdims=True)))
    loss_own, res_own = j["own"]
    assert int(res["n_samples_needed"]) > 300
    for k in TELEMETRY:
        assert int(res[k]) == int(res_own[k]), k
    np.testing.assert_allclose(float(loss.detach()), float(loss_own), rtol=1e-5)
    img = res["image"].detach().numpy()
    assert _psnr(img, np.asarray(res_own["image"], np.float64)) >= 60.0
    with torch.no_grad():
        plain, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"],
                               t["bg_coords"], t["pose6"], t["eye"], INDEX, t["bg_color"],
                               noises=t["noises"])
    assert _psnr(plain["image"].numpy(), img) < 40.0


def test_camera_train_step_gradients_match_jax(step_run):
    """At the same offset rays, the step's loss within rel 1e-5 of JAX's and
    the gradients of ``camera_dR``, ``camera_dT`` and the grid tables within
    1e-4 of each one's largest (float32 sums in another order); only frame
    INDEX's camera row takes a gradient."""
    j, (loss, _, net), _ = step_run
    (loss_j, _), grads_j = j["grad"]
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    want = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(net.named_parameters())
    for name in ("camera_dR", "camera_dT", "encoder", "encoder_ambient"):
        g, w = got[name].grad.numpy(), want[name]
        tol = 1e-4 * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= tol, name
    for name in ("camera_dR", "camera_dT"):
        g = got[name].grad.numpy()
        assert np.abs(g[INDEX]).min() > 0.0, name
        assert not np.delete(g, INDEX, axis=0).any(), name


def test_recomputed_positions_equal_the_march(step_run):
    """The positions formed again under autograd from the march's t equal
    the march's own xyz on every valid slot, bit for bit; at a clamp tie
    the gradient splits as jnp.clip's does."""
    from radnerf_tpu_torch.models.renderer import march_window
    from radnerf_tpu_torch.ops import march_rays, near_far_from_aabb

    _, (_, _, net), (t, rc, state) = step_run
    with torch.no_grad():
        o, d = camera_offsets(net, INDEX, t["rays_o"], t["rays_d"])
        nears, fars = near_far_from_aabb(o, d, o.new_tensor(rc.aabb), rc.min_near)
        march = march_rays(o, d, nears, fars, state.sigma_bytes, rc.march_config(),
                           march_window(state, o, d, nears, fars), rc.cull_T, t["noises"])
        xyz = sample_positions(o, d, march["t"], rc.bound)
    valid = march["valid"]
    assert int(valid.sum()) > 300
    assert torch.equal(xyz[valid], march["xyz"][valid])

    x = torch.tensor([[0.5, 0.0, 0.0]], requires_grad=True)
    p = sample_positions(x, torch.tensor([[1.0, 2.0, -3.0]]), torch.tensor([[0.5]]), 1.0)
    p.sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v + 0.5 * jnp.asarray([1.0, 2.0, -3.0]),
                                               -1.0, 1.0)))(jnp.asarray([0.5, 0.0, 0.0]))
    np.testing.assert_array_equal(x.grad.numpy()[0], np.asarray(want))
    assert x.grad.numpy()[0].tolist() == [0.5, 0.5, 0.0]


def test_camera_parameters_through_checkpoints_and_convert(cam_params, tmp_path):
    """``camera_dR`` / ``camera_dT`` go through ``convert`` both ways and
    the port's checkpoint exactly, and their Adam moments through a full
    checkpoint; the torso stage freezes them, as JAX's param_groups does,
    and ``freeze_loaded_head`` loads them from the head checkpoint."""
    net = network_from_jax(cam_params, NetworkConfig(**CAM), device="cpu")
    back = network_to_jax(net)
    for k in ("camera_dR", "camera_dT"):
        np.testing.assert_array_equal(back[k], cam_params[k])
        np.testing.assert_array_equal(jax_from_state_dict(_state_dict_from_jax(back))[k],
                                      cam_params[k])

    rc = RenderConfig(**RC)
    opt = Options(exp_eye=True, train_camera=True, iters=100, dt_gamma=0.0)
    tr = Trainer(opt, NetworkConfig(**CAM), rc, device="cpu", workspace=str(tmp_path))
    with torch.no_grad():
        tr.net.camera_dR.copy_(torch.from_numpy(cam_params["camera_dR"]))
        tr.net.camera_dT.copy_(torch.from_numpy(cam_params["camera_dT"]))
    assert {g["name"] for g in tr.optimizer.param_groups} >= {"camera"}
    cam_group = next(g for g in tr.optimizer.param_groups if g["name"] == "camera")
    assert cam_group["lr"] == 1e-5 and len(cam_group["params"]) == 2
    for p in (tr.net.camera_dR, tr.net.camera_dT):
        p.grad = torch.full_like(p, 0.5)
    for p in tr.net.parameters():
        if p.grad is None and p.requires_grad:
            p.grad = torch.zeros_like(p)
    tr.optimizer.step()
    tr.save_checkpoint("cam", full=True)
    path = os.path.join(tr.ckpt_path, "cam.npz")
    params, _, _, opt_flat, _ = load_checkpoint(path)
    for k in ("camera_dR", "camera_dT"):
        np.testing.assert_array_equal(params[k], getattr(tr.net, k).detach().numpy())

    tr2 = Trainer(opt, NetworkConfig(**CAM), rc, device="cpu", workspace=str(tmp_path),
                  use_checkpoint=path)
    for k in ("camera_dR", "camera_dT"):
        p1, p2 = getattr(tr.net, k), getattr(tr2.net, k)
        assert torch.equal(p1, p2), k
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(tr.optimizer.state[p1][m], tr2.optimizer.state[p2][m]), (k, m)

    # the torso stage: both packages freeze the camera offsets
    groups_j = j_param_groups(JNetworkConfig(**CAM, torso=True))
    groups = param_groups(NetworkConfig(**CAM, torso=True))
    assert groups["camera_dR"] == groups_j["camera_dR"] == "frozen"
    assert param_groups(NetworkConfig(**CAM))["camera_dT"] == \
        j_param_groups(JNetworkConfig(**CAM))["camera_dT"] == "camera"
    torso = Trainer(Options(torso=True, exp_eye=True, train_camera=True),
                    NetworkConfig(**CAM, torso=True), RenderConfig(**RC, torso=True),
                    device="cpu")
    torso.freeze_loaded_head(path)
    for k in ("camera_dR", "camera_dT"):
        p = getattr(torso.net, k)
        assert not p.requires_grad and torch.equal(p, getattr(tr.net, k)), k
    assert not any(p is torso.net.camera_dR for g in torso.optimizer.param_groups
                   for p in g["params"])


def test_jax_camera_adam_state_resumes(cam_params, tmp_path):
    """A JAX optimizer state with ``train_camera`` after two optax updates
    on numpy gradients, saved in a JAX checkpoint: the port's Adam takes
    its camera moments exactly."""
    from radnerf_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
    from radnerf_tpu.train.trainer import build_optimizer as j_build_optimizer

    tx = j_build_optimizer(JNetworkConfig(**CAM), JOptions(train_camera=True, iters=100))
    params = jax.tree_util.tree_map(jnp.asarray, cam_params)
    opt_state = tx.init(params)
    rng = np.random.default_rng(33)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda v: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)), params)
        _, opt_state = jax.jit(tx.update)(g, opt_state, params)
    path = str(tmp_path / "jax.npz")
    j_save_checkpoint(path, params, opt_state=opt_state, meta={"epoch": 1, "global_step": 2})
    tr = Trainer(Options(exp_eye=True, train_camera=True, iters=100, dt_gamma=0.0),
                 NetworkConfig(**CAM), RenderConfig(**RC), device="cpu")
    tr.load_checkpoint(path)
    adam = opt_state.inner_states["camera"].inner_state[0]
    for k in ("camera_dR", "camera_dT"):
        state = tr.optimizer.state[getattr(tr.net, k)]
        np.testing.assert_array_equal(state["exp_avg"].numpy(), np.asarray(adam.mu[k]))
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]))
        assert float(state["step"]) == 2
    assert tr.scheduler.last_epoch == 2


def test_main_trains_camera_offsets(small, data_dir, tmp_path):  # noqa: F811
    """``main --train_camera`` on the CPU (two frames, one epoch): steps
    taken, finite losses, the camera offsets of the trained frames moved off
    zero and saved."""
    ws = str(tmp_path / "ws")
    tr = main(_args(data_dir, ws, "--train_camera", "--data_range", "0", "2", "--iters", "2",
                    "--ckpt", "scratch"), device="cpu")
    assert tr.global_step == 2 and np.all(np.isfinite(tr.stats["step_loss"]))
    dR = tr.net.camera_dR.detach()
    assert tr.net.camera_dR.requires_grad and float(dR.abs().max()) > 0.0
    params = load_checkpoint(os.path.join(tr.ckpt_path, "ngp_ep0001.npz"))[0]
    np.testing.assert_array_equal(params["camera_dR"], dR.numpy())

