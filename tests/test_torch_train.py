"""The port's head-stage training path against the JAX package's, on the CPU:
the same numpy inputs (and numpy noises) go through both.

On CPU tensors the kernel wrappers run their plain versions and autograd
runs through their plain ops, so these tests hold the plain semantics (and
the gradients) to JAX's. The JAX side runs op by op (not under ``jit``)
where a sample set has to match exactly: inside a fused ``jit`` graph
XLA:CPU contracts ``a*b + c`` into an FMA (``t0 + dt * noise``,
``o + t * d``), which can move a sample into the next cell.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import RendererState as JRendererState
from radnerf_tpu.models import compute_occ_bbox, init_params
from radnerf_tpu.models import mark_untrained_grid as j_mark_untrained
from radnerf_tpu.models import render_rays as j_render_rays
from radnerf_tpu.models import update_density_grid as j_update_density_grid
from radnerf_tpu.models.network import encode_audio
from radnerf_tpu.models.network import param_groups as j_param_groups
from radnerf_tpu.models.renderer import compute_occ_sphere
from radnerf_tpu.ops import marching as jmarch
from radnerf_tpu.ops import morton as jmorton
from radnerf_tpu.ops.grid_encode import GridSpec as JGridSpec
from radnerf_tpu.ops.grid_encode import grid_encode01
from radnerf_tpu.ops.ray_aabb import near_far_from_aabb as j_near_far
from radnerf_tpu.data.rays import convert_poses as j_convert_poses
from radnerf_tpu.data.rays import get_audio_features as j_get_audio_features
from radnerf_tpu.train.losses import head_loss as j_head_loss
from radnerf_tpu.train.trainer import build_optimizer as j_build_optimizer
from radnerf_tpu.utils.color import srgb_to_linear as j_srgb_to_linear

from radnerf_tpu_torch import ops as T
from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import (
    _state_dict_from_jax,
    load_jax_params,
    network_from_jax,
    state_from_numpy,
)
from radnerf_tpu_torch.data import convert_poses, get_audio_features
from radnerf_tpu_torch.models import (
    NeRFNetwork,
    NetworkConfig,
    RenderConfig,
    RendererState,
    mark_untrained_grid,
    param_groups,
    render_rays,
    reset_extra_state,
    update_density_grid,
)
from radnerf_tpu_torch.train import Trainer, build_optimizer, head_loss
from radnerf_tpu_torch.utils import srgb_to_linear

from test_torch_kernels import composite_rows
from test_train import data_dir  # noqa: F401  (the on-disk dataset fixture)

REPO = Path(__file__).resolve().parents[1]
GRID = 32
TELEMETRY = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span")


def _T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


# a narrow head-stage model: 4 grid levels, 32-wide MLPs, 8 codes
SMALL = dict(exp_eye=True, ind_num=8, grid_levels=4, hidden_dim=32, geo_feat_dim=15,
             hidden_dim_color=32, hidden_dim_ambient=32)


@pytest.fixture(scope="module")
def head_params():
    """JAX init_params of the narrow model with its grid tables drawn
    U(-1, 1) (the init's U(-1e-4, 1e-4) times 1e4) so the tables shape the
    field; numpy leaves."""
    cfg = JNetworkConfig(**SMALL)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: init_params(k, cfg))(jax.random.PRNGKey(11)))
    for k in ("encoder", "encoder_ambient"):
        params[k] = params[k] * 1e4
    return params


def _port_net(params):
    return network_from_jax(params, NetworkConfig(**SMALL), device="cpu")


# ------------------------------------------------------------------ march
def test_march_with_noises_matches_jax():
    """Perturbed march (t0 = near + dt * noise, k0 from the perturbed t0)
    against JAX op by op: identical valid and per-ray counts, t and xyz
    within 1e-5; the noises really move the samples."""
    from test_torch_ops import _blob_scene

    H = GRID
    cfg_j = jmarch.MarchConfig(bound=1.0, grid_size=H, max_steps=8, dt_gamma=0.0)
    cfg_t = T.MarchConfig(bound=1.0, grid_size=H, max_steps=8, dt_gamma=0.0)
    dens, o, d, rng = _blob_scene(H)
    aabb = jnp.asarray([-1.0, -0.5, -1.0, 1.0, 0.5, 1.0])
    nears, fars = (_np(v) for v in j_near_far(jnp.asarray(o), jnp.asarray(d), aabb, 0.05))
    t_lo = (nears + rng.uniform(0.0, 0.4, nears.shape)).astype(np.float32)
    t_hi = (fars - rng.uniform(0.0, 0.4, fars.shape)).astype(np.float32)
    noises = rng.random(nears.shape).astype(np.float32)
    sb_j = jmarch.build_sigma_bytes(jnp.asarray(dens), 5.0)
    want = jmarch.march_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears), jnp.asarray(fars), None, cfg_j,
        noises=jnp.asarray(noises), t_window=(jnp.asarray(t_lo), jnp.asarray(t_hi)),
        sigma_rows=jmarch.pack_sigma_byte_rows(sb_j), cull_T=1e-4)
    args = (_T(o), _T(d), _T(nears), _T(fars), T.build_sigma_bytes(_T(dens), 5.0), cfg_t,
            (_T(t_lo), _T(t_hi)), 1e-4)
    got = T.march_rays(*args, noises=_T(noises))
    valid = _np(want["valid"])
    assert valid.sum() > 100
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k in ("t", "dt", "xyz"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-5, rtol=0)
    assert int(got["count"].max()) == int(want["max_count"])
    plain = T.march_rays(*args)
    assert not torch.equal(plain["t"], got["t"])


# ------------------------------------------------------- grid-encode grads
def _grid_points(layout, n, input_dim, rng):
    """Points in the box laid out as the grid encoders meet them: "spread"
    uniform; "ray" runs of 16 samples 0.02 apart along straight rays, the
    march's order (neighbours share cells at the coarse levels); "collapsed"
    every point within 1e-4 of one spot, the untrained ambient MLP's output
    (every point adds into the same rows at every level)."""
    if layout == "spread":
        return rng.uniform(-0.98, 0.98, (n, input_dim)).astype(np.float32)
    if layout == "ray":
        o = rng.uniform(-0.6, 0.6, (n // 16, 1, input_dim))
        d = rng.normal(size=(n // 16, 1, input_dim))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (o + 0.02 * np.arange(16)[:, None] * d).reshape(n, input_dim).astype(np.float32)
    return (rng.uniform(-0.5, 0.5, input_dim)
            + rng.uniform(-1e-4, 1e-4, (n, input_dim))).astype(np.float32)


# the uniform-spread cases keep their earlier ids ("2", "3")
@pytest.mark.parametrize("layout,input_dim", [
    pytest.param(layout, dim, id=str(dim) if layout == "spread" else f"{layout}-{dim}")
    for layout in ("spread", "ray", "collapsed") for dim in (2, 3)])
def test_grid_encode_gradients_match_jax(layout, input_dim):
    """Table and x gradients of the grid encode against jax.grad of
    grid_encode01 (op by op) at the shipped 16x2 shape, with points in and
    out of the box, spread, in rays and collapsed onto one spot (the
    contended cases kernel A' combines): atol 1e-6, rtol 1e-5 (float32 sums
    in another order)."""
    kw = dict(input_dim=input_dim, num_levels=16, level_dim=2, base_resolution=16,
              log2_hashmap_size=16, desired_resolution=2048)
    jspec, tspec = JGridSpec.create(**kw), T.GridSpec.create(**kw)
    rng = np.random.default_rng(input_dim + 10)
    emb = rng.normal(size=(jspec.n_embeddings, 2)).astype(np.float32)
    x = _grid_points(layout, 192, input_dim, rng)
    x[0, 0] = 1.2  # outside the box: zero gradient for both
    g = rng.normal(size=(192, 32)).astype(np.float32)
    bound = 1.0

    def f(xj, ej):
        return jnp.sum(grid_encode01((xj + bound) / (2.0 * bound), ej, jspec) * jnp.asarray(g))

    want_x, want_t = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    xt = _T(x).requires_grad_(True)
    et = _T(emb).requires_grad_(True)
    (T.grid_encode(xt, et, tspec, bound) * _T(g)).sum().backward()
    np.testing.assert_allclose(et.grad.numpy(), _np(want_t), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), _np(want_x), atol=1e-6, rtol=1e-5)
    assert np.all(xt.grad.numpy()[0] == 0.0) and np.abs(_np(want_x)).max() > 1.0
    # the backward wrapper's plain version gives the same, and skips x on request
    g_table, g_x = T.grid_encode_backward(_T(x), _T(emb), _T(g), tspec, bound)
    np.testing.assert_array_equal(g_table.numpy(), et.grad.numpy())
    np.testing.assert_array_equal(g_x.numpy(), xt.grad.numpy())
    assert T.grid_encode_backward(_T(x), _T(emb), _T(g), tspec, bound, need_x=False)[1] is None


# --------------------------------------------------------- composite grads
# the earlier case keeps its id ("dense-16") and its rows
@pytest.mark.parametrize("layout,S", [("dense", 16), ("sparse", 16), ("empty", 16),
                                      ("stop-first", 16), ("stop-last", 16),
                                      ("dense", 13), ("sparse", 13)],
                         ids=lambda v: str(v))
def test_composite_gradients_match_jax(layout, S):
    """d sigma, d rgb and d ambient of composite_rays against jax.grad on
    the row layouts kernel C' is held to on the card (tests/test_torch_kernels.py
    composite_rows): rays whose transmittance crosses T_thresh mid-lattice
    with invalid holes, sparse and empty rows, rows that stop at their
    first or last slot, and S = 13. atol 1e-6, rtol 1e-5."""
    rng = np.random.default_rng(21)
    N = 256
    sig, rgb, dts, ts, valid, amb = composite_rows(layout, N, S, rng)
    keys = ("image", "depth", "weights_sum", "ambient_sum")
    gs = {k: rng.normal(size=(N, 3) if k == "image" else (N,)).astype(np.float32)
          for k in keys}

    def f(s_, r_, a_):
        out = jmarch.composite_rays(s_, r_, jnp.asarray(dts), jnp.asarray(ts),
                                    jnp.asarray(valid), ambient=a_, T_thresh=1e-4)
        return sum(jnp.sum(out[k] * jnp.asarray(gs[k])) for k in keys)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(amb))
    got = T.composite_rays_backward(_T(sig), _T(rgb), _T(dts), _T(ts), _T(valid), _T(amb),
                                    {k: _T(v) for k, v in gs.items()}, None, T_thresh=1e-4)
    for gt_, w in zip(got, want):
        np.testing.assert_allclose(gt_.numpy(), _np(w), atol=1e-6, rtol=1e-5)
    # invalid steps get exactly zero
    assert all(np.all(g.numpy()[~valid] == 0.0) for g in got)


# ------------------------------------------------------ one head train step
def _blob_state_j(rc_j, grid, thresh):
    g = jnp.asarray(grid)
    return JRendererState.create(rc_j).replace(
        density_grid=g, density_bitfield=jmorton.packbits(g, thresh),
        mean_density=jnp.asarray(1.0, jnp.float32),
        occ_bbox=compute_occ_bbox(rc_j, g, thresh),
        occ_sphere=compute_occ_sphere(rc_j, g, thresh),
    ).with_sigma_bytes(jmarch.build_sigma_bytes(g, thresh))


def test_head_train_step_matches_jax(head_params):
    """One head-stage train step on tests/test_torch_render.py's 48x48 blob
    scene, 512 rays, JAX at exhaustive capacities, the same noises: loss to
    rel 1e-5, identical telemetry, and every parameter's gradient within
    1e-4 * max|g_jax| + 1e-7 (float32 GEMM and scatter sums in another
    order, through the grid encodes, the MLPs and the compositor). The JAX
    step runs under jit; the identical telemetry shows that no contracted
    FMA moved a sample to another cell."""
    from radnerf_tpu.data.rays import get_bg_coords, get_rays
    from test_train import _blob_grid

    params = head_params
    rng = np.random.default_rng(12)
    n = 512
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, 24.0, 24.0), 48, 48, n, rng=rng)
    f = dict(
        rays_o=rays["rays_o"], rays_d=rays["rays_d"],
        bg_coords=get_bg_coords(48, 48)[rays["inds"]],
        pose6=np.zeros((1, 6), np.float32),
        auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
        bg_color=rng.random((n, 3)).astype(np.float32),
        eye=np.array([[0.25]], np.float32),
        images=rng.random((n, 3)).astype(np.float32),
        noises=rng.random(n).astype(np.float32),
    )
    face_mask = rng.random(n) < 0.5
    index, step, iters = 3, 40, 100
    grid = _blob_grid(GRID)
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, exp_eye=True,
                         sample_capacity_mult=16.0, ray_capacity_frac=1.0, cull_T=1e-6)
    state_j = _blob_state_j(rc_j, grid, 1.0)
    cfg_j = JNetworkConfig(**SMALL)
    a = {k: jnp.asarray(v) for k, v in f.items()}

    def loss_fn(p):
        res, _ = j_render_rays(p, cfg_j, rc_j, state_j, a["rays_o"], a["rays_d"], a["auds"],
                               a["bg_coords"], a["pose6"], a["eye"],
                               jnp.asarray(index, jnp.int32), a["bg_color"],
                               noises=a["noises"], training=True)
        loss = j_head_loss(res, a["images"], jnp.asarray(face_mask),
                           jnp.asarray(step, jnp.float32), iters, 0.1)
        return loss, {k: res[k] for k in TELEMETRY}

    (loss_j, tel_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))

    net = _port_net(params)
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=1e-6)
    state = state_from_numpy(rc, grid, np.zeros(GRID * GRID, np.float32), 1.0, 0.0,
                             thresh=1.0, device="cpu")
    t = {k: _T(v) for k, v in f.items()}
    res, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"], t["bg_coords"],
                         t["pose6"], t["eye"], index, t["bg_color"], noises=t["noises"],
                         training=True)
    loss = head_loss(res, t["images"], _T(face_mask), step, iters, 0.1)
    loss.backward()

    assert int(res["n_samples_needed"]) > 300
    for k in TELEMETRY:
        assert int(res[k]) == int(tel_j[k]), k
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    want = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(net.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        tol = 1e-4 * float(np.abs(w).max()) + 1e-7
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"{name}: max |g - g_jax| {err} > {tol}"
    assert float(np.abs(want["encoder"]).max()) > 0 and \
        float(np.abs(want["individual_codes"][index]).max()) > 0


def test_render_rays_training_raises_for_unported_parts():
    """Training camera offsets raise in render_rays, the LPIPS term (lips
    finetune, patch training) in the Trainer; the torso stage trains."""
    cfg = NetworkConfig(exp_eye=True, ind_num=4, train_camera=True)
    net = NeRFNetwork(cfg, device="cpu")
    rc = RenderConfig(grid_size=16)
    st = RendererState.create(rc, device="cpu")
    z3, z = torch.zeros(4, 3), torch.zeros(4, 2)
    with pytest.raises(NotImplementedError):
        render_rays(net, rc, st, z3, z3, None, z, torch.zeros(1, 6), None, 0, z3,
                    training=True)
    small = NetworkConfig(**SMALL)
    for opt in (Options(finetune_lips=True), Options(patch_size=32)):
        with pytest.raises(NotImplementedError, match="LPIPS"):
            Trainer(opt, small, rc, device="cpu")
    assert Trainer(Options(torso=True), NetworkConfig(**SMALL, torso=True),
                   RenderConfig(grid_size=16, torso=True), device="cpu").opt.torso


def test_audio_labels_keep_their_type(head_params):
    """With ``emb``, the audio windows are int64 labels: the trainer's
    to_device and its grid upkeep keep them integers (JAX's jnp.asarray keeps
    the dtype), and the port's encode_audio of them equals JAX's to rel
    1e-5."""
    from types import SimpleNamespace

    cfg_j = JNetworkConfig(**SMALL, emb=True)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: init_params(k, cfg_j))(jax.random.PRNGKey(17)))
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    tr = Trainer(Options(emb=True, exp_eye=True), NetworkConfig(**SMALL, emb=True), rc,
                 device="cpu")
    load_jax_params(tr.net, params)
    rng = np.random.default_rng(18)
    labels = rng.integers(0, 44, size=(10, 16))
    batch = tr.to_device({"auds": labels[:8], "index": 2, "face_mask": labels[0] > 20,
                          "bg_color": rng.random((4, 3)), "H": 48})
    assert batch["auds"].dtype == torch.int64 and batch["face_mask"].dtype == torch.bool
    assert batch["bg_color"].dtype == torch.float32 and batch["H"] == 48
    with torch.no_grad():
        got = tr.net.encode_audio(batch["auds"]).numpy()
    want = np.asarray(encode_audio(jax.tree_util.tree_map(jnp.asarray, params), cfg_j,
                                   jnp.asarray(labels[:8])))
    assert got.shape == want.shape == (1, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    tr.update_extra_state(SimpleNamespace(auds=labels, eye_area=np.full((10, 1), 0.25),
                                          poses=pose[None].repeat(10, 0)))
    assert float(tr.state.mean_density) > 0


def test_smooth_lips_code_advances_across_steps(head_params):
    """With ``smooth_lips`` the trainer keeps the state each step's render
    leaves: after two train steps its audio-code EMA equals the one two JAX
    renders carry, to rel 1e-5, and the second backward runs (the state
    holds the code detached, not the first step's graph). The learning
    rates are 0, so both steps see the same weights."""
    from radnerf_tpu.data.rays import get_bg_coords, get_rays
    from test_train import _blob_grid

    rng = np.random.default_rng(19)
    n = 256
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    opt = Options(smooth_lips=True, lr=0.0, lr_net=0.0, exp_eye=True, iters=100,
                  dt_gamma=0.0)
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, smooth_lips=True)
    tr = Trainer(opt, NetworkConfig(**SMALL), rc, device="cpu")
    load_jax_params(tr.net, head_params)
    grid = _blob_grid(GRID)
    tr.state = state_from_numpy(rc, grid, np.zeros(GRID * GRID, np.float32), 1.0, 0.0,
                                thresh=1.0, device="cpu")
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, exp_eye=True,
                         smooth_lips=True, sample_capacity_mult=16.0, ray_capacity_frac=1.0)
    state_j = _blob_state_j(rc_j, grid, 1.0)
    params_j = jax.tree_util.tree_map(jnp.asarray, head_params)
    render_j = jax.jit(lambda s, a, i: j_render_rays(
        params_j, JNetworkConfig(**SMALL), rc_j, s, a["rays_o"], a["rays_d"], a["auds"],
        a["bg_coords"], a["poses"], a["eye"], i, a["bg_color"], training=True)[1])
    for step in range(2):
        rays = get_rays(pose, (80.0, 80.0, 24.0, 24.0), 48, 48, n, rng=rng)
        batch = dict(rays_o=rays["rays_o"], rays_d=rays["rays_d"], index=step,
                     bg_coords=get_bg_coords(48, 48)[rays["inds"]],
                     poses=np.zeros((1, 6), np.float32),
                     auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
                     eye=np.array([[0.25]], np.float32),
                     bg_color=rng.random((n, 3)).astype(np.float32),
                     images=rng.random((n, 3)).astype(np.float32),
                     face_mask=rng.random(n) < 0.5)
        tr.global_step += 1
        loss = tr.train_step(tr.to_device(batch))
        assert np.isfinite(float(loss))
        state_j = render_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()
                                     if k != "index"}, jnp.asarray(step, jnp.int32))
    got, want = tr.state.enc_a_smooth, np.asarray(state_j.enc_a_smooth)
    assert bool(tr.state.enc_a_initialized) and not got.requires_grad
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# --------------------------------------------------------------- optimizer
def test_optimizer_matches_optax(head_params):
    """The same numpy gradients for 3 steps into optax's build_optimizer and
    the port's (per-group Adam, eps 1e-15, the 0.1 ** (step / iters) decay
    stepped after each update): parameters to 1e-6 relative; near zero, to
    1e-7 of the tensor's largest value, since there a parameter is the
    difference of two numbers rounded at that scale (an ulp apart here)."""
    cfg_j = JNetworkConfig(**SMALL)
    jopt = JOptions(iters=10)
    params = head_params
    net = _port_net(params)
    assert param_groups(net.cfg) == j_param_groups(cfg_j)
    optimizer, scheduler = build_optimizer(net, Options(iters=10))
    tx = j_build_optimizer(cfg_j, jopt)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p_j)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(31)
    named = dict(net.named_parameters())
    for _ in range(3):
        g_np = jax.tree_util.tree_map(
            lambda v: rng.normal(size=v.shape).astype(np.float32) * 1e-3, params)
        updates, opt_state = update(jax.tree_util.tree_map(jnp.asarray, g_np), opt_state, p_j)
        p_j = jax.tree_util.tree_map(lambda p, u: p + u, p_j, updates)
        for name, v in _state_dict_from_jax(g_np).items():
            named[name].grad = torch.from_numpy(np.ascontiguousarray(v))
        optimizer.step()
        scheduler.step()
    want = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
    for name, w in want.items():
        np.testing.assert_allclose(named[name].detach().numpy(), w, rtol=1e-6,
                                   atol=1e-7 * float(np.abs(w).max()), err_msg=name)


# ----------------------------------------------------------- grid upkeep
def test_update_density_grid_matches_jax(head_params):
    """update_density_grid at grid 32 with JAX's own jitter draws (split,
    then uniform(-half, half) per cascade), JAX op by op (under jit, a
    contracted FMA moves a jittered point by an ulp, and the finest level's
    slope of ~2048 per unit turns that into 1e-4 of sigma): the grid to rtol
    1e-4 (field GEMM order), mean density to 1e-5, the bitfield identical
    away from the threshold; cells at -1 stay -1."""
    params = head_params
    rng = np.random.default_rng(41)
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, exp_eye=True)
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    grid0 = rng.uniform(0.0, 3.0, (1, GRID**3)).astype(np.float32)
    grid0[:, rng.random(GRID**3) < 0.2] = -1.0
    cfg_j = JNetworkConfig(**SMALL)
    auds = rng.normal(size=(8, 44, 16)).astype(np.float32)
    eye = np.array([[0.3]], np.float32)
    params_j = jax.tree_util.tree_map(jnp.asarray, params)
    enc_a = encode_audio(params_j, cfg_j, jnp.asarray(auds))
    key = jax.random.PRNGKey(5)

    state_j = JRendererState.create(rc_j).replace(density_grid=jnp.asarray(grid0))
    want = j_update_density_grid(params_j, cfg_j, rc_j, state_j, enc_a, jnp.asarray(eye), key)
    jitter, k = [], key
    for cas in range(rc_j.cascade):
        half = min(2**cas, rc_j.bound) / GRID
        k, sub = jax.random.split(k)
        jitter.append(_T(_np(jax.random.uniform(sub, (GRID**3, 3), minval=-half,
                                                maxval=half))))

    net = _port_net(params)
    state = reset_extra_state(rc, RendererState.create(rc, device="cpu"))
    state.density_grid = _T(grid0)
    with torch.no_grad():
        enc_t = net.encode_audio(_T(auds))
    got = update_density_grid(net, rc, state, enc_t, _T(eye), jitter=jitter)

    g_j = _np(want.density_grid)
    np.testing.assert_allclose(got.density_grid.numpy(), g_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.density_grid.numpy() == -1.0, g_j == -1.0)
    np.testing.assert_allclose(float(got.mean_density), float(want.mean_density), rtol=1e-5)
    thresh = min(float(want.mean_density), rc.density_thresh)
    far = np.abs(g_j - thresh) > 1e-3 * thresh
    bits = T.unpackbits(got.density_bitfield, 1, GRID).numpy()
    bits_j = _np(jmorton.unpackbits(want.density_bitfield, 1, GRID))
    np.testing.assert_array_equal(bits[far], bits_j[far])
    assert 0.05 < bits_j.mean() < 0.95  # the threshold splits the grid


def test_mark_untrained_grid_exact():
    rng = np.random.default_rng(51)
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    poses = []
    for ang in (0.0, 0.6, -0.9):
        c, s = math.cos(ang), math.sin(ang)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        pose[:3, 3] = pose[:3, :3] @ np.array([0.0, 0.0, -2.5], np.float32)
        poses.append(pose)
    poses = np.stack(poses).astype(np.float32)
    intr = (150.0, 150.0, 24.0, 24.0)
    grid0 = rng.uniform(0, 1, (1, GRID**3)).astype(np.float32)
    want = j_mark_untrained(rc_j, JRendererState.create(rc_j).replace(
        density_grid=jnp.asarray(grid0)), jnp.asarray(poses), intr)
    st = RendererState.create(rc, device="cpu")
    st.density_grid = _T(grid0)
    got = mark_untrained_grid(rc, st, poses, intr)
    np.testing.assert_array_equal(got.density_grid.numpy(), _np(want.density_grid))
    assert 0.05 < (got.density_grid.numpy() == -1).mean() < 0.95


def test_morton_dilate_and_unpackbits_exact():
    rng = np.random.default_rng(61)
    H = 16
    grid = np.where(rng.random((2, H**3)) < 0.05, rng.uniform(0, 5, (2, H**3)), -1.0)
    grid = grid.astype(np.float32)
    np.testing.assert_array_equal(T.morton_dilate(_T(grid), H).numpy(),
                                  _np(jmorton.morton_dilate(jnp.asarray(grid), H)))
    bits = rng.integers(0, 256, (2 * H**3 // 8,)).astype(np.uint8)
    np.testing.assert_array_equal(T.unpackbits(_T(bits), 2, H).numpy(),
                                  _np(jmorton.unpackbits(jnp.asarray(bits), 2, H)))
    np.testing.assert_array_equal(T.packbits(T.unpackbits(_T(bits), 2, H), 0).numpy(), bits)


def test_head_loss_pose_audio_helpers_match_jax():
    rng = np.random.default_rng(71)
    n = 300
    res = {"image": rng.random((n, 3)).astype(np.float32),
           "weights_sum": np.concatenate([[0.0, 1.0], rng.random(n - 2)]).astype(np.float32),
           "ambient": rng.random(n).astype(np.float32)}
    gt = rng.random((n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.4
    for step in (0, 37, 500):
        want = j_head_loss({k: jnp.asarray(v) for k, v in res.items()}, jnp.asarray(gt),
                           jnp.asarray(mask), jnp.asarray(step, jnp.float32), 200, 0.1)
        got = head_loss({k: _T(v) for k, v in res.items()}, _T(gt), _T(mask), step, 200, 0.1)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(srgb_to_linear(_T(gt)).numpy(),
                               _np(j_srgb_to_linear(jnp.asarray(gt))), rtol=1e-6, atol=1e-7)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[1, :3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    poses[:, :3, 3] = rng.normal(size=(2, 3))
    np.testing.assert_array_equal(convert_poses(poses), j_convert_poses(poses))
    feats = rng.normal(size=(6, 44, 16)).astype(np.float32)
    for att in (0, 1, 2):
        for i in (0, 3, 5):
            np.testing.assert_array_equal(get_audio_features(feats, att, i),
                                          j_get_audio_features(feats, att, i))


# -------------------------------------------------------------- row gather
def test_take_rows_matches_pallas_row_loop(tmp_path, monkeypatch):
    """take_rows against scripts/bench_gather.py's Pallas row-loop gather in
    interpret mode, at T = 4096, P = 8192, W = 16 bf16: bit for bit."""
    monkeypatch.setenv("INTERPRET", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location(
        "bench_gather_interpret", REPO / "scripts" / "bench_gather.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    table, idx = T.rowgather.study_inputs(4096, 8192, 16, seed=3, device="cpu")
    want = bench.pallas_row_loop(jnp.asarray(table.float().numpy()).astype(jnp.bfloat16),
                                 jnp.asarray(idx.numpy()))
    got = T.take_rows(table, idx)
    assert got.shape == (8192, 16) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  _np(want).view(np.int16))
    study = T.bench_gather_study(P=4096, tables=(64, 512), device="cpu")
    assert all(r["equal"] and r["max_abs_err"] == 0.0 for r in study.values())
    assert study[512]["idx"].shape == (4096,) and study[512]["table"].shape == (512, 16)


# ------------------------------------------------------------ the trainer
def test_trainer_steps_on_talking_head_dataset(data_dir, tmp_path):  # noqa: F811
    """A few port Trainer steps on the JAX package's on-disk dataset
    (tests/test_train.py's fixture): finite losses, a non-empty grid after
    the upkeep, the untrained cells marked, an EMA that moved."""
    from radnerf_tpu.data import TalkingHeadDataset

    jopt = JOptions(path=data_dir, workspace=str(tmp_path), num_rays=512, exp_eye=True,
                    iters=100, dt_gamma=0.0)
    ds = TalkingHeadDataset(jopt, split="train")
    opt = Options(num_rays=512, exp_eye=True, iters=100, dt_gamma=0.0,
                  update_extra_interval=2, ema_update_interval=2)
    tr = Trainer(opt, NetworkConfig(exp_eye=True, ind_num=8),
                 RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0), device="cpu",
                 ema_decay=0.9)
    ema0 = tr.ema_params["sigma_net.layers.0.weight"].clone()
    tr.train(ds, max_epochs=1)
    assert tr.global_step == len(ds) and len(tr.stats["loss"]) == 1
    assert np.isfinite(tr.stats["loss"][0])
    assert float(tr.state.mean_density) > 0
    assert int(tr.telemetry["n_samples_needed"]) > 0
    assert bool((tr.state.density_grid == -1).any())
    assert not torch.equal(ema0, tr.ema_params["sigma_net.layers.0.weight"])
