"""Checkpoints between the port and the JAX package, on the CPU: a JAX
checkpoint loads into the port and a port checkpoint into JAX, both with
exact parameters and the same 48x48 frame; a resumed port run equals an
uninterrupted one bit for bit; a reference .pth imports to the JAX
package's parameters; grid-shape checks, the rolling window and the latest
checkpoint."""

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
from radnerf_tpu.train import Trainer as JTrainer
from radnerf_tpu.train import import_torch_checkpoint as j_import_torch_checkpoint
from radnerf_tpu.train.checkpoint import _flatten as j_flatten

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import (
    _state_dict_from_jax,
    load_jax_params,
    network_to_jax,
    state_from_numpy,
)
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig, render_rays
from radnerf_tpu_torch.train import Trainer, import_torch_checkpoint, latest_checkpoint
from radnerf_tpu_torch.train.checkpoint import _flatten

from test_torch_torso import SMALL_T, torso_params  # noqa: F401  (fixture)
from test_torch_train import GRID, SMALL, _blob_state_j

H = W = 48
TELEMETRY = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span", "n_torso_mask")
RC = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0, torso=True)
RC_J = dict(RC, exp_eye=True, sample_capacity_mult=16.0, ray_capacity_frac=1.0,
            torso_capacity_frac=1.0)


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


@pytest.fixture(scope="module")
def scene():
    """The 48x48 frame's rays and inputs, a blob head grid and a torso grid."""
    from radnerf_tpu.data.rays import get_bg_coords, get_rays
    from test_train import _blob_grid

    rng = np.random.default_rng(91)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, W / 2, H / 2), H, W, -1)
    frame = dict(rays_o=rays["rays_o"], rays_d=rays["rays_d"],
                 bg_coords=np.asarray(get_bg_coords(H, W)),
                 pose6=rng.normal(size=(1, 6)).astype(np.float32) * 0.3,
                 auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
                 bg_color=np.full((H * W, 3), 0.7, np.float32),
                 eye=np.array([[0.25]], np.float32))
    return frame, _blob_grid(GRID), rng.uniform(0.0, 0.2, GRID * GRID).astype(np.float32)


def _frames(net, rc, state, params_j, state_j, frame):
    """(port frame, JAX frame) of the same inputs at inference."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in frame.items()}
    got, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"], t["bg_coords"],
                         t["pose6"], t["eye"], 0, t["bg_color"])
    a = {k: jnp.asarray(v) for k, v in frame.items()}
    want, _ = jax.jit(lambda p, s: j_render_rays(
        p, JNetworkConfig(**SMALL_T), JRenderConfig(**RC_J), s, a["rays_o"], a["rays_d"],
        a["auds"], a["bg_coords"], a["pose6"], a["eye"], jnp.zeros((), jnp.int32),
        a["bg_color"], training=False))(params_j, state_j)
    return got, want


def _assert_same_frame(got, want):
    for k in TELEMETRY:
        assert int(got[k]) == int(want[k]), k
    assert int(got["n_samples_needed"]) > 100 and int(got["n_torso_mask"]) > 0
    p = _psnr(got["image"].numpy().astype(np.float64), np.asarray(want["image"], np.float64))
    assert p >= 60.0, p


def _jax_trainer(workspace, params=None, use_checkpoint="scratch"):
    return JTrainer("ngp", JOptions(workspace=workspace, torso=True, exp_eye=True, iters=100,
                                    dt_gamma=0.0),
                    net_cfg=JNetworkConfig(**SMALL_T), render_cfg=JRenderConfig(**RC_J),
                    params=params, ema_decay=0.95, use_checkpoint=use_checkpoint,
                    use_tensorboard=False, mute=True)


def _port_trainer(workspace=None, use_checkpoint="latest", **net):
    opt = Options(torso=True, exp_eye=True, iters=100, dt_gamma=0.0)
    return Trainer(opt, NetworkConfig(**{**SMALL_T, **net}), RenderConfig(**RC), device="cpu",
                   ema_decay=0.95, workspace=workspace, use_checkpoint=use_checkpoint)


def test_jax_checkpoint_loads_into_port(torso_params, scene, tmp_path):
    """A full head+torso checkpoint written by the JAX trainer (optax state,
    EMA, TPU capacities in its meta) loads into a port Trainer: parameters
    and EMA exactly equal, the step counts restored, and the 48x48 frame
    within 60 dB of JAX's with identical telemetry."""
    frame, grid, torso_grid = scene
    params_j = jax.tree_util.tree_map(jnp.asarray, torso_params)
    jt = _jax_trainer(str(tmp_path / "j"), params=params_j)
    jt.state = _blob_state_j(JRenderConfig(**RC_J), grid, 1.0).replace(
        density_grid_torso=jnp.asarray(torso_grid),
        mean_density_torso=jnp.asarray(0.05, jnp.float32))
    jt.epoch, jt.global_step = 3, 12
    jt.save_checkpoint(full=True)

    tr = _port_trainer()
    with pytest.warns(UserWarning, match="opt/"):
        tr.load_checkpoint(jt.stats["checkpoints"][-1])
    assert (tr.epoch, tr.global_step) == (3, 12)
    want = _state_dict_from_jax(torso_params)
    for name, p in tr.net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name], err_msg=name)
        np.testing.assert_array_equal(tr.ema_params[name].numpy(), want[name], err_msg=name)
    np.testing.assert_array_equal(tr.state.sigma_bytes.numpy(), np.asarray(jt.state.sigma_bytes))
    got, want_f = _frames(tr.net, tr.render_cfg, tr.state, jt.params, jt.state, frame)
    _assert_same_frame(got, want_f)


def test_port_checkpoint_loads_into_jax(torso_params, scene, tmp_path):
    """A full checkpoint written by a port Trainer loads in the JAX trainer
    (its Adam group ignored): parameters exactly equal, and JAX renders the
    port's frame within 60 dB with identical telemetry."""
    frame, grid, torso_grid = scene
    ws = str(tmp_path / "p")
    tr = _port_trainer(ws)
    load_jax_params(tr.net, torso_params)
    tr.state = state_from_numpy(tr.render_cfg, grid, torso_grid, 1.0, 0.05, thresh=1.0,
                                device="cpu")
    tr.epoch = 2
    tr.save_checkpoint(full=True)

    jt = _jax_trainer(ws, use_checkpoint="latest")
    assert jt.epoch == 2
    saved = _flatten(network_to_jax(tr.net))
    loaded = j_flatten(jax.tree_util.tree_map(np.asarray, jt.params))
    assert set(saved) == set(loaded)
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    got, want = _frames(tr.net, tr.render_cfg, tr.state, jt.params, jt.state, frame)
    _assert_same_frame(got, want)


class _Batches:
    """A dataset of fixed numpy batches (the same rays on every collate)."""

    def __init__(self, n, rng):
        from radnerf_tpu_torch.data import (
            convert_poses, get_audio_features, get_bg_coords, get_rays,
        )

        pose = np.eye(4, dtype=np.float32)
        pose[2, 3] = -3.3
        self.poses, self.intrinsics = pose[None].repeat(n, 0), (80.0, 80.0, 24.0, 24.0)
        self.auds = rng.normal(size=(n, 44, 16)).astype(np.float32)
        self.eye_area = np.full((n, 1), 0.25, np.float32)
        self.batches = []
        for i in range(n):
            rays = get_rays(pose, self.intrinsics, 48, 48, 256, rng=rng)
            self.batches.append(dict(
                rays_o=rays["rays_o"], rays_d=rays["rays_d"], index=i,
                auds=get_audio_features(self.auds, 2, i),
                bg_coords=get_bg_coords(48, 48)[rays["inds"]],
                poses=convert_poses(pose[None]), eye=self.eye_area[i].reshape(1, 1),
                bg_color=rng.random((256, 3)).astype(np.float32),
                images=rng.random((256, 3)).astype(np.float32),
                face_mask=rng.random(256) < 0.5))

    def collate(self, i):
        return self.batches[i]


def test_resume_is_bit_for_bit(tmp_path):
    """Two head-stage steps, a full checkpoint, a fresh trainer that loads
    it and takes the third step (the noise generator's state carried over:
    a checkpoint holds none, as a JAX one holds no PRNG key) equals three
    uninterrupted steps exactly: parameters, Adam's moments and steps, the
    learning rates, the step count."""
    ds = _Batches(3, np.random.default_rng(92))
    opt = Options(num_rays=256, exp_eye=True, iters=10, dt_gamma=0.0, update_extra_interval=8)
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    a = Trainer(opt, NetworkConfig(**SMALL), rc, device="cpu", workspace=str(tmp_path))
    a.step(ds, 0)
    a.step(ds, 1)
    a.save_checkpoint(full=True)
    noise_state = a.noise_gen.get_state()
    a.step(ds, 2)

    b = Trainer(opt, NetworkConfig(**SMALL), rc, device="cpu")
    b.load_checkpoint(a.stats["checkpoints"][-1])
    b.noise_gen.set_state(noise_state)
    assert b.global_step == 2
    b.step(ds, 2)

    assert b.global_step == a.global_step == 3
    assert float(a.state.mean_density) > 0
    pa, pb = dict(a.net.named_parameters()), dict(b.net.named_parameters())
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        sa, sb = a.optimizer.state[pa[name]], b.optimizer.state[pb[name]]
        assert sa.keys() == sb.keys() == {"step", "exp_avg", "exp_avg_sq"}, name
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    assert [g["lr"] for g in a.optimizer.param_groups] == \
        [g["lr"] for g in b.optimizer.param_groups]
    assert a.optimizer.param_groups[0]["lr"] < opt.lr
    assert a.scheduler.last_epoch == b.scheduler.last_epoch == 3


def test_reference_pth_imports_like_jax(tmp_path):
    """tests/test_train.py's reference-layout state_dict as a .pth: the port's
    import gives JAX's parameters exactly and a port Trainer loads them; a
    grid-less .pth (the reference's best checkpoint) synthesizes its sigma
    bytes from the bitfield and renders a non-empty frame."""
    from radnerf_tpu.ops.morton import packbits
    from test_train import _blob_grid, _ref_state_dict

    gen = torch.Generator().manual_seed(3)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": _ref_state_dict(torch, gen, torso=True, grid=True, grid_size=GRID),
                "epoch": 5, "global_step": 1234, "mean_density": 1.5,
                "mean_density_torso": 0.2}, path)
    params, state, meta = import_torch_checkpoint(path)
    params_j, state_j, meta_j = j_import_torch_checkpoint(path)
    assert meta == meta_j and set(state) == set(state_j)
    want = j_flatten(jax.tree_util.tree_map(np.asarray, params_j))
    got = _flatten(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tr = Trainer(Options(torso=True, exp_eye=True), NetworkConfig(torso=True, exp_eye=True),
                 RenderConfig(grid_size=GRID, torso=True), device="cpu")
    tr.load_checkpoint(path)
    sd = _state_dict_from_jax(params)
    for name, p in tr.net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), sd[name], err_msg=name)
    np.testing.assert_array_equal(tr.state.density_grid_torso.numpy(),
                                  state["density_grid_torso"])

    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    sd = _ref_state_dict(torch, gen, torso=False, grid=False, grid_size=GRID)
    grid = _blob_grid(GRID)
    sd["density_bitfield"] = torch.from_numpy(np.asarray(packbits(jnp.asarray(grid), 0.5)))
    torch.save({"model": sd, "mean_density": 4.2}, path)
    tr = Trainer(Options(exp_eye=True), NetworkConfig(exp_eye=True), rc, device="cpu")
    tr.load_checkpoint(path)
    occ = grid.reshape(-1) > 0.5
    sb = tr.state.sigma_bytes.numpy()
    assert np.all(sb[occ] == 129) and np.all(sb[~occ] == 0)
    assert float(tr.state.occ_sphere[3]) < 0.7 * np.sqrt(3.0)
    rng = np.random.default_rng(0)
    n = 256
    d = np.concatenate([rng.uniform(-0.12, 0.12, (n, 2)), np.ones((n, 1))], -1)
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    res, _ = render_rays(tr.net, rc, tr.state, torch.tensor([[0.0, 0.0, -3.3]]).repeat(n, 1),
                         d, torch.randn(8, 44, 16), torch.rand(n, 2) * 2 - 1,
                         torch.zeros(1, 6), torch.full((1, 1), 0.25), 0,
                         torch.full((n, 3), 0.5))
    assert float(res["weights_sum"].max()) > 1e-3
    assert float((res["image"] - 0.5).abs().max()) > 1e-4


def test_grid_shape_mismatch_raises(tmp_path):
    """A checkpoint of another grid shape is refused: by its grid_shape
    record, and by the table shapes when the record is missing."""
    from radnerf_tpu_torch.train import checkpoint as ckpt_lib

    tr = _port_trainer(str(tmp_path), use_checkpoint="scratch")
    tr.save_checkpoint()
    path = tr.stats["checkpoints"][-1]
    with pytest.raises(ValueError, match="grid shape"):
        _port_trainer(grid_levels=8).load_checkpoint(path)
    params, state, _, _, meta = ckpt_lib.load_checkpoint(path)
    del meta["grid_shape"]
    ckpt_lib.save_checkpoint(path, params, meta=meta)
    with pytest.raises(ValueError, match="encoder table"):
        _port_trainer(grid_levels=8).load_checkpoint(path)


def test_rolling_window_and_latest(tmp_path):
    """max_keep_ckpt epoch checkpoints stay; latest_checkpoint names the
    newest, which a trainer on the workspace restores; a best checkpoint
    without an eval result is skipped with a warning."""
    ws = str(tmp_path)
    tr = _port_trainer(ws, use_checkpoint="scratch")
    for epoch in (1, 2, 3):
        tr.epoch, tr.global_step = epoch, 10 * epoch
        tr.save_checkpoint(full=epoch == 3)
    files = sorted(os.listdir(tr.ckpt_path))
    assert files == ["ngp_ep0002.npz", "ngp_ep0003.npz"]
    assert latest_checkpoint(tr.ckpt_path) == os.path.join(tr.ckpt_path, "ngp_ep0003.npz")
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert _port_trainer(ws).global_step == 30
    assert _port_trainer(ws, use_checkpoint="latest_model").global_step == 0
    with pytest.warns(UserWarning, match="no evaluated results"):
        tr.save_checkpoint(best=True)
    assert not os.path.exists(tr.best_path)
