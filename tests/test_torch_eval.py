"""The port's evaluation and test loops, best checkpoint and JAX optimizer
state against the JAX trainer's, on the CPU, on tests/test_train.py's 64x64
on-disk dataset with tests/test_torch_train.py's narrow model (grid 32, JAX
at exhaustive capacities): a JAX checkpoint (parameters, EMA, blob grid,
optax state) loads into the port, whose eval and test frames are within
60 dB of JAX's, eval loss and PSNR within 1e-4; the port's best checkpoint
renders alike in JAX; JAX's Adam moments resume in torch Adam."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radnerf_tpu.config import Options as JOptions
from radnerf_tpu.data import TalkingHeadDataset as JTalkingHeadDataset
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.train import PSNRMeter as JPSNRMeter
from radnerf_tpu.train import Trainer as JTrainer

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import _state_dict_from_jax
from radnerf_tpu_torch.data import TalkingHeadDataset
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig
from radnerf_tpu_torch.train import PSNRMeter, Trainer, load_checkpoint

from test_torch_train import GRID, SMALL, _blob_state_j, head_params  # noqa: F401
from test_train import _blob_grid, data_dir  # noqa: F401  (the on-disk dataset fixture)

# both packages at exhaustive capacities: a checkpoint carries them to the
# other trainer
RC = dict(grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=0.0, smooth_lips=True,
          sample_capacity_mult=16.0, ray_capacity_frac=1.0)
RC_J = dict(RC, exp_eye=True)
OPT = dict(num_rays=512, exp_eye=True, iters=100, dt_gamma=0.0, cull_T=0.0, smooth_lips=True,
           fix_eye=0.3, update_extra_interval=2, ema_update_interval=2)


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((np.float64(a) - b) ** 2)), 1e-20))


def _jax_trainer(data_dir, workspace, **kw):  # noqa: F811
    return JTrainer("ngp", JOptions(path=data_dir, workspace=workspace, auto_capacity=False,
                                    **OPT),
                    net_cfg=JNetworkConfig(**SMALL), render_cfg=JRenderConfig(**RC_J),
                    metrics=[JPSNRMeter()], use_tensorboard=False, mute=True, **kw)


def _port_trainer(data_dir, workspace=None, **kw):  # noqa: F811
    return Trainer(Options(path=data_dir, auto_capacity=False, **OPT), NetworkConfig(**SMALL),
                   RenderConfig(**RC), device="cpu", ema_decay=0.95, metrics=[PSNRMeter()],
                   workspace=workspace, **kw)


def _datasets(data_dir, split):  # noqa: F811
    port = TalkingHeadDataset(Options(path=data_dir, **OPT), split=split, device="cpu")
    want = JTalkingHeadDataset(JOptions(path=data_dir, **OPT), split=split)
    port.eval_count = want.eval_count = 2
    return port, want


def _grads(params, rng):
    return jax.tree_util.tree_map(
        lambda v: rng.normal(size=v.shape).astype(np.float32) * 1e-3, params)


@pytest.fixture(scope="module")
def jax_run(head_params, data_dir, tmp_path_factory):  # noqa: F811
    """A JAX trainer with the narrow model, an EMA away from its parameters,
    the blob grid, and an optax state after two updates on numpy gradients
    (the parameters left as they were), saved as a full checkpoint."""
    ws = str(tmp_path_factory.mktemp("jax_ws"))
    params = jax.tree_util.tree_map(jnp.asarray, head_params)
    jt = _jax_trainer(data_dir, ws, params=params, ema_decay=0.95, use_checkpoint="scratch")
    rng = np.random.default_rng(101)
    jt.ema_params = jax.tree_util.tree_map(
        lambda v: v * 0.9 + jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) * 0.01,
        params)
    jt.state = _blob_state_j(JRenderConfig(**RC_J), _blob_grid(GRID), 1.0)
    for _ in range(2):
        _, jt.opt_state = jt.tx.update(jax.tree_util.tree_map(jnp.asarray, _grads(params, rng)),
                                       jt.opt_state, params)
    jt.epoch, jt.global_step = 1, 2
    jt.save_checkpoint(full=True)
    return jt, jt.stats["checkpoints"][-1]


def test_eval_and_test_frames_match_jax(jax_run, data_dir, tmp_path):  # noqa: F811
    """The JAX checkpoint in a port trainer: evaluation (with the EMA) gives
    JAX's eval loss and PSNR within 1e-4 and frames within 60 dB, then the
    live parameters are back bit for bit; the test frames (fix_eye, the
    smooth_lips code carried from frame to frame) within 60 dB; the
    validation PNGs, the test video's frames and the FPS are written."""
    jt, ckpt = jax_run
    ws = str(tmp_path / "port")
    tr = _port_trainer(data_dir, ws, use_checkpoint=ckpt)
    live = {k: v.detach().clone() for k, v in tr.net.named_parameters()}
    val, val_j = _datasets(data_dir, "val")
    jt.evaluate_one_epoch(val_j)
    tr.evaluate_one_epoch(val)
    assert abs(tr.stats["valid_loss"][-1] - jt.stats["valid_loss"][-1]) <= 1e-4
    assert abs(tr.stats["results"][-1] - jt.stats["results"][-1]) <= 1e-4
    assert jt.stats["results"][-1] > 5.0
    for name, p in tr.net.named_parameters():
        assert torch.equal(p, live[name]), name
    got = tr.eval_step(tr.next_batch(val, 1))[0]
    want = jt.eval_step(jt._to_device(val_j.collate(1)))[0]
    assert _psnr(got, want) >= 60.0
    assert float(np.abs(got - tr.eval_step(tr.next_batch(val, 1))[0]).max()) == 0.0
    assert sorted(os.listdir(os.path.join(ws, "validation"))) == [
        f"ngp_ep0001_{i:04d}_{k}.png" for i in range(2) for k in ("depth", "rgb")]

    test, test_j = _datasets(data_dir, "test")
    for i in range(3):
        got = tr.test_step(tr.next_batch(test, i))[0]
        want = jt.test_step(jt._to_device(test_j.collate(i)))[0]
        assert _psnr(got, want) >= 60.0, i
    np.testing.assert_allclose(tr.state.enc_a_smooth.numpy(),
                               np.asarray(jt.state.enc_a_smooth), rtol=1e-4, atol=1e-6)
    fps = tr.test(test, name="clip")
    assert fps > 0
    out = sorted(os.listdir(os.path.join(ws, "results")))
    assert out == [f"clip_{i:04d}.png" for i in range(len(test))]


def test_best_checkpoint_renders_in_jax(data_dir, tmp_path):  # noqa: F811
    """train(train_ds, valid_ds, 2) evaluates each epoch and writes
    ngp_ep0002.npz and a grid-less ngp.npz of the EMA; the JAX trainer
    loads ngp.npz and renders the validation frame within 60 dB of the
    port."""
    ws = str(tmp_path / "p")
    tr = _port_trainer(data_dir, ws, use_checkpoint="scratch")
    train, _ = _datasets(data_dir, "train")
    val, val_j = _datasets(data_dir, "val")
    val.eval_count = 1
    tr.train(train, val, 2)
    assert len(tr.stats["results"]) == 2 and np.isfinite(tr.stats["results"]).all()
    files = sorted(os.listdir(tr.ckpt_path))
    assert files == ["ngp.npz", "ngp_ep0001.npz", "ngp_ep0002.npz"]
    with np.load(tr.best_path) as z:
        keys = set(z.files)
    assert "state/sigma_bytes" in keys and "state/density_grid" not in keys
    assert not any(k.startswith(("opt", "ema")) for k in keys)
    for name, v in _state_dict_from_jax(load_checkpoint(tr.best_path)[0]).items():
        np.testing.assert_array_equal(v, tr.ema_params[name].numpy(), err_msg=name)

    jt = _jax_trainer(data_dir, ws, use_checkpoint="best")
    got = tr.eval_step(tr.next_batch(val, 0))[0]
    want = jt.eval_step(jt._to_device(val_j.collate(0)))[0]
    assert _psnr(got, want) >= 60.0
    assert float(np.abs(got - got.mean()).max()) > 1e-3  # not a flat frame


def test_jax_adam_state_resumes(jax_run, head_params, data_dir):  # noqa: F811
    """The JAX checkpoint's optax state becomes torch Adam's: the moments
    equal JAX's (linear weights transposed), the step its count, the
    schedule its count; then the same numpy gradients move both optimizers'
    parameters alike (rtol 1e-6, atol 1e-7 of the tensor's largest value)."""
    jt, ckpt = jax_run
    tr = _port_trainer(data_dir)
    tr.load_checkpoint(ckpt)
    named = dict(tr.net.named_parameters())
    for group, st in jt.opt_state.inner_states.items():
        if group == "frozen":
            continue
        adam = st.inner_state[0]
        mu = {k: v for k, v in adam.mu.items() if jax.tree_util.tree_leaves(v)}
        nu = {k: v for k, v in adam.nu.items() if jax.tree_util.tree_leaves(v)}
        for moments, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            for name, w in _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, moments)).items():
                state = tr.optimizer.state[named[name]]
                np.testing.assert_array_equal(state[key].numpy(), w, err_msg=name)
                assert float(state["step"]) == int(adam.count) == 2
    assert tr.scheduler.last_epoch == 2
    assert len(tr.optimizer.state) == len(named)

    params = jax.tree_util.tree_map(jnp.asarray, head_params)
    opt_state = jt.opt_state
    rng = np.random.default_rng(102)
    for _ in range(2):
        g_np = _grads(head_params, rng)
        updates, opt_state = jt.tx.update(jax.tree_util.tree_map(jnp.asarray, g_np), opt_state,
                                          params)
        params = optax.apply_updates(params, updates)
        for name, v in _state_dict_from_jax(g_np).items():
            named[name].grad = torch.from_numpy(np.ascontiguousarray(v))
        tr.optimizer.step()
        tr.scheduler.step()
    for name, w in _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(named[name].detach().numpy(), w, rtol=1e-6,
                                   atol=1e-7 * float(np.abs(w).max()), err_msg=name)
