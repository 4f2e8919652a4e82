"""The port's models (radnerf_tpu_torch.models) against the JAX package's on
the CPU, on the same weights: a synthetic state_dict in the reference layout
is imported into JAX, and the JAX pytree is carried into the port with
``network_from_jax``. Also: the package imports neither JAX nor the JAX
package, and its tensor-creating entry points default to the card."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models.network import encode_audio, field_forward, forward_torso
from radnerf_tpu.train import import_torch_checkpoint

from radnerf_tpu_torch.convert import network_from_jax, state_from_numpy
from radnerf_tpu_torch.models import NeRFNetwork, NetworkConfig, RenderConfig

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 matmul/conv summation order


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    from test_train import _ref_state_dict

    gen = torch.Generator().manual_seed(7)
    sd = _ref_state_dict(torch, gen, torso=True, grid=True, grid_size=32)
    # the reference's init tables are ~1e-4; widen them so the grid features
    # carry weight in the comparison
    for k in ("encoder.embeddings", "encoder_ambient.embeddings",
              "torso_encoder.embeddings"):
        sd[k] = sd[k] * 1e4
    path = str(tmp_path_factory.mktemp("torch_models") / "ref.pth")
    torch.save({"model": sd}, path)
    params, _, _ = import_torch_checkpoint(path)
    jcfg = JNetworkConfig(torso=True, exp_eye=True)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    net = network_from_jax(np_params, NetworkConfig(torso=True, exp_eye=True),
                           device="cpu")
    return params, jcfg, net


def test_network_from_jax_carries_every_parameter(imported):
    params, _, net = imported
    np.testing.assert_array_equal(net.encoder.detach().numpy(), np.asarray(params["encoder"]))
    np.testing.assert_array_equal(net.sigma_net.layers[0].weight.detach().numpy(),
                                  np.asarray(params["sigma_net"]["layers"][0]["w"]).T)
    n_jax = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in net.parameters()) == n_jax
    # the TPU corner-packed caches are skipped, an unknown key is refused
    extra = dict(jax.tree_util.tree_map(np.asarray, params))
    extra["_packed_encoder"] = (np.zeros((4, 16), np.float32),)
    network_from_jax(extra, net.cfg, device="cpu")
    extra["not_a_param"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError):
        network_from_jax(extra, net.cfg, device="cpu")


def test_encode_audio_matches_jax(imported):
    params, jcfg, net = imported
    auds = np.random.default_rng(0).normal(size=(8, 44, 16)).astype(np.float32)
    want = np.asarray(encode_audio(params, jcfg, jnp.asarray(auds)))
    with torch.no_grad():
        got = net.encode_audio(torch.from_numpy(auds)).numpy()
    assert got.shape == (1, 64)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("with_audio", [True, False])
def test_field_forward_matches_jax(imported, with_audio):
    params, jcfg, net = imported
    rng = np.random.default_rng(1)
    N = 256
    x = rng.uniform(-0.95, 0.95, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    enc_a = rng.normal(size=(1, 64)).astype(np.float32) if with_audio else None
    c = np.asarray(params["individual_codes"][0])
    e = np.array([[0.25]], np.float32)
    want = field_forward(params, jcfg, jnp.asarray(x), jnp.asarray(d),
                         None if enc_a is None else jnp.asarray(enc_a),
                         jnp.asarray(c), jnp.asarray(e))
    with torch.no_grad():
        got = net.field_forward(torch.from_numpy(x), torch.from_numpy(d),
                                None if enc_a is None else torch.from_numpy(enc_a),
                                net.individual_codes[0], torch.from_numpy(e))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert np.asarray(want[0]).std() > 0.02  # the density varies over x


def test_forward_torso_matches_jax(imported):
    params, jcfg, net = imported
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.0, 1.0, (256, 2)).astype(np.float32)
    pose6 = rng.normal(size=(1, 6)).astype(np.float32)
    c = np.asarray(params["individual_codes_torso"][0])
    want = forward_torso(params, jcfg, jnp.asarray(x), jnp.asarray(pose6), jnp.asarray(c))
    with torch.no_grad():
        got = net.forward_torso(torch.from_numpy(x), torch.from_numpy(pose6),
                                net.individual_codes_torso[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_bfloat16_policy_is_not_ported():
    """The bf16 policy builds (a network of float32 master parameters, bf16
    MLPs and tables), and training the camera offsets under it, the last
    part of it that was refused, renders: the gradient reaches the frame's
    camera rows."""
    from radnerf_tpu_torch.models import render_rays

    cfg = NetworkConfig(compute_dtype="bfloat16", ind_num=4, train_camera=True)
    assert cfg.dtype == torch.bfloat16 and cfg.table_dtype == torch.bfloat16
    net = NeRFNetwork(cfg, device="cpu")
    assert all(p.dtype == torch.float32 for p in net.parameters())
    rc = RenderConfig(grid_size=16)
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    o = -2.0 * d
    full = state_from_numpy(rc, np.full((1, 16**3), 20.0, np.float32),
                            np.zeros(16 * 16, np.float32), 20.0, 0.0, device="cpu")
    res, _ = render_rays(net, rc, full, o, d, None, torch.zeros(8, 2), torch.zeros(1, 6),
                         torch.full((1, 1), 0.25), 2, torch.ones(8, 3), training=True)
    res["image"].sum().backward()
    assert res["image"].dtype == torch.float32 and int(res["n_samples_needed"]) > 0
    assert net.camera_dT.grad[2].abs().sum() > 0 and not net.camera_dT.grad[[0, 1, 3]].any()


def test_entry_points_default_to_cuda():
    """Without ``device`` the entry points ask for the card, and raise here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default does not raise")
    from radnerf_tpu_torch.scene import build_scene

    cfg = NetworkConfig(ind_num=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeRFNetwork(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        network_from_jax({}, cfg)
    rc = RenderConfig(grid_size=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy(rc, np.zeros((1, 16**3), np.float32), np.zeros(256, np.float32),
                         1.0, 0.05)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_scene(16, 16)
    assert NeRFNetwork(cfg, device="cpu").encoder.device.type == "cpu"


def _port_sources():
    pkg = REPO / "radnerf_tpu_torch"
    return sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """Importing the port and all its submodules pulls in neither ``jax``
    nor ``radnerf_tpu``, and builds nothing; no source of the port (or of
    chip_smoke.py) names them."""
    mods = []
    for p in sorted((REPO / "radnerf_tpu_torch").rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'jaxlib' or m.startswith('jaxlib.') "
            "or m == 'radnerf_tpu' or m.startswith('radnerf_tpu.')]\n"
            "from radnerf_tpu_torch.ops._kernels import KERNELS\n"
            "assert all(k._lib is None for k in KERNELS.values())\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert {"radnerf_tpu_torch.config", "radnerf_tpu_torch.ops.rowgather",
            "radnerf_tpu_torch.train.losses", "radnerf_tpu_torch.train.trainer",
            "radnerf_tpu_torch.utils.color", "radnerf_tpu_torch.data.provider",
            "radnerf_tpu_torch.utils.image", "radnerf_tpu_torch.train.metrics",
            "radnerf_tpu_torch.main", "radnerf_tpu_torch.infer",
            "radnerf_tpu_torch.apps.asr", "radnerf_tpu_torch.apps.frame_server",
            "radnerf_tpu_torch.utils.mesh"} <= set(mods)
    assert len(mods) >= 33

    pat = re.compile(r"^\s*(import jax|from jax)|radnerf_tpu\.|from radnerf_tpu ", re.M)
    for path in _port_sources():
        hits = pat.findall(path.read_text())
        assert not hits, f"{path} references JAX or the JAX package: {hits}"
