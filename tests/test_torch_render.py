"""One frame through the port's renderer against the JAX package's and the
reference-semantics oracle, on the CPU (the kernel wrappers run their plain
twins here). The scene copies tests/test_parity.py::
test_reference_semantics_frame_psnr: a 48x48 head+torso frame on a blob grid
of 32, imported torch-layout weights, JAX at exhaustive capacities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.data.rays import get_bg_coords, get_rays
from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import RendererState as JRendererState
from radnerf_tpu.models import compute_occ_bbox, render_rays as j_render_rays
from radnerf_tpu.models.network import encode_audio
from radnerf_tpu.models.renderer import compute_occ_sphere
from radnerf_tpu.ops.marching import build_sigma_bytes
from radnerf_tpu.ops.morton import packbits
from radnerf_tpu.train import import_torch_checkpoint

from radnerf_tpu_torch.convert import network_from_jax, state_from_numpy
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig, render_rays
from radnerf_tpu_torch.scene import build_scene

H = W = 48
GRID = 32


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


@pytest.fixture(scope="module")
def frame_inputs(tmp_path_factory):
    from test_train import _blob_grid, _ref_state_dict

    gen = torch.Generator().manual_seed(7)
    sd = _ref_state_dict(torch, gen, torso=True, grid=True, grid_size=GRID)
    # N(0, 1) tables instead of the reference's ~1e-4 init, so the grid
    # features shape the frame
    for k in ("encoder.embeddings", "encoder_ambient.embeddings",
              "torso_encoder.embeddings"):
        sd[k] = sd[k] * 1e4
    path = str(tmp_path_factory.mktemp("torch_render") / "ref.pth")
    torch.save({"model": sd}, path)
    params, _, _ = import_torch_checkpoint(path)
    rng = np.random.default_rng(5)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, W / 2, H / 2), H, W, -1)
    inputs = dict(
        rays_o=rays["rays_o"], rays_d=rays["rays_d"],
        bg_coords=np.asarray(get_bg_coords(H, W)),
        grid=_blob_grid(GRID),  # [1, 32^3], values {0, 20}
        torso_grid=rng.uniform(0, 0.2, (GRID * GRID,)).astype(np.float32),
        pose6=rng.normal(size=(1, 6)).astype(np.float32),
        auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
        bg_color=np.full((H * W, 3), 0.7, np.float32),
        eye=np.array([[0.25]], np.float32),
    )
    return params, inputs


@pytest.fixture(scope="module")
def oracle_image(frame_inputs):
    """reference_impl.ref_render_frame on the same scene (it has no cull)."""
    from reference_impl import ref_render_frame

    params, f = frame_inputs
    cfg = JNetworkConfig(torso=True, exp_eye=True)
    enc_a = np.asarray(encode_audio(params, cfg, jnp.asarray(f["auds"])))
    img, ws = ref_render_frame(
        params={k: np.asarray(v) if not isinstance(v, dict) else v
                for k, v in params.items()},
        net_cfg=cfg, rays_o=f["rays_o"], rays_d=f["rays_d"], bg_coords=f["bg_coords"],
        pose6=f["pose6"], enc_a=enc_a, eye=0.25, bg_color=f["bg_color"],
        bitfield=np.asarray(packbits(jnp.asarray(f["grid"]), 1.0)),
        density_grid_torso=f["torso_grid"], mean_density_torso=0.05,
        bound=1.0, min_near=0.05, grid_size=GRID, cascade=1, max_steps=8,
        dt_gamma=0.0, T_thresh=1e-4, density_thresh_torso=0.01, torso=True)
    assert ws.max() > 0.05, "oracle head is invisible -- scene broken"
    return img


@pytest.mark.parametrize("cull_T", [0.0, 1e-6])
def test_frame_matches_jax_and_reference(frame_inputs, oracle_image, cull_T):
    """The port's 48x48 frame vs JAX render_rays at exhaustive capacities:
    PSNR >= 60 dB and identical n_hit, n_samples_needed, n_max_count; vs the
    reference-semantics oracle: PSNR >= 40 dB (the floor of the JAX
    package's own test)."""
    params, f = frame_inputs
    thresh = 1.0  # min(mean_density=1.0, density_thresh=10)
    rc_j = JRenderConfig(torso=True, exp_eye=True, grid_size=GRID, max_steps=8,
                         dt_gamma=0.0, sample_capacity_mult=16.0,
                         ray_capacity_frac=1.0, cull_T=cull_T)
    grid = jnp.asarray(f["grid"])
    state_j = JRendererState.create(rc_j).replace(
        density_grid=grid, density_bitfield=packbits(grid, thresh),
        mean_density=jnp.asarray(1.0, jnp.float32),
        density_grid_torso=jnp.asarray(f["torso_grid"]),
        mean_density_torso=jnp.asarray(0.05, jnp.float32),
        occ_bbox=compute_occ_bbox(rc_j, grid, thresh),
        occ_sphere=compute_occ_sphere(rc_j, grid, thresh),
    ).with_sigma_bytes(build_sigma_bytes(grid, thresh))
    cfg_j = JNetworkConfig(torso=True, exp_eye=True)
    a = {k: jnp.asarray(v) for k, v in f.items()}
    want, _ = jax.jit(lambda p, s: j_render_rays(
        p, cfg_j, rc_j, s, a["rays_o"], a["rays_d"], a["auds"], a["bg_coords"],
        a["pose6"], a["eye"], jnp.zeros((), jnp.int32), a["bg_color"],
        training=False))(params, state_j)

    rc = RenderConfig(torso=True, grid_size=GRID, max_steps=8,
                      dt_gamma=0.0, cull_T=cull_T)
    net = network_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           NetworkConfig(torso=True, exp_eye=True), device="cpu")
    state = state_from_numpy(rc, f["grid"], f["torso_grid"], 1.0, 0.05, thresh=thresh,
                             device="cpu")
    np.testing.assert_allclose(state.occ_bbox.numpy(), np.asarray(state_j.occ_bbox))
    np.testing.assert_allclose(state.occ_sphere.numpy(), np.asarray(state_j.occ_sphere),
                               rtol=1e-6)
    t = {k: torch.from_numpy(np.array(v)) for k, v in f.items()}
    got, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"],
                         t["bg_coords"], t["pose6"], t["eye"], torch.zeros(()),
                         t["bg_color"])

    for k in ("n_hit", "n_samples_needed", "n_max_count", "n_torso_mask"):
        assert int(got[k]) == int(want[k]), k
    img = got["image"].numpy().astype(np.float64)
    assert np.isfinite(img).all() and img.shape == (H * W, 3)
    p_jax = _psnr(img, np.asarray(want["image"], np.float64))
    p_ref = _psnr(img, oracle_image)
    print(f"\n[torch frame cull_T={cull_T}] PSNR vs JAX {p_jax:.2f} dB, "
          f"vs reference semantics {p_ref:.2f} dB")
    assert p_jax >= 60.0
    assert p_ref >= 40.0
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), atol=1e-4)


def test_bench_scene_builds_and_renders_on_cpu():
    """The port's copy of bench.py's scene, at 32x32 on the CPU: full-width
    model, a visible head (weights_sum > 0.05), a torso band, finite image."""
    net, rc, state, batch, aud = build_scene(32, 32, device="cpu")
    assert net.encoder.shape == (903480, 2) and net.torso_encoder.shape == (555520, 2)
    assert int(state.sigma_bytes.ne(0).sum()) > 10_000
    res, _ = render_rays(net, rc, state, batch["rays_o"], batch["rays_d"], aud[0],
                         batch["bg_coords"], batch["poses"], batch["eye"], batch["index"],
                         batch["bg_color"])
    assert torch.isfinite(res["image"]).all()
    assert float(res["weights_sum"].max()) > 0.05
    assert float(res["torso_alpha"].max()) > 0.0
    assert int(res["n_hit"]) > 0 and int(res["n_torso_mask"]) > 0


def test_renderer_helpers_match_jax():
    """bilinear_sample_2d, smooth_audio_code and the occupied bbox/sphere
    against the JAX renderer's, including the empty-grid fallback."""
    from radnerf_tpu.models.renderer import bilinear_sample_2d as j_bilinear
    from radnerf_tpu.models.renderer import smooth_audio_code as j_smooth

    from radnerf_tpu_torch.models import (
        bilinear_sample_2d, compute_occ_bbox as t_bbox, compute_occ_sphere as t_sphere,
        make_state, smooth_audio_code,
    )

    rng = np.random.default_rng(9)
    Hg = 16
    grid2d = rng.random(Hg * Hg).astype(np.float32)
    coords = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    coords[:4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    np.testing.assert_allclose(
        bilinear_sample_2d(torch.from_numpy(grid2d), torch.from_numpy(coords), Hg).numpy(),
        np.asarray(j_bilinear(jnp.asarray(grid2d), jnp.asarray(coords), Hg)), atol=1e-6)

    rc_j, rc = JRenderConfig(grid_size=Hg), RenderConfig(grid_size=Hg)
    sparse = np.where(rng.random((1, Hg**3)) < 0.01, 30.0, 0.0).astype(np.float32)
    for g in (sparse, np.zeros_like(sparse)):
        np.testing.assert_allclose(t_bbox(rc, torch.from_numpy(g), 5.0).numpy(),
                                   np.asarray(compute_occ_bbox(rc_j, jnp.asarray(g), 5.0)))
        np.testing.assert_allclose(t_sphere(rc, torch.from_numpy(g), 5.0).numpy(),
                                   np.asarray(compute_occ_sphere(rc_j, jnp.asarray(g), 5.0)),
                                   rtol=1e-6)

    state_j = JRendererState.create(rc_j)
    state = make_state(rc, torch.zeros(1, Hg**3), torch.zeros(Hg * Hg), 0.0, 0.0)
    for step in range(2):
        code = rng.normal(size=(1, 64)).astype(np.float32)
        want, state_j = j_smooth(state_j, jnp.asarray(code), True)
        got, state = smooth_audio_code(state, torch.from_numpy(code), True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert bool(state.enc_a_initialized)
