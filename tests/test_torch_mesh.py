"""Mesh export of the port against the JAX package's, on the CPU: marching
tetrahedra on a seeded field (the same triangles, the vertices to float64
rounding), the dense sigma sweep through the port's ``field_density``
beside JAX's, the PLY bytes, and ``Trainer.save_mesh``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models.network import field_density as j_field_density
from radnerf_tpu.utils.mesh import extract_geometry as j_extract_geometry
from radnerf_tpu.utils.mesh import marching_tetrahedra as j_marching_tetrahedra
from radnerf_tpu.utils.mesh import save_mesh_ply as j_save_mesh_ply

from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import load_jax_params, network_from_jax
from radnerf_tpu_torch.models import NetworkConfig, RenderConfig
from radnerf_tpu_torch.train import Trainer
from radnerf_tpu_torch.utils.mesh import extract_geometry, marching_tetrahedra, save_mesh_ply

from test_torch_train import GRID, SMALL, head_params  # noqa: F401  (fixture)

# the narrow model without the eye input: JAX's density query passes none
NO_EYE = dict(SMALL, exp_eye=False)
BOX = ((-1.0, -0.5, -1.0), (1.0, 0.5, 1.0))


@pytest.fixture(scope="module")
def no_eye_params(head_params):
    """The narrow model's parameters with the sigma net's eye column
    dropped."""
    first = dict(head_params["sigma_net"]["layers"][0])
    first["w"] = first["w"][:-1]
    layers = [first, *head_params["sigma_net"]["layers"][1:]]
    return dict(head_params, sigma_net={"layers": layers})


@pytest.mark.parametrize("slab", [32, 5])
def test_marching_tetrahedra_matches_jax(slab):
    """A seeded smooth 24^3 field at threshold 0.3: the same triangles in
    the same order and the vertices within 1e-12, whatever the slab."""
    rng = np.random.default_rng(41)
    g = np.linspace(-1.0, 1.0, 24)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    field = (np.sin(3 * x + 1) * np.cos(2 * y) + 0.7 * np.sin(4 * z) * x
             + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    v_j, f_j = j_marching_tetrahedra(field, 0.3)
    v, f = marching_tetrahedra(torch.from_numpy(field), 0.3, slab=slab)
    assert v.dtype == torch.float64 and len(f_j) > 1000
    np.testing.assert_array_equal(f.numpy(), f_j)
    assert float(np.abs(v.numpy() - v_j).max()) <= 1e-12
    v0, f0 = marching_tetrahedra(torch.zeros(4, 4, 4), 0.3)
    assert v0.shape == (0, 3) and f0.shape == (0, 3)


def test_extract_geometry_and_ply_match_jax(no_eye_params, tmp_path):
    """The sweep at resolution 32 over the box through the port's
    ``field_density`` (chunks of 5,000 points): its sigma lattice within
    1e-4 relative of JAX's ``field_density`` on the same points, and its
    mesh equal to JAX's ``extract_geometry`` of the same sigma (the same
    triangles, the same float32 vertices); the PLY of that mesh byte for
    byte as JAX writes it."""
    cfg = JNetworkConfig(**NO_EYE)
    p_j = jax.tree_util.tree_map(jnp.asarray, no_eye_params)
    net = network_from_jax(no_eye_params, NetworkConfig(**NO_EYE), device="cpu")
    chunks = []

    def query(p):
        with torch.no_grad():
            chunks.append(net.field_density(p, None)["sigma"])
        return chunks[-1]

    thr = 1.0  # the model's median sigma
    v, f = extract_geometry(*BOX, 32, thr, query, chunk=5000)
    assert len(chunks) == -(-32**3 // 5000)
    sigma = torch.cat(chunks).numpy()
    pts = []
    v_j, f_j = j_extract_geometry(*BOX, resolution=32, threshold=thr,
                                  query_func=lambda p: pts.append(p) or sigma)
    want = jax.jit(lambda q: j_field_density(p_j, cfg, q, None, None)["sigma"])(
        jnp.asarray(pts[0]))
    np.testing.assert_allclose(sigma, np.asarray(want), rtol=1e-4, atol=1e-6)
    assert v.dtype == np.float32 and f.dtype == np.int64 and len(f_j) > 1000
    np.testing.assert_array_equal(f, f_j)
    np.testing.assert_array_equal(v, v_j)

    save_mesh_ply(str(tmp_path / "port.ply"), v, f)
    j_save_mesh_ply(str(tmp_path / "jax.ply"), v_j, f_j)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    save_mesh_ply(str(tmp_path / "empty.ply"), np.zeros((0, 3), np.float32),
                  np.zeros((0, 3), np.int64))
    j_save_mesh_ply(str(tmp_path / "empty_j.ply"), np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int64))
    assert (tmp_path / "empty.ply").read_bytes() == (tmp_path / "empty_j.ply").read_bytes()


def test_trainer_save_mesh(no_eye_params, head_params, tmp_path):
    """``Trainer.save_mesh`` writes ``<workspace>/meshes/<name>_<epoch>.ply``:
    the PLY of ``extract_geometry`` over the box through ``field_density``;
    a model with the eye input takes the app's eye value, 0.25 (JAX's query
    passes none and fails there)."""
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    box = (rc.aabb[:3], rc.aabb[3:])
    for cfg, params, e in ((NO_EYE, no_eye_params, None),
                           (SMALL, head_params, torch.full((1, 1), 0.25))):
        tr = Trainer(Options(exp_eye=cfg["exp_eye"], iters=100), NetworkConfig(**cfg), rc,
                     device="cpu", workspace=str(tmp_path / str(e is None)))
        load_jax_params(tr.net, params)
        path = tr.save_mesh(resolution=24, threshold=1.0)
        assert path == os.path.join(tr.workspace, "meshes", "ngp_0.ply")
        with torch.no_grad():
            v, f = extract_geometry(*box, 24, 1.0,
                                    lambda p: tr.net.field_density(p, None, e)["sigma"])
        assert len(f) > 100
        save_mesh_ply(str(tmp_path / "want.ply"), v, f)
        assert open(path, "rb").read() == (tmp_path / "want.ply").read_bytes()
