"""Each hand-written CUDA kernel of the port against its plain PyTorch twin,
on the card. The ``cuda`` mark (registered in pytest.ini) labels them;
without a card the ``dev`` fixture skips them (the decision is made inside
the fixture, never at import). Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(``--noconftest``: tests/conftest.py pins JAX to the CPU and needs JAX.)

Tolerances: kernels and twins run the same float32 operations in the same
order (the kernels are built with -fmad=false), so the expected difference
is 0; the stated tolerances leave room for a last-ulp difference between
CUDA's expf/exp2f and PyTorch's.
"""

import math

import numpy as np
import pytest
import torch

from radnerf_tpu_torch import ops as T
from radnerf_tpu_torch.ops import _kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    _kernels.build_all()
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("input_dim", [2, 3])
def test_grid_encode_kernel_matches_twin(dev, input_dim):
    spec = T.GridSpec.create(input_dim=input_dim, desired_resolution=2048)
    rng = np.random.default_rng(input_dim)
    emb = _t(rng.uniform(-4, 4, (spec.n_embeddings, 2)).astype(np.float32), dev)
    x = rng.uniform(-1.02, 1.02, (50_000, input_dim)).astype(np.float32)
    x[:2] = [-1.0] * input_dim, [1.0] * input_dim
    x = _t(x, dev)
    before = _kernels.KERNELS["grid_encode"].launches
    got = T.grid_encode(x, emb, spec)
    assert _kernels.KERNELS["grid_encode"].launches == before + 1
    want = T.grid_encode_plain(x, emb, spec)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert T.grid_encode(x[:0], emb, spec).shape == (0, 32)


@pytest.mark.parametrize("cull_T", [0.0, 1e-4])
def test_march_kernel_matches_twin(dev, cull_T):
    H = 64
    cfg = T.MarchConfig(grid_size=H, max_steps=16, dt_gamma=0.0)
    rng = np.random.default_rng(5)
    coords = T.morton3d_invert(torch.arange(H**3)).numpy()
    xyz = 2.0 * (coords + 0.5) / H - 1.0
    dens = np.where(np.linalg.norm(xyz, axis=-1) < 0.5, 30.0, 0.0).astype(np.float32)
    dens[rng.random(H**3) < 0.02] = 300.0
    sb = T.build_sigma_bytes(_t(dens, dev), 5.0)
    N = 20_000
    o = np.zeros((N, 3), np.float32)
    o[:, 2] = -3.0
    o[:, :2] = rng.uniform(-0.8, 0.8, (N, 2))
    d = np.zeros((N, 3), np.float32)
    d[:, 2] = 1.0
    d[:, :2] = rng.uniform(-0.1, 0.1, (N, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = _t(o, dev), _t(d, dev)
    aabb = torch.tensor([-1, -0.5, -1, 1, 0.5, 1], dtype=torch.float32, device=dev)
    nears, fars = T.near_far_from_aabb(o, d, aabb, 0.05)
    window = (nears + 0.3, fars - 0.2)
    got = T.march_rays(o, d, nears, fars, sb, cfg, window, cull_T)
    want = T.march_rays_plain(o, d, nears, fars, sb, cfg, window, cull_T)
    torch.cuda.synchronize()
    assert int(want["valid"].sum()) > 10_000
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["count"], want["count"])
    for k in ("t", "dt", "xyz"):
        assert float((got[k] - want[k]).abs().max()) <= 1e-6, k


def test_composite_kernel_matches_twin(dev):
    rng = np.random.default_rng(6)
    N, S = 50_000, 16
    sig = rng.uniform(0.0, 40.0, (N, S)).astype(np.float32)
    dts = np.full((N, S), 0.05, np.float32)
    ts = (3.0 + np.cumsum(dts, axis=1)).astype(np.float32)
    valid = rng.random((N, S)) < 0.85
    dts[~valid] = 0.0
    args = [_t(v, dev) for v in (sig, rng.random((N, S, 3)).astype(np.float32), dts, ts, valid)]
    amb = _t(rng.random((N, S)).astype(np.float32), dev)
    got = T.composite_rays(*args, ambient=amb, T_thresh=1e-4)
    want = T.composite_rays_plain(*args, ambient=amb, T_thresh=1e-4)
    torch.cuda.synchronize()
    for k in got:
        assert float((got[k] - want[k]).abs().max()) <= 1e-5, k
    assert -math.log(1e-4) < float((args[0] * args[2]).sum(1).max())


def test_kernel_wrapper_refuses_bad_inputs(dev):
    spec = T.GridSpec.create(input_dim=3, num_levels=2)
    emb = torch.zeros(spec.n_embeddings, 2, device=dev)
    with pytest.raises(ValueError):
        T.grid_encode(torch.zeros(4, 3, device=dev, dtype=torch.float64), emb, spec)
    with pytest.raises(ValueError):
        T.grid_encode(torch.zeros(4, 3, device=dev), emb.cpu(), spec)
    z = torch.zeros(4, 2, device=dev)
    with pytest.raises(ValueError):  # rgbs [4, 3, 3] do not fit [N, S, 3]
        T.composite_rays(z, torch.zeros(4, 3, 3, device=dev), z, z, z.bool(), z)
    o = torch.zeros(4, 3, device=dev)
    sb = torch.zeros(32**3, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # nears of the wrong length
        T.march_rays(o, o, z[:3, 0], z[:, 0], sb, T.MarchConfig(grid_size=32, dt_gamma=0.0),
                     (z[:, 0], z[:, 0]))
