"""Each hand-written CUDA kernel of the port against its plain PyTorch twin,
on the card. The ``cuda`` mark (registered in pytest.ini) labels them;
without a card the ``dev`` fixture skips them (the decision is made inside
the fixture, never at import). Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(``--noconftest``: tests/conftest.py pins JAX to the CPU and needs JAX.)

Tolerances: kernels and twins run the same float32 operations in the same
order (the kernels are built with -fmad=false), so the expected difference
is 0; the stated tolerances leave room for a last-ulp difference between
CUDA's expf/exp2f and PyTorch's. The backward kernels are held to autograd
through the plain versions: A' adds into the table gradient with atomics
whose order changes from run to run (and the plain version's index_put
accumulates in its own order), C' takes its suffix sums from the saved
outputs where autograd multiplies through the transmittance chain; both
are held to 1e-5 of the largest gradient of the tensor, a float32 sum in
another order.
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


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("input_dim", [2, 3])
def test_grid_encode_backward_kernel_matches_plain(dev, input_dim):
    spec = T.GridSpec.create(input_dim=input_dim, desired_resolution=2048)
    rng = np.random.default_rng(input_dim + 20)
    emb = _t(rng.normal(size=(spec.n_embeddings, 2)).astype(np.float32), dev)
    x = rng.uniform(-1.02, 1.02, (50_000, input_dim)).astype(np.float32)
    x = _t(x, dev)
    g = _t(rng.normal(size=(50_000, 32)).astype(np.float32), dev)
    k = _kernels.KERNELS["grid_encode_backward"]
    before = k.launches
    gt_k, gx_k = T.grid_encode_backward(x, emb, g, spec)
    assert k.launches == before + 1
    gt_p, gx_p = T.grid_encode_backward_plain(x, emb, g, spec)
    torch.cuda.synchronize()
    assert _rel_err(gt_k, gt_p) <= 1e-5
    assert _rel_err(gx_k, gx_p) <= 1e-5
    # the autograd path: a grad_fn backed by kernel A', x's gradient on request
    xr, er = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    out = T.grid_encode(xr, er, spec)
    assert out.grad_fn is not None
    before = k.launches
    (out * g).sum().backward()
    assert k.launches == before + 1
    assert _rel_err(er.grad, gt_p) <= 1e-5 and _rel_err(xr.grad, gx_p) <= 1e-5
    assert T.grid_encode_backward(x, emb, g, spec, need_x=False)[1] is None


def test_composite_backward_kernel_matches_plain(dev):
    rng = np.random.default_rng(26)
    N, S = 50_000, 16
    sig = rng.uniform(0.0, 40.0, (N, S)).astype(np.float32)
    dts = np.full((N, S), 0.05, np.float32)
    ts = (3.0 + np.cumsum(dts, axis=1)).astype(np.float32)
    valid = rng.random((N, S)) < 0.85
    dts[~valid] = 0.0
    args = [_t(v, dev) for v in (sig, rng.random((N, S, 3)).astype(np.float32), dts, ts,
                                 valid, rng.random((N, S)).astype(np.float32))]
    keys = ("image", "depth", "weights_sum", "ambient_sum")
    grads = {k: _t(rng.normal(size=(N, 3) if k == "image" else (N,)).astype(np.float32), dev)
             for k in keys}
    outs = T.composite_rays(*args, T_thresh=1e-4)
    k = _kernels.KERNELS["composite_rays_backward"]
    before = k.launches
    got = T.composite_rays_backward(*args, grads, outs, T_thresh=1e-4)
    assert k.launches == before + 1
    want = T.composite_rays_backward_plain(*args, grads, T_thresh=1e-4)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-5
    assert float(got[0][~args[4]].abs().max()) == 0.0
    # the autograd path
    sr, rr, ar = (v.clone().requires_grad_(True) for v in (args[0], args[1], args[5]))
    out = T.composite_rays(sr, rr, args[2], args[3], args[4], ar, T_thresh=1e-4)
    assert out["image"].grad_fn is not None
    sum((out[k2] * grads[k2]).sum() for k2 in keys).backward()
    for a, b in zip((sr.grad, rr.grad, ar.grad), want):
        assert _rel_err(a, b) <= 1e-5


def test_march_kernel_with_noises_matches_twin(dev):
    H = 64
    cfg = T.MarchConfig(grid_size=H, max_steps=16, dt_gamma=0.0)
    rng = np.random.default_rng(27)
    coords = T.morton3d_invert(torch.arange(H**3)).numpy()
    xyz = 2.0 * (coords + 0.5) / H - 1.0
    dens = np.where(np.linalg.norm(xyz, axis=-1) < 0.5, 30.0, 0.0).astype(np.float32)
    sb = T.build_sigma_bytes(_t(dens, dev), 5.0)
    N = 20_000
    o = np.zeros((N, 3), np.float32)
    o[:, 2] = -3.0
    o[:, :2] = rng.uniform(-0.8, 0.8, (N, 2))
    d = np.zeros((N, 3), np.float32)
    d[:, 2] = 1.0
    o, d = _t(o, dev), _t(d, dev)
    aabb = torch.tensor([-1, -0.5, -1, 1, 0.5, 1], dtype=torch.float32, device=dev)
    nears, fars = T.near_far_from_aabb(o, d, aabb, 0.05)
    noises = _t(rng.random(N).astype(np.float32), dev)
    args = (o, d, nears, fars, sb, cfg, (nears + 0.3, fars - 0.2), 1e-4)
    got = T.march_rays(*args, noises=noises)
    want = T.march_rays_plain(*args, noises=noises)
    torch.cuda.synchronize()
    assert int(want["valid"].sum()) > 10_000
    assert torch.equal(got["valid"], want["valid"]) and torch.equal(got["count"], want["count"])
    for key in ("t", "dt", "xyz"):
        assert float((got[key] - want[key]).abs().max()) <= 1e-6, key
        assert int((got[key].reshape(N, 16, -1)[~got["valid"]] != 0).sum()) == 0
    assert not torch.equal(got["t"], T.march_rays(*args)["t"])
    with pytest.raises(RuntimeError):  # kernel B has no backward
        T.march_rays(o.clone().requires_grad_(True), *args[1:])


@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 16), (torch.float32, 3),
                                         (torch.uint8, 5)])
def test_row_gather_kernel_matches_plain(dev, dtype, width):
    rng = np.random.default_rng(28)
    table = _t(rng.normal(size=(4096, width)).astype(np.float32) * 50, dev).to(dtype)
    for idx_dtype in (torch.int32, torch.int64):
        idx = _t(rng.integers(0, 4096, (3, 7000)), dev).to(idx_dtype)
        got = T.take_rows(table, idx)
        assert got.shape == (3, 7000, width)
        assert torch.equal(got, table[idx])
    # outside [0, T) the kernel writes zero rows where the plain version raises
    got = T.take_rows(table, _t(np.array([-1, 4096, 5, 1 << 20]), dev).to(torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(got[2], table[5]) and bool((got[[0, 1, 3]] == 0).all())
    study = T.bench_gather_study(P=1 << 16, tables=(4096,), device=dev)
    assert study[4096]["equal"] and study[4096]["max_abs_err"] == 0.0
