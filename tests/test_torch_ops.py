"""The port's ops (radnerf_tpu_torch.ops) against the JAX package's, on the
CPU: the same numpy inputs go through both.

On CPU tensors the kernel wrappers run their plain twins, so these tests
hold the twins' semantics to the JAX functions. The JAX side runs op by op
(not under ``jit``) where exactness matters: inside a fused ``jit`` graph
XLA:CPU contracts ``a*b + c`` into an FMA, which moves ``x*scale + 0.5`` by
an ulp (up to 3e-5 on N(0, 1) tables at the mid levels), while the port
rounds each op, as the JAX ops do one at a time.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.ops import marching as jmarch
from radnerf_tpu.ops import morton as jmorton
from radnerf_tpu.ops.activation import trunc_exp as j_trunc_exp
from radnerf_tpu.ops.freq_encode import freq_encode as j_freq_encode
from radnerf_tpu.ops.grid_encode import (
    GridSpec as JGridSpec,
    build_packed_table,
    grid_encode01,
    grid_encode_packed,
)
from radnerf_tpu.ops.ray_aabb import near_far_from_aabb as j_near_far
from radnerf_tpu.ops.sh_encode import sh_encode as j_sh_encode

from radnerf_tpu_torch import ops as T
from test_torch_kernels import composite_rows

def _T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------- grid encode
@pytest.mark.parametrize("input_dim", [2, 3])
def test_grid_encode_twin_matches_jax(input_dim):
    """Twin vs JAX grid_encode01 and grid_encode_packed at the shipped 16x2
    shape with fp32 N(0, 1) tables, points in and out of [-1, 1]. Tolerance
    atol 1e-6, rtol 1e-5: the corner sums run in the same order, so what is
    left is fp32 summation order in the packed form."""
    kw = dict(input_dim=input_dim, num_levels=16, level_dim=2, base_resolution=16,
              log2_hashmap_size=16, desired_resolution=2048)
    jspec, tspec = JGridSpec.create(**kw), T.GridSpec.create(**kw)
    assert tspec.offsets == jspec.offsets
    assert [tspec.level_scale(l) for l in range(16)] == \
        [jspec.level_scale(l) for l in range(16)]
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(jspec.n_embeddings, 2)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (256, input_dim)).astype(np.float32)
    x[0], x[1] = -1.0, 1.0
    x[2, 0] = 1.3  # outside -> zeros
    x[3, -1] = -1.01

    got = T.grid_encode(_T(x), _T(emb), tspec, 1.0).numpy()
    assert got.shape == (256, 32)
    np.testing.assert_array_equal(got[2:4], 0.0)
    want = _np(grid_encode01(jnp.asarray((x + 1.0) / 2.0), jnp.asarray(emb), jspec))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    packed = build_packed_table(jnp.asarray(emb), jspec)
    want_p = _np(grid_encode_packed(jnp.asarray(x), packed, jspec, 1.0))
    np.testing.assert_allclose(got, want_p, rtol=1e-5, atol=1e-6)


def _misaligned(t):
    """t's values in a tensor whose data starts 4 bytes past a 16-byte line."""
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
    start = next(i for i in range(4) if (flat.data_ptr() + t.element_size() * i) % 16 == 4)
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case", ["channels", "levels", "alignment", "bf16-channels",
                                  "pack-alignment"])
def test_grid_kernel_args_refuse_what_the_kernels_cannot_take(case):
    """Kernels A and A' and their bf16 variants take any channel and level
    count (17 channels and 33 levels pass the wrappers' check, in float32
    and in bf16), and a table whose row pairs are aligned (16 bytes at 2
    channels); the check raises before a launch for a table whose channels
    or rows do not fit the grid, a misaligned one, and a bf16 table of a
    hash grid (no packed copy). The packing pass reads a bf16 table's rows
    in their widest unit (16 bytes at 8 channels): its check raises for a
    table off that unit."""
    from radnerf_tpu_torch.ops.grid_encode import _check_kernel_args, _check_pack_args

    if case == "pack-alignment":
        spec = T.GridSpec.create(input_dim=3, num_levels=4, level_dim=8, base_resolution=4,
                                 log2_hashmap_size=8)
        table = torch.zeros(spec.n_embeddings, 8, dtype=torch.bfloat16)
        _check_pack_args(table, spec)  # an aligned table passes
        with pytest.raises(ValueError):
            _check_pack_args(_misaligned(table), spec)
        return

    kw = dict(input_dim=3, num_levels=4, base_resolution=4, log2_hashmap_size=8)
    kw.update({"channels": dict(level_dim=17), "levels": dict(num_levels=33),
               "alignment": {}, "bf16-channels": dict(level_dim=17)}[case])
    spec = T.GridSpec.create(**kw)
    emb = torch.zeros(spec.n_embeddings, spec.level_dim)
    x = torch.zeros(4, 3)
    if case == "bf16-channels":
        emb = emb.to(torch.bfloat16)
        _check_kernel_args(x, emb, spec)  # 17 bf16 channels pass
        hashed = T.GridSpec.create(**{**kw, "gridtype": "hash"})
        emb = torch.zeros(hashed.n_embeddings, 17, dtype=torch.bfloat16)
        spec = hashed
    elif case == "alignment":
        _check_kernel_args(x, emb, spec)  # an aligned table passes
        emb = _misaligned(emb)
    elif case == "channels":
        _check_kernel_args(x, emb, spec)  # 17 channels pass
        emb = torch.zeros(spec.n_embeddings, 16)
    else:
        _check_kernel_args(x, emb, spec)  # 33 levels pass
        emb = emb[:-8]  # the rows of a grid with fewer
    with pytest.raises(ValueError):
        _check_kernel_args(x, emb, spec)


def test_kernel_library_hash_follows_included_headers(tmp_path, monkeypatch):
    """A kernel's library is named by a hash of its source and of every
    header in the kernel directory, so an edited shared header rebuilds the
    kernels that include it, while another kernel's source does not."""
    from radnerf_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "other.cu").write_text("// v1\n")
    (tmp_path / "common.cuh").write_text("// v1\n")
    k = _kernels.Kernel("k", {})
    path = k.library_path()
    (tmp_path / "other.cu").write_text("// v2\n")
    assert k.library_path() == path
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert k.library_path() != path


# -------------------------------------------------------------- exact ops
def test_morton_and_packbits_exact():
    rng = np.random.default_rng(1)
    coords = rng.integers(0, 1024, (4096, 3)).astype(np.int32)
    codes = _np(jmorton.morton3d(jnp.asarray(coords)))
    got = T.morton3d(_T(coords)).numpy()
    np.testing.assert_array_equal(got, codes)
    np.testing.assert_array_equal(T.morton3d_invert(_T(codes)).numpy(), coords)
    grid = rng.uniform(-1.0, 3.0, (1, 16**3)).astype(np.float32)
    np.testing.assert_array_equal(
        T.packbits(_T(grid), 1.0).numpy(), _np(jmorton.packbits(jnp.asarray(grid), 1.0)))


def test_build_sigma_bytes_exact():
    rng = np.random.default_rng(2)
    grid = np.concatenate([
        rng.lognormal(0.0, 4.0, 5000), rng.uniform(-1.0, 1.0, 1000),
        [0.0, -1.0, 1e-35, 2.0**-10, 2.0**21, 1e30, 5.0, 5.0001]]).astype(np.float32)
    got = T.build_sigma_bytes(_T(grid), 5.0).numpy()
    np.testing.assert_array_equal(got, _np(jmarch.build_sigma_bytes(jnp.asarray(grid), 5.0)))
    q = np.arange(128, dtype=np.uint8)
    np.testing.assert_allclose(T.dequant_sigma(_T(q)).numpy(),
                               _np(jmarch._dequant_sigma(jnp.asarray(q))), rtol=1e-6)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode_matches_jax(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(T.sh_encode(_T(d), degree).numpy(),
                               _np(j_sh_encode(jnp.asarray(d), degree)), atol=1e-6)


def test_freq_near_far_trunc_exp_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (64, 6)).astype(np.float32)
    assert T.freq_output_dim(6, 4) == 54
    np.testing.assert_allclose(T.freq_encode(_T(x), 4).numpy(),
                               _np(j_freq_encode(jnp.asarray(x), 4)), atol=1e-6)

    o = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    aabb = np.array([-1, -0.5, -1, 1, 0.5, 1], np.float32)
    n_t, f_t = T.near_far_from_aabb(_T(o), _T(d), _T(aabb), 0.05)
    n_j, f_j = j_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.05)
    assert (n_t.numpy() == 3.4028235e38).any()  # some rays miss
    np.testing.assert_allclose(n_t.numpy(), _np(n_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), _np(f_j), atol=1e-6, rtol=1e-6)

    v = np.linspace(-20, 20, 101).astype(np.float32)
    xt = _T(v).requires_grad_(True)
    y = T.trunc_exp(xt)
    y.sum().backward()
    y_j, g_j = jax.value_and_grad(lambda a: j_trunc_exp(a).sum())(jnp.asarray(v))
    np.testing.assert_allclose(y.detach().numpy(), _np(jnp.exp(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), _np(g_j), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ march
def _blob_scene(H=32, N=96, seed=3):
    """Blob of 20 with scattered 30s (Morton order) and rays through it; at
    these densities the 1e-4 cull keeps about 9 points a ray."""
    rng = np.random.default_rng(seed)
    coords = _np(jmorton.morton3d_invert(jnp.arange(H**3, dtype=jnp.int32)))
    xyz = 2.0 * coords.astype(np.float32) / (H - 1) - 1.0
    r = np.linalg.norm(xyz - np.array([0.1, 0.0, -0.1], np.float32), axis=-1)
    dens = np.where(r < 0.45, 20.0, 0.0).astype(np.float32)
    dens[rng.random(H**3) < 0.01] = 30.0
    o = np.zeros((N, 3), np.float32)
    o[:, 2] = -3.0
    o[:, :2] = rng.uniform(-0.9, 0.9, (N, 2))
    d = np.zeros((N, 3), np.float32)
    d[:, 2] = 1.0
    d[:, :2] = rng.uniform(-0.15, 0.15, (N, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dens, o, d, rng


# the earlier cases keep their ids ("0.0", "0.0001"); "-slots3" cuts the
# lattice to 3 slots, below many rays' counts
@pytest.mark.parametrize("cull_T,slots", [
    pytest.param(c, s, id=f"{c}" if s is None else f"{c}-slots{s}")
    for s in (None, 3) for c in (0.0, 1e-4)])
def test_march_twin_matches_jax(cull_T, slots):
    """Twin vs JAX march_rays (sigma-byte path, affine orbit, windowed) on a
    blob grid of 32 with max_steps 8, and with the lattice truncated to
    ``sample_slots``: the same sample set (valid identical), t and xyz
    within 1e-5 where valid, the same max_count."""
    H = 32
    kw = dict(bound=1.0, grid_size=H, max_steps=8, dt_gamma=0.0, sample_slots=slots)
    cfg_j, cfg_t = jmarch.MarchConfig(**kw), T.MarchConfig(**kw)
    assert cfg_t.n_march_iters == cfg_j.n_march_iters
    assert cfg_t.n_sample_slots == cfg_j.n_sample_slots
    dens, o, d, rng = _blob_scene(H)
    aabb = jnp.asarray([-1.0, -0.5, -1.0, 1.0, 0.5, 1.0])
    nears, fars = (_np(v) for v in j_near_far(jnp.asarray(o), jnp.asarray(d), aabb, 0.05))
    # a window inside [near, far], so k0 > 0 and t_hi < far on most rays
    t_lo = (nears + rng.uniform(0.0, 0.4, nears.shape)).astype(np.float32)
    t_hi = (fars - rng.uniform(0.0, 0.4, fars.shape)).astype(np.float32)

    sb_j = jmarch.build_sigma_bytes(jnp.asarray(dens), 5.0)
    want = jmarch.march_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears), jnp.asarray(fars), None,
        cfg_j, t_window=(jnp.asarray(t_lo), jnp.asarray(t_hi)),
        sigma_rows=jmarch.pack_sigma_byte_rows(sb_j), cull_T=cull_T)
    got = T.march_rays(_T(o), _T(d), _T(nears), _T(fars),
                       T.build_sigma_bytes(_T(dens), 5.0), cfg_t,
                       t_window=(_T(t_lo), _T(t_hi)), cull_T=cull_T)
    valid = _np(want["valid"])
    assert valid.sum() > (100 if slots is None else 50)  # the scene is not trivial
    assert valid.shape == (96, cfg_t.n_sample_slots)
    if slots is not None:  # the truncation cuts many rays
        assert (got["count"].numpy() > slots).sum() >= 10
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k in ("t", "dt", "xyz"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-5, rtol=0)
    assert int(got["count"].max()) == int(want["max_count"])


# --------------------------------------------------------------- composite
# the earlier case keeps its id ("dense-16")
@pytest.mark.parametrize("layout,S", [("dense", 16), ("sparse", 16), ("empty", 16),
                                      ("stop-first", 16), ("stop-last", 16),
                                      ("dense", 13), ("sparse", 13)],
                         ids=lambda v: str(v))
def test_composite_twin_matches_jax(layout, S):
    """Twin vs JAX composite_rays on dense rows whose transmittance crosses
    T_thresh mid-lattice with invalid holes, on sparse and on empty rows,
    on rows that stop at their first or last slots, and at an S that is not
    16. Tolerance 1e-6 (abs and rel): the sums run over S steps in another
    order."""
    rng = np.random.default_rng(4)
    N = 256
    sig, rgb, dts, ts, valid, amb = composite_rows(layout, N, S, rng)
    want = jmarch.composite_rays(*(jnp.asarray(v) for v in (sig, rgb, dts, ts, valid)),
                                 ambient=jnp.asarray(amb), T_thresh=1e-4)
    got = T.composite_rays(*(_T(v) for v in (sig, rgb, dts, ts, valid)),
                           ambient=_T(amb), T_thresh=1e-4)
    if layout == "dense":  # the early stop really cuts rays mid-lattice
        tau = np.cumsum(np.where(valid, sig * dts, 0.0), axis=1)
        crossed = (tau[:, :-1] > -math.log(1e-4)).any(axis=1)
        assert 0.2 < crossed.mean() < 1.0
    if layout == "empty":
        assert all(float(v.abs().max()) == 0.0 for v in got.values())
    for k in ("image", "depth", "weights_sum", "ambient_sum"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-6, rtol=1e-6)
