"""The grid and march variants the JAX package takes (hash grids, smoothstep,
align_corners, 1/4/8 channels; the general orbit and the mip cascade) and
the last four ops (grid_total_variation, sph_from_ray, sample_pdf,
get_encoder) in the port against the JAX package, on the CPU: the same
numpy inputs go through both.

On CPU tensors the kernel wrappers run their plain versions and autograd
runs through their plain ops. The JAX side runs op by op (not under
``jit``) where a sample set or a cell has to match exactly: inside a fused
``jit`` graph XLA:CPU contracts ``a*b + c`` into an FMA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.ops import marching as jmarch
from radnerf_tpu.ops import morton as jmorton
from radnerf_tpu.ops.encoding import get_encoder as j_get_encoder
from radnerf_tpu.ops.grid_encode import GridSpec as JGridSpec
from radnerf_tpu.ops.grid_encode import grid_encode01
from radnerf_tpu.ops.grid_encode import grid_total_variation as j_grid_tv
from radnerf_tpu.ops.ray_aabb import near_far_from_aabb as j_near_far
from radnerf_tpu.ops.sampling import sample_pdf as j_sample_pdf
from radnerf_tpu.ops.sampling import sph_from_ray as j_sph_from_ray

from radnerf_tpu_torch import ops as T


def _T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


@pytest.fixture
def one_thread():
    """torch on one thread for the test: its tensors are tiny, and a pool
    of threads on a busy host waits far longer than it works."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- grid encode
# the base resolution a D: level 0 fits a 2^8-row table densely, the next
# level overflows it (D = 1: the third)
_BASE = {1: 64, 2: 8, 3: 4, 4: 2, 7: 1, 8: 1}


def _specs(gridtype, interpolation, align_corners, level_dim, input_dim, num_levels=4):
    """A grid whose finer levels overflow a 2^8-row table (hashed under
    "hash"), as (JAX spec, port spec): 4 levels at a scale of 2 a level,
    or more levels over the same span."""
    kw = dict(input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
              base_resolution=_BASE[input_dim], log2_hashmap_size=8,
              per_level_scale=2.0 ** (3 / max(num_levels - 1, 1)), gridtype=gridtype,
              interpolation=interpolation, align_corners=align_corners)
    return JGridSpec.create(**kw), T.GridSpec.create(**kw)


GRID_CASES = [(gt, it, ac, c, d) for gt in ("tiled", "hash") for it in ("linear", "smoothstep")
              for ac in (False, True) for c in (1, 4, 8) for d in (2, 3)]
# the channel counts the kernels take at run time (3, 16): a tiled linear
# grid and a hash grid with smoothstep and align_corners
CHANNEL_CASES = [(gt, it, ac, c, d) for gt, it, ac in (("tiled", "linear", False),
                                                        ("hash", "smoothstep", True))
                 for c in (3, 16) for d in (2, 3)]
# the grids past RAD-NeRF's, which the kernels' general path runs: D = 1,
# 4 and 7 on hash grids, 7 and 8 on tiled ones, 33 levels, 17 and 32
# channels (each with its level count)
GENERAL_CASES = [("hash", "linear", False, 2, 1, 4), ("hash", "smoothstep", True, 2, 4, 4),
                 ("hash", "linear", False, 2, 7, 3), ("tiled", "linear", False, 2, 7, 3),
                 ("tiled", "smoothstep", False, 2, 7, 1),
                 ("tiled", "smoothstep", False, 1, 8, 2), ("hash", "linear", False, 2, 2, 33),
                 ("tiled", "linear", False, 17, 3, 4), ("hash", "smoothstep", True, 32, 3, 4)]
# JAX op by op takes ~20 s for the vjp of a 4-level 7-D grid (~0.3 s a 3-D
# one; under jit XLA:CPU compiles a 7-D grid's for ~15 min): past D = 4 the
# encode alone is held to JAX's, but for a single level (the 7-D one: its
# 128 corners' weights and their derivatives, ~8 s)
_MAX_VJP_DIM = 4


@pytest.mark.parametrize(
    "gridtype,interpolation,align_corners,level_dim,input_dim,num_levels",
    [pytest.param(*c, 4, id="-".join(map(str, c))) for c in GRID_CASES + CHANNEL_CASES]
    + [pytest.param(*c, id="general-" + "-".join(map(str, c))) for c in GENERAL_CASES])
@pytest.mark.usefixtures("one_thread")
def test_grid_variant_matches_jax(gridtype, interpolation, align_corners, level_dim,
                                  input_dim, num_levels):
    """The plain encode against JAX grid_encode01 (op by op) on every
    variant: rtol 1e-5, atol 1e-6 (the same corner sums in the same order);
    the table and x gradients against jax.grad within 1e-5 of the largest
    (up to D = 4, and on a single level); a point outside the box encodes to
    0 with zero gradients.
    Under "hash" two or more finer levels are hashed, the coarsest is not."""
    jspec, tspec = _specs(gridtype, interpolation, align_corners, level_dim, input_dim,
                          num_levels)
    assert tspec.offsets == jspec.offsets
    hashed = [tspec.hashed(l) for l in range(num_levels)]
    assert not hashed[0] and sum(hashed) >= (2 if gridtype == "hash" else 0)
    rng = np.random.default_rng(level_dim * 10 + input_dim + num_levels - 4)
    n = 96
    emb = rng.normal(size=(jspec.n_embeddings, level_dim)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (n, input_dim)).astype(np.float32)
    x[0], x[1] = -1.0, 1.0
    x[2, 0] = 1.2  # outside -> zeros
    g = rng.normal(size=(n, num_levels * level_dim)).astype(np.float32)

    def encode(xj, ej):
        return grid_encode01((xj + 1.0) / 2.0, ej, jspec)

    xt = _T(x).requires_grad_(True)
    et = _T(emb).requires_grad_(True)
    got = T.grid_encode(xt, et, tspec, 1.0)
    (got * _T(g)).sum().backward()
    assert np.all(got.detach().numpy()[2] == 0.0) and np.all(xt.grad.numpy()[2] == 0.0)
    if input_dim > _MAX_VJP_DIM and num_levels > 1:
        want = encode(jnp.asarray(x), jnp.asarray(emb))
        np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5, atol=1e-6)
        return
    want, vjp = jax.vjp(encode, jnp.asarray(x), jnp.asarray(emb))
    want_x, want_t = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5, atol=1e-6)
    for name, gt_, w in (("table", et.grad, want_t), ("x", xt.grad, want_x)):
        w = _np(w)
        err = float(np.abs(gt_.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), f"{name}: {err}"


def test_bf16_plain_backward_takes_the_smoothstep_slope():
    """Under the bf16 policy the plain backward's x gradient on a smoothstep
    grid (the weights' rounding taken as the identity) equals autograd
    through the float32 plain encode of the bf16-rounded table with the
    bf16 upstream gradient: the slope 6 f (1 - f) is in, within 1e-5 of the
    largest."""
    spec = _specs("tiled", "smoothstep", False, 2, 2)[1]
    rng = np.random.default_rng(11)
    table = _T(rng.normal(size=(spec.n_embeddings, 2)).astype(np.float32)).to(torch.bfloat16)
    x = _T(rng.uniform(-0.95, 0.95, (64, 2)).astype(np.float32))
    g = _T(rng.normal(size=(64, 8)).astype(np.float32)).to(torch.bfloat16)
    got = T.grid_encode_backward(x, table, g, spec)[1]
    xr = x.clone().requires_grad_(True)
    (T.grid_encode(xr, table.float(), spec) * g.float()).sum().backward()
    assert float((got - xr.grad).abs().max()) <= 1e-5 * float(xr.grad.abs().max())


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_grid_total_variation_matches_jax(gridtype):
    """grid_total_variation and its table gradient against JAX's, rel 1e-5,
    at both grid types (and align_corners on the hash grid)."""
    jspec, tspec = _specs(gridtype, "linear", gridtype == "hash", 2, 3)
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(jspec.n_embeddings, 2)).astype(np.float32)
    x01 = rng.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    want, want_g = jax.value_and_grad(lambda e: j_grid_tv(jnp.asarray(x01), e, jspec, 1e-3))(
        jnp.asarray(emb))
    et = _T(emb).requires_grad_(True)
    got = T.grid_total_variation(_T(x01), et, tspec, 1e-3)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    err = float(np.abs(et.grad.numpy() - _np(want_g)).max())
    assert err <= 1e-5 * float(np.abs(_np(want_g)).max())


def test_kernel_refusals_of_the_variants():
    """On the card kernels A / A' take every grid the JAX package encodes --
    tiled and hash grids, linear or smoothstep, with or without
    align_corners, any D (D = 1 to 8 here), level count and channel count
    (33 and 64 levels, 17, 32 and 64 channels) -- and so do the bf16 kernels
    and the packing pass on tiled grids. What still raises: the bf16 kernels
    (and the packing pass) on a hash grid, which has no packed copy (JAX's
    build_packed_table raises on it, on the CPU too), and a hashed level at
    D > 7, which JAX has no prime for."""
    from radnerf_tpu_torch.ops.grid_encode import _check_kernel_args, _refuse_kernel_spec

    for gt, it, ac, c, d, n_levels in [(*c, 4) for c in GRID_CASES + CHANNEL_CASES] + \
            GENERAL_CASES + [("tiled", "linear", False, 2, 3, 64),
                             ("tiled", "linear", False, 64, 3, 4),
                             ("tiled", "linear", False, 2, 8, 4),
                             ("tiled", "linear", False, 2, 1, 4)]:
        spec = _specs(gt, it, ac, c, d, n_levels)[1]
        x = torch.zeros(4, d)
        _check_kernel_args(x, torch.zeros(spec.n_embeddings, c), spec)
        if gt == "tiled":
            _check_kernel_args(x, torch.zeros(spec.n_embeddings, c, dtype=torch.bfloat16),
                               spec)
    for d, c in ((3, 2), (1, 17), (4, 32), (7, 2)):
        spec = T.GridSpec.create(input_dim=d, num_levels=33, level_dim=c, gridtype="hash",
                                 base_resolution=4, log2_hashmap_size=8)
        _refuse_kernel_spec(spec, False)
        with pytest.raises(ValueError, match="packed"):
            _refuse_kernel_spec(spec, True)
        with pytest.raises(ValueError, match="packed"):
            _check_kernel_args(torch.zeros(4, d),
                               torch.zeros(spec.n_embeddings, c, dtype=torch.bfloat16), spec)
    unprimed = T.GridSpec.create(input_dim=8, num_levels=4, gridtype="hash", base_resolution=4,
                                 log2_hashmap_size=8)
    assert unprimed.hashed(0)
    with pytest.raises(ValueError, match="prime"):
        _refuse_kernel_spec(unprimed, False)
    with pytest.raises(ValueError, match="prime"):
        T.grid_encode(torch.zeros(4, 8), torch.zeros(unprimed.n_embeddings, 2), unprimed)
    hashed = T.GridSpec.create(input_dim=3, num_levels=4, gridtype="hash")
    with pytest.raises(ValueError):
        T.pack_table(torch.zeros(hashed.n_embeddings, 2), hashed)


# -------------------------------------------------------------- the ops
def test_sph_from_ray_matches_jax():
    rng = np.random.default_rng(8)
    o = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = _np(j_sph_from_ray(jnp.asarray(o), jnp.asarray(d), 2.5))
    got = T.sph_from_ray(_T(o), _T(d), 2.5).numpy()
    assert got.shape == (256, 2) and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    """sample_pdf at det=True, and at det=False with JAX's own draw of u
    (jax.random.uniform of the same key) handed to the port: atol 1e-5 on
    depths in [2, 6] (cumsum and the quantiles round in another order)."""
    rng = np.random.default_rng(9)
    B, Tn, n = 64, 17, 24
    bins = np.sort(rng.uniform(2.0, 6.0, (B, Tn)), axis=-1).astype(np.float32)
    weights = rng.random((B, Tn - 1)).astype(np.float32)
    weights[:4] = 0.0  # all-zero rows: the 1e-5 floor makes them uniform
    weights[4:8, 3:] = 0.0  # empty bins: denom < 1e-5
    key = jax.random.PRNGKey(3)
    want = _np(j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n, det=det, key=key))
    u = None if det else _T(_np(jax.random.uniform(key, (B, n))))
    got = T.sample_pdf(_T(bins), _T(weights), n, det=det, u=u).numpy()
    assert got.shape == (B, n)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the port's own draw lands in the bins' range
    drawn = T.sample_pdf(_T(bins), _T(weights), n, generator=torch.Generator().manual_seed(0))
    assert float(drawn.min()) >= 2.0 and float(drawn.max()) <= 6.0


@pytest.mark.parametrize("encoding", ["None", "frequency", "spherical_harmonics", "hashgrid",
                                      "tiledgrid"])
def test_get_encoder_matches_jax(encoding):
    """Every branch of get_encoder: the output dim and the output on the
    same inputs and table (the grids at 4 levels of 2^8 rows, smoothstep on
    the hash grid); a grid's init draws U(-1e-4, 1e-4) of the table's shape
    onto the generator's device, or the card without one, and the others
    have no init."""
    kw = dict(input_dim=3, multires=4, degree=3)
    if encoding in ("hashgrid", "tiledgrid"):
        kw.update(num_levels=4, base_resolution=8, log2_hashmap_size=8,
                  desired_resolution=64,
                  interpolation="smoothstep" if encoding == "hashgrid" else "linear")
    enc_j, dim_j, init_j = j_get_encoder(encoding, **kw)
    enc_t, dim_t, init_t = T.get_encoder(encoding, **kw)
    assert dim_t == dim_j and (init_t is None) == (init_j is None)
    rng = np.random.default_rng(10)
    x = rng.uniform(-0.9, 0.9, (64, 3)).astype(np.float32)
    if encoding == "spherical_harmonics":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    params = None
    if init_t is not None:
        table = init_t(torch.Generator().manual_seed(0), device="cpu")
        assert table.device.type == "cpu"
        assert torch.equal(init_t(torch.Generator().manual_seed(0)), table)  # the generator's
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):  # no generator: the card
                init_t()
        assert table.shape == init_j(jax.random.PRNGKey(0)).shape
        assert float(table.abs().max()) <= 1e-4 and float(table.std()) > 1e-5
        assert enc_t.spec.gridtype == ("hash" if encoding == "hashgrid" else "tiled")
        params = rng.normal(size=tuple(table.shape)).astype(np.float32)
    want = _np(enc_j(jnp.asarray(x), None if params is None else jnp.asarray(params), 1.0))
    got = enc_t(_T(x), None if params is None else _T(params), 1.0).numpy()
    assert got.shape == (64, dim_t)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ march
def _cascade_scene(H=32, N=96, seed=4):
    """A two-cascade density grid (Morton order per cascade): at level 0 a
    blob of 20 in the unit box with scattered 30s, at level 1 a wider shell
    of 20 (seen where the level is 1), and rays from z = -5 through the box
    of bound 2."""
    rng = np.random.default_rng(seed)
    coords = _np(jmorton.morton3d_invert(jnp.arange(H**3, dtype=jnp.int32)))
    grids = []
    for level, radius in ((0, 0.5), (1, 1.4)):
        xyz = (2.0 * coords.astype(np.float32) / (H - 1) - 1.0) * 2.0**level
        r = np.linalg.norm(xyz - np.array([0.1, 0.0, -0.1], np.float32), axis=-1)
        dens = np.where(r < radius, 20.0, 0.0).astype(np.float32)
        dens[rng.random(H**3) < 0.01] = 30.0
        grids.append(dens)
    o = np.zeros((N, 3), np.float32)
    o[:, 2] = -5.0
    o[:, :2] = rng.uniform(-1.2, 1.2, (N, 2))
    d = np.zeros((N, 3), np.float32)
    d[:, 2] = 1.0
    d[:, :2] = rng.uniform(-0.2, 0.2, (N, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.stack(grids), o, d, rng


# (cascade, dt_gamma, bound): cascade 2 on the affine orbit (dt_gamma 0), the
# general orbit at cascade 1 and at cascade 2 (t * dt_gamma crosses dt_min)
MARCH_CASES = {"cascade2-affine": (2, 0.0, 2.0), "cascade1-general": (1, 1.0 / 32, 1.0),
               "cascade2-general": (2, 1.0 / 64, 2.0)}


@pytest.mark.parametrize("window", [False, True], ids=["nowindow", "window"])
@pytest.mark.parametrize("noise", [False, True], ids=["nonoise", "noise"])
@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_march_variant_matches_jax(case, noise, window):
    """The plain march against JAX march_rays (sigma-byte path, op by op)
    on grid 32 with max_steps 64 and the 1e-4 cull: valid identical, t, dt
    and xyz within 1e-5, the same max_count; at cascade 2 both levels are
    looked up, on the general orbit the step really varies. "nowindow" is
    the window (near, far), which JAX's t_window=None marches alike."""
    cascade, dt_gamma, bound = MARCH_CASES[case]
    H = 32
    kw = dict(bound=bound, cascade=cascade, grid_size=H, max_steps=64, dt_gamma=dt_gamma)
    cfg_j, cfg_t = jmarch.MarchConfig(**kw), T.MarchConfig(**kw)
    assert cfg_t.n_march_iters == cfg_j.n_march_iters
    assert cfg_t.affine == (dt_gamma == 0.0)
    grids, o, d, rng = _cascade_scene(H)
    grid = grids[:cascade]
    if bound == 1.0:
        o = o * np.float32(0.6)
    b = np.float32(bound)
    aabb = jnp.asarray([-b, -b / 2, -b, b, b / 2, b])
    nears, fars = (_np(v) for v in j_near_far(jnp.asarray(o), jnp.asarray(d), aabb, 0.05))
    t_lo, t_hi = nears, fars
    if window:
        t_lo = (nears + rng.uniform(0.0, 0.4, nears.shape)).astype(np.float32)
        t_hi = (fars - rng.uniform(0.0, 0.4, fars.shape)).astype(np.float32)
    noises = rng.random(nears.shape).astype(np.float32) if noise else None
    sb_j = jmarch.build_sigma_bytes(jnp.asarray(grid), 5.0)
    want = jmarch.march_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears), jnp.asarray(fars), None, cfg_j,
        noises=None if noises is None else jnp.asarray(noises),
        t_window=(jnp.asarray(t_lo), jnp.asarray(t_hi)),
        sigma_rows=jmarch.pack_sigma_byte_rows(sb_j), cull_T=1e-4)
    sb_t = T.build_sigma_bytes(_T(grid), 5.0)
    assert sb_t.numel() == cascade * H**3
    got = T.march_rays(_T(o), _T(d), _T(nears), _T(fars), sb_t, cfg_t,
                       t_window=(_T(t_lo), _T(t_hi)), cull_T=1e-4,
                       noises=None if noises is None else _T(noises))
    valid = _np(want["valid"])
    assert valid.sum() > 150
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k in ("t", "dt", "xyz"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-5, rtol=0)
    assert int(got["count"].max()) == int(want["max_count"])
    dts = got["dt"].numpy()[valid]
    assert (len(np.unique(dts)) > 1) == (dt_gamma > 0.0)
    if cascade == 2:  # samples in both levels: inside and outside the unit box
        inner = np.abs(got["xyz"].numpy()[valid]).max(axis=-1) < 1.0
        assert inner.any() and (~inner).any()


# ------------------------------------------------------- the slice's path
# the narrow head model at the slice's grid: 8 levels of 4 channels (the
# 2-D ambient grid too), bound 2 (cascade 2), 32-wide MLPs
VARIANT_NET = dict(exp_eye=True, ind_num=8, bound=2.0, grid_levels=8, grid_ch=4,
                   hidden_dim=32, geo_feat_dim=15, hidden_dim_color=32, hidden_dim_ambient=32)
VARIANT_GRID = 32


def _variant_scene(net_kw):
    """(the JAX config of ``net_kw``, its params with U(-1, 1) tables, the [2,
    32^3] density grid: a blob of 20 at each cascade, the 48x48 camera's
    rays at z = -3.3)."""
    from radnerf_tpu.data.rays import get_rays
    from radnerf_tpu.models import NetworkConfig as JNetworkConfig
    from radnerf_tpu.models import init_params
    from test_train import _blob_grid

    cfg = JNetworkConfig(**net_kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: init_params(k, cfg))(jax.random.PRNGKey(13)))
    for k in ("encoder", "encoder_ambient"):
        params[k] = params[k] * 1e4
    grid = np.concatenate([_blob_grid(VARIANT_GRID), _blob_grid(VARIANT_GRID, radius=0.35)])
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, 24.0, 24.0), 48, 48, -1)
    return cfg, params, grid, rays


def _variant_states(rc_j, rc, grid):
    from radnerf_tpu.models import RendererState as JRendererState
    from radnerf_tpu.models import compute_occ_bbox
    from radnerf_tpu.models.renderer import compute_occ_sphere

    from radnerf_tpu_torch.convert import state_from_numpy

    g = jnp.asarray(grid)
    state_j = JRendererState.create(rc_j).replace(
        density_grid=g, density_bitfield=jmorton.packbits(g, 1.0),
        mean_density=jnp.asarray(1.0, jnp.float32),
        occ_bbox=compute_occ_bbox(rc_j, g, 1.0), occ_sphere=compute_occ_sphere(rc_j, g, 1.0),
    ).with_sigma_bytes(jmarch.build_sigma_bytes(g, 1.0))
    state = state_from_numpy(rc, grid, np.zeros(VARIANT_GRID**2, np.float32), 1.0, 0.0,
                             thresh=1.0, device="cpu")
    return state_j, state


def _nudged_ambient(monkeypatch):
    """Patch JAX's field trunk so its ambient coordinates move by ``s``
    ulps toward +inf (``s`` = 0: JAX's own; +-1: one ulp either way), the
    gradient flowing as without the nudge; returns the holder of ``s``."""
    import radnerf_tpu.models.network as jnet

    trunk, nudge = jnet._spatial_and_ambient, {"s": None}

    def nudged(params, cfg, x, enc_a):
        enc_x, _, ambient = trunk(params, cfg, x, enc_a)
        a0 = jax.lax.stop_gradient(ambient)
        ambient = ambient + nudge["s"] * (jnp.nextafter(a0, jnp.full_like(a0, jnp.inf)) - a0)
        enc_w = jnet._encode(ambient, params["encoder_ambient"], cfg.ambient_spec, 1.0,
                             table_dtype=cfg.table_dtype, packed=params.get("_packed_ambient"))
        return enc_x, enc_w, ambient

    monkeypatch.setattr(jnet, "_spatial_and_ambient", nudged)
    return nudge


@pytest.mark.parametrize("stage", ["frame", "train_step"])
def test_variant_slice_matches_jax(stage, monkeypatch):
    """The slice's configuration end to end on the CPU: bound 2 (cascade 2),
    max_steps 128 (dt_min < dt_max: the general orbit, K = 257, S = 128),
    grids of 8 levels of 4 channels (3-D and 2-D). "frame": a 48x48 head
    frame against JAX render_rays at exhaustive capacities, PSNR >= 60 dB
    and the same telemetry; "train_step": one head-stage step on 512 of its
    rays with the same noises, loss to rel 1e-5, the same telemetry and
    every parameter's gradient within 1e-4 of its largest (+1e-7) plus twice
    JAX's own move under a one-ulp nudge of the ambient coordinates. JAX
    runs under jit: the identical telemetry shows that no contracted FMA
    moved a sample.

    Why the nudge: at the 2-D grid's finest level (scale 2047) one ulp of an
    ambient coordinate moves a cell fraction by ~3e-5, and the ambient MLP
    that makes the coordinates rounds its sums in another order than XLA's
    (1767 of the 1787 samples differ by an ulp; the sample positions are
    bit for bit). The gradients upstream of the ambient grid's x gradient
    (the ambient and audio MLPs, the 3-D table through the ambient MLP's
    input) then differ from JAX's by 1.1e-4 to 1.15e-3 of their largest, and
    JAX's own move under the nudge is 0.96-1.04x of that; every other leaf
    stays within 1.2e-5. The nudge moves no leaf by more than 0.5% of its
    largest gradient."""
    from radnerf_tpu.data.rays import get_bg_coords
    from radnerf_tpu.models import RenderConfig as JRenderConfig
    from radnerf_tpu.models import render_rays as j_render_rays
    from radnerf_tpu.train.losses import head_loss as j_head_loss

    from radnerf_tpu_torch.convert import _state_dict_from_jax, network_from_jax
    from radnerf_tpu_torch.models import NetworkConfig, RenderConfig, render_rays
    from radnerf_tpu_torch.train import head_loss

    training = stage == "train_step"
    net_kw = VARIANT_NET
    cfg_j, params, grid, rays = _variant_scene(net_kw)
    cull = 1e-6
    rc_j = JRenderConfig(bound=2.0, grid_size=VARIANT_GRID, max_steps=128, exp_eye=True,
                         sample_capacity_mult=128.0, ray_capacity_frac=1.0, cull_T=cull)
    rc = RenderConfig(bound=2.0, grid_size=VARIANT_GRID, max_steps=128, cull_T=cull)
    mcfg = rc.march_config()
    assert rc.cascade == 2 and not mcfg.affine
    assert (mcfg.n_march_iters, mcfg.n_sample_slots) == (257, 128)
    state_j, state = _variant_states(rc_j, rc, grid)
    rng = np.random.default_rng(14)
    inds = rng.choice(48 * 48, 512, replace=False) if training else np.arange(48 * 48)
    n = len(inds)
    f = dict(rays_o=rays["rays_o"][inds], rays_d=rays["rays_d"][inds],
             bg_coords=np.asarray(get_bg_coords(48, 48))[inds],
             pose6=np.zeros((1, 6), np.float32),
             auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
             bg_color=rng.random((n, 3)).astype(np.float32),
             eye=np.array([[0.25]], np.float32),
             images=rng.random((n, 3)).astype(np.float32),
             noises=rng.random(n).astype(np.float32))
    face_mask = rng.random(n) < 0.5
    index, step, iters = 3, 40, 100
    tel = ("n_hit", "n_samples_needed", "n_max_count", "n_k_span")
    a = {k: jnp.asarray(v) for k, v in f.items()}

    def render_j(p):
        return j_render_rays(p, cfg_j, rc_j, state_j, a["rays_o"], a["rays_d"], a["auds"],
                             a["bg_coords"], a["pose6"], a["eye"],
                             jnp.asarray(index, jnp.int32), a["bg_color"],
                             noises=a["noises"] if training else None, training=training)[0]

    net = network_from_jax(params, NetworkConfig(**net_kw), device="cpu")
    t = {k: _T(v) for k, v in f.items()}
    res, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"], t["bg_coords"],
                         t["pose6"], t["eye"], index, t["bg_color"],
                         noises=t["noises"] if training else None, training=training)
    assert int(res["n_samples_needed"]) > (1000 if training else 5000)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    if not training:
        want = jax.jit(render_j)(jparams)
        for k in tel:
            assert int(res[k]) == int(want[k]), k
        img = res["image"].detach().numpy().astype(np.float64)
        mse = float(np.mean((img - np.asarray(want["image"], np.float64)) ** 2))
        assert float(res["weights_sum"].max()) > 0.05
        assert 10.0 * np.log10(1.0 / max(mse, 1e-20)) >= 60.0
        return

    nudge = _nudged_ambient(monkeypatch)

    def loss_fn(p, s):
        nudge["s"] = s
        r = render_j(p)
        loss = j_head_loss(r, a["images"], jnp.asarray(face_mask),
                           jnp.asarray(step, jnp.float32), iters, 0.1)
        return loss, {k: r[k] for k in tel}

    step_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss_j, tel_j), grads_j = step_j(jparams, jnp.float32(0.0))
    moved = [_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, step_j(jparams, s)[1]))
             for s in (jnp.float32(1.0), jnp.float32(-1.0))]
    loss = head_loss(res, t["images"], _T(face_mask), step, iters, 0.1)
    loss.backward()
    for k in tel:
        assert int(res[k]) == int(tel_j[k]), k
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    want = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(net.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        largest = float(np.abs(w).max())
        spread = max(float(np.abs(m[name] - w).max()) for m in moved)
        assert spread <= 5e-3 * largest, f"{name}: the nudge moves it {spread} of {largest}"
        tol = 1e-4 * largest + 1e-7 + 2.0 * spread
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"{name}: max |g - g_jax| {err} > {tol}"
    assert float(np.abs(want["encoder"]).max()) > 0
