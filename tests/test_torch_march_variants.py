"""The bitfield march and the two-level march of the port against the JAX
package's, on the CPU: the same numpy inputs go through both.

On CPU tensors the kernel wrappers run their plain twins (kernels
B-bitfield and B-grouped run on the card only; tests/test_torch_kernels.py
holds them to the twins there). JAX's marches run under ``jit`` (op by op
they take 6-17 s each to dispatch): there XLA:CPU contracts ``t0 + k * dt``
into an FMA, which moves t and xyz by an ulp (up to 2.9e-6 at t ~ 20, hence
the stated tolerances) and could move a sample across a cell; on these
scenes the sample sets are identical. The scenes copy the JAX package's
own marcher tests (tests/test_ops.py). Also: the occupancy lookup and the coarse bytes
exactly, the renderer's choice of march, and the coarse bytes kept in step
with the sigma bytes wherever the state sets them.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_march_variants.py -q
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import RendererState as JRendererState
from radnerf_tpu.ops import marching as jmarch
from radnerf_tpu.ops import morton as jmorton
from radnerf_tpu.ops.ray_aabb import near_far_from_aabb as j_near_far

from radnerf_tpu_torch import ops as T
from radnerf_tpu_torch.config import Options
from radnerf_tpu_torch.convert import state_from_numpy
from radnerf_tpu_torch.models import (
    NeRFNetwork,
    NetworkConfig,
    RenderConfig,
    make_state,
    mark_untrained_grid,
    render_rays,
    update_density_grid,
)
from radnerf_tpu_torch.train import Trainer

H = 32
AABB1 = (-1.0, -0.5, -1.0, 1.0, 0.5, 1.0)


def _T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _coords(H):
    return _np(jmorton.morton3d_invert(jnp.arange(H**3, dtype=jnp.int32)))


def _rays(rng, N, z, xy, dxy):
    """N rays from z towards +z, origins U(-xy, xy), directions tilted by
    U(-dxy, dxy) (normalised)."""
    o = np.zeros((N, 3), np.float32)
    o[:, 2] = z
    o[:, :2] = rng.uniform(-xy, xy, (N, 2))
    d = np.zeros((N, 3), np.float32)
    d[:, 2] = 1.0
    d[:, :2] = rng.uniform(-dxy, dxy, (N, 2))
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _near_far(o, d, aabb):
    return (_np(v) for v in j_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb),
                                       0.05))


def _blob_bytes(H, cascade, rng):
    """Sigma bytes (numpy uint8) of a blob of codes that vary with radius
    and a few scattered occupied cells, per level: the coarse bytes'
    dilation, erosion and mixed codes all show."""
    grids = []
    for _ in range(cascade):
        xyz = 2.0 * _coords(H).astype(np.float32) / (H - 1) - 1.0
        r = np.linalg.norm(xyz - rng.uniform(-0.1, 0.1, 3).astype(np.float32), axis=-1)
        dens = np.where(r < 0.9, 2000.0 * (1.0 - r) ** 2, 0.0)
        dens[rng.random(H**3) < 0.0005] = 50.0
        grids.append(dens.astype(np.float32))
    return _np(jmarch.build_sigma_bytes(jnp.asarray(np.stack(grids)), 5.0))


# ------------------------------------------------- lookup and coarse bytes
@pytest.mark.parametrize("cascade", [1, 2])
def test_occupancy_lookup_matches_jax(cascade):
    """occupancy_lookup against JAX occupancy_lookup and
    occupancy_lookup_wide (on JAX's row view) at points in and out of the
    box with steps that move the mip level: equal."""
    rng = np.random.default_rng(20 + cascade)
    bound = float(cascade)
    cfg_j = jmarch.MarchConfig(bound=bound, cascade=cascade, grid_size=H)
    cfg_t = T.MarchConfig(bound=bound, cascade=cascade, grid_size=H)
    bits = (rng.random(cascade * H**3 // 8) * 256).astype(np.uint8)
    x = rng.uniform(-1.1 * bound, 1.1 * bound, (4096, 3)).astype(np.float32)
    x = np.clip(x, -bound, bound)
    dt = rng.uniform(1e-3, 0.3, 4096).astype(np.float32)
    got = T.occupancy_lookup(_T(x), _T(dt), _T(bits), cfg_t).numpy()
    for fn, table in ((jmarch.occupancy_lookup, bits),
                      (jmarch.occupancy_lookup_wide, jmarch.pack_bitfield_rows(bits))):
        np.testing.assert_array_equal(got, _np(jax.jit(lambda *a: fn(*a, cfg_j))(
            jnp.asarray(x), jnp.asarray(dt), jnp.asarray(table))))
    assert 0.3 < got.mean() < 0.7


@pytest.mark.parametrize("cascade", [1, 2])
def test_coarse_bytes_match_jax(cascade):
    """build_coarse_bytes against JAX build_coarse_rows viewed as bytes:
    byte for byte, with occupied, empty and eroded codes of every kind."""
    sb = _blob_bytes(H, cascade, np.random.default_rng(30 + cascade))
    want = _np(jax.jit(lambda b: jmarch.build_coarse_rows(b, cascade, H, 4))(
        jnp.asarray(sb))).reshape(-1)
    got = T.build_coarse_bytes(_T(sb), cascade, H).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (cascade * (H // 4) ** 3,)
    assert (got == 0).any() and (got == 128).any() and (got > 128).any()


# ---------------------------------------------------------- bitfield march
# name -> (cascade, bound, max_steps, dt_gamma, occupied fraction, noise,
# float-grid cull, edge): tests/test_ops.py:274 at both dt_gamma, :315 (the
# perturbation), :482 (cascade 3 at bound 4) at both dt_gamma; the
# float-grid cull at 1e-6 on a dense grid, on the affine orbit and on the
# general one at cascade 2. The edges (_bitfield_edge), each with every cell
# occupied in the bitfield and the cull at 1e-4: a constant grid whose
# cull crosses at slot 1 (slot 0's estimate alone exceeds -ln(cull_T)), at
# slot 8 and at slot S - 1; negative and NaN grid values; S = 128 with count
# > S on the general orbit at cascade 2; a grid value of 1e12 after the
# crossing, which brings its slot back under the limit (fl(fl(s + a) - a)
# = 0); a NaN near
BITFIELD_CASES = {
    "affine": (1, 1.0, 16, 0.0, 0.08, False, False, None),
    "general": (1, 1.0, 16, 1 / 256, 0.08, False, False, None),
    "noise": (1, 1.0, 16, 0.0, 0.2, True, False, None),
    "cascade3-affine": (3, 4.0, 32, 0.0, 0.1, False, False, None),
    "cascade3-general": (3, 4.0, 32, 1 / 256, 0.1, False, False, None),
    "gridcull": (1, 1.0, 16, 0.0, 0.5, True, True, None),
    "gridcull-cascade2-general": (2, 2.0, 64, 1 / 64, 0.5, True, True, None),
    "gridcull-cross-slot1": (1, 1.0, 16, 0.0, 1.0, False, True, 1),
    "gridcull-cross-slot8": (1, 1.0, 16, 0.0, 1.0, True, True, 8),
    "gridcull-cross-last-slot": (1, 1.0, 16, 0.0, 1.0, False, True, 15),
    "gridcull-negative-nan": (1, 1.0, 16, 0.0, 1.0, False, True, "negative-nan"),
    "gridcull-s128-count-over-S": (2, 2.0, 128, 1 / 256, 1.0, True, True, 64),
    "gridcull-huge-after-crossing": (1, 1.0, 16, 0.0, 1.0, False, True, "huge"),
    "gridcull-nan-near": (1, 1.0, 16, 0.0, 1.0, True, True, "nan-near"),
}


def _bitfield_edge(edge, cfg, rng):
    """(float grid, nan_near) of an edge case of BITFIELD_CASES; the
    bitfield occupies every cell. An int edge s: the grid that puts the
    cull's crossing at slot s, c = 4 L / (dt (s - 0.5)) with dt the orbit's
    least step (every step's estimate c * 0.25 * dt >= L / (s - 0.5)
    before the clamp's larger steps), U(0.9, 1.1) c at cascade > 1."""
    n = cfg.cascade * H**3
    L = np.float32(-np.log(1e-4))
    dt = np.float32(cfg.dt_min)
    if isinstance(edge, int):
        c = 4.0 * L / (dt * (edge - 0.5))
        grid = np.full(n, c) if cfg.cascade == 1 else c * rng.uniform(0.9, 1.1, n)
        return grid.astype(np.float32), False
    grid = np.full(n, 4.0 * L / (dt * 5.5), np.float32)  # crossing at slot 6
    if edge == "negative-nan":
        grid[rng.random(n) < 0.3] = -1.0
        grid[rng.random(n) < 0.01] = np.nan
    elif edge == "huge":
        z = _coords(H)[:, 2]
        grid[(z >= 20) & (z <= 21)] = 1e12  # a slab after the crossing
    return grid, edge == "nan-near"


@pytest.mark.parametrize("case", list(BITFIELD_CASES))
def test_bitfield_march_matches_jax(case):
    """The bitfield march (no sigma bytes, t_window None) against JAX
    march_rays without sigma_rows: valid identical, t, dt and xyz within
    1e-5 where valid, the same max_count; with the float-grid cull (the
    density grid, cells of -1 among them) it drops samples JAX drops."""
    cascade, bound, max_steps, dt_gamma, frac, noise, grid_cull, edge = BITFIELD_CASES[case]
    rng = np.random.default_rng(len(case))
    kw = dict(bound=bound, cascade=cascade, grid_size=H, max_steps=max_steps,
              dt_gamma=dt_gamma)
    nan_near = False
    if edge is None:
        dens = np.where(rng.random(cascade * H**3) < frac,
                        rng.uniform(0.0, 3000.0, cascade * H**3), 0.0)
        dens[rng.random(dens.shape) < 0.05] = -1.0  # untrained cells clip to 0
        dens = dens.astype(np.float32)
        bits = _np(jmorton.packbits(jnp.asarray(dens), 5.0))
        cull_T = 1e-6 if grid_cull else 0.0
    else:
        dens, nan_near = _bitfield_edge(edge, T.MarchConfig(**kw), rng)
        bits = np.full(cascade * H**3 // 8, 255, np.uint8)
        cull_T = 1e-4
    o, d = _rays(rng, 32, -4.0 * bound, 0.3 * bound, 0.15)
    b = np.float32(bound)
    nears, fars = _near_far(o, d, [-b, -b / 2, -b, b, b / 2, b])
    if nan_near:
        nears = nears.copy()
        nears[::5] = np.nan
    noises = rng.random(32).astype(np.float32) if noise else None
    want = jax.jit(lambda *a: jmarch.march_rays(
        *a[:5], jmarch.MarchConfig(**kw), noises=a[5], sigma_grid=a[6], cull_T=cull_T))(
        *(jnp.asarray(v) for v in (o, d, nears, fars, bits)),
        None if noises is None else jnp.asarray(noises),
        jnp.asarray(dens) if grid_cull else None)
    got = T.march_rays(_T(o), _T(d), _T(nears), _T(fars), None, T.MarchConfig(**kw),
                       cull_T=cull_T, noises=None if noises is None else _T(noises),
                       bitfield=_T(bits), sigma_grid=_T(dens) if grid_cull else None)
    valid = _np(want["valid"])
    assert valid.sum() > 20
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k in ("t", "dt", "xyz"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-5, rtol=0)
    assert int(got["count"].max()) == int(want["max_count"])
    S = valid.shape[1]
    selected = int(got["count"].clamp(max=S).sum())
    assert (valid.sum() < selected) == grid_cull  # the cull drops samples
    if isinstance(edge, int):  # every ray that fills its slots crosses at slot `edge`
        full = got["count"].numpy() >= S  # (at cascade 2, within its larger steps' reach)
        n_kept = valid[full].sum(axis=1)
        assert full.sum() > 5 and (n_kept <= edge).all() and (n_kept >= edge * 0.9).all()
        assert cascade == 1 or int(got["count"].max()) > S
    elif edge == "huge":  # a slot after the crossing is kept again
        assert (np.diff(valid.astype(np.int8), axis=1) > 0).any()
    elif edge == "nan-near":
        assert not valid[::5].any() and not got["count"].numpy()[::5].any()


# --------------------------------------------------------- two-level march
def _grouped_scene(name):
    """(sigma bytes, rays, noises, MarchConfig kwargs, group_slots, cull_T)
    of tests/test_ops.py's three grouped-march scenes: the blob with
    scattered cells (:531), the sphere whose groups overflow (:602; here
    group_slots 2 of 9 without the cull, below the groups its rays keep),
    the full field at K = 10 (:661); and the K = 96 scene (24 groups, 3
    coarse chunks) with every kept group marched, group_slots 0, 1 and 11
    (a truncation inside the second chunk), and training noises with one
    near in 5 NaN."""
    coords = _coords(H)
    xyz = 2.0 * coords.astype(np.float32) / (H - 1) - 1.0
    cfg = dict(bound=1.0, cascade=1, grid_size=H, max_steps=8, dt_gamma=0.0)
    if name.startswith("blob"):
        rng = np.random.default_rng(3)
        r = np.linalg.norm(xyz - np.array([0.1, 0.0, -0.1], np.float32), axis=-1)
        dens = np.where(r < 0.45, 250.0, 0.0).astype(np.float32)
        dens[rng.random(H**3) < 0.01] = 30.0
        o, d = _rays(rng, 96, -3.0, 0.9, 0.15)
        noises = rng.random(96, dtype=np.float32)
        slots, cull_T, aabb = None, (1e-6 if name == "blob-cull" else 0.0), AABB1
    elif name == "sphere-slots2":
        rng = np.random.default_rng(9)
        dens = np.where(np.linalg.norm(xyz, axis=-1) < 0.5, 150.0, 0.0).astype(np.float32)
        o, d = _rays(rng, 64, -3.0, 0.5, 0.0)
        noises, slots, cull_T, aabb = None, 2, 0.0, AABB1
    elif name.startswith("k96"):
        # K = 96: 24 groups over 3 coarse chunks of 8. The box of bound 4
        # (cascade 1: points outside [-1, 1] clamp to the grid's faces)
        # gives windows of up to 128 steps of 0.108; 20% of cells occupied
        # with mixed codes, so the dilated coarse bits keep most groups
        rng = np.random.default_rng(13)
        dens = np.where(rng.random(H**3) < 0.2, rng.uniform(6.0, 400.0, H**3), 0.0)
        dens = dens.astype(np.float32)
        o, d = _rays(rng, 48, -12.0, 2.5, 0.3)
        cfg.update(bound=4.0, march_iters=96)
        noises = rng.random(48, dtype=np.float32) if name == "k96-noises-nan-near" else None
        slots = {"k96-slots0": 0, "k96-slots1": 1, "k96-slots11": 11}.get(name)
        cull_T, aabb = 1e-4, (-4.0, -4.0, -4.0, 4.0, 4.0, 4.0)
    else:  # "full-K10"
        rng = np.random.default_rng(11)
        dens = np.full((H**3,), 80.0, np.float32)
        o, d = _rays(rng, 48, -3.0, 0.3, 0.0)
        cfg.update(max_steps=16, march_iters=10)
        noises, slots, cull_T, aabb = None, None, 0.0, (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    sb = _np(jmarch.build_sigma_bytes(jnp.asarray(dens), 5.0))
    nears, fars = _near_far(o, d, aabb)
    if name == "k96-noises-nan-near":
        nears = nears.copy()
        nears[::5] = np.nan
    return sb, o, d, (nears, fars), noises, cfg, slots, cull_T


def _exact_exp2(x):
    """jnp.exp2 with integer arguments in [0, 32) exact. XLA:CPU's exp2 is
    not (2^13 + 2^-8, ..., 2^23 - 3.5 at the odd exponents from 13), so on
    the CPU JAX's group-id bitmask sum(m * exp2(j)), exact for Kg <= 24 as
    its docstring says, misdecodes the groups of a ray that keeps group 13
    or a later odd one."""
    x = jnp.asarray(x)
    whole = (x == jnp.round(x)) & (x >= 0) & (x < 32)
    exact = jnp.ldexp(jnp.ones_like(x), jnp.where(whole, x, 0).astype(jnp.int32))
    return jnp.where(whole, exact, _JNP_EXP2(x))


_JNP_EXP2 = jnp.exp2


@pytest.mark.parametrize("name", ["blob", "blob-cull", "sphere-slots2", "full-K10", "k96",
                                  "k96-slots0", "k96-slots1", "k96-slots11",
                                  "k96-noises-nan-near"])
def test_grouped_march_matches_jax(name, monkeypatch):
    """The two-level march against JAX march_rays_grouped at ample group
    capacity: valid identical, t and xyz within 1e-6, max_count,
    n_groups_needed and n_group_max equal; with every kept group marched,
    bit for bit with the port's dense march (K truncation included); with
    group_slots below the groups a ray keeps, a prefix of each ray's dense
    samples. The K = 96 scenes' rays keep up to 24 groups: their JAX
    reference runs with exp2 exact at integers (_exact_exp2)."""
    sb, o, d, (nears, fars), noises, kw, slots, cull_T = _grouped_scene(name)
    if name.startswith("k96"):
        monkeypatch.setattr(jnp, "exp2", _exact_exp2)
    cfg_j, cfg_t = jmarch.MarchConfig(**kw), T.MarchConfig(**kw)
    K = cfg_t.n_march_iters
    Kg = -(-K // 4)
    assert K == cfg_j.n_march_iters and (K == 10) == (name == "full-K10")
    assert (Kg == 24) == name.startswith("k96")
    want = jax.jit(lambda o, d, n, f, sb, nz: jmarch.march_rays_grouped(
        o, d, n, f, cfg_j, jmarch.pack_sigma_byte_rows(sb),
        jmarch.build_coarse_rows(sb, 1, H, 4), (n, f), 4,
        group_capacity=max(128, -(-len(o) * Kg // 128) * 128),
        group_slots=Kg if slots is None else slots, noises=nz, cull_T=cull_T))(
        *(jnp.asarray(v) for v in (o, d, nears, fars, sb)),
        None if noises is None else jnp.asarray(noises))
    t = [_T(v) for v in (o, d, nears, fars)]
    args = (*t[:2], t[2], t[3], _T(sb), T.build_coarse_bytes(_T(sb), 1, H), cfg_t,
            (t[2], t[3]), slots, cull_T, None if noises is None else _T(noises))
    got = T.march_rays_grouped(*args)
    valid = _np(want["valid"])
    # one marched group a ray at group_slots 1, none at 0
    assert valid.sum() > {0: -1, 1: 10}.get(slots, 30) and (slots != 0 or valid.sum() == 0)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k in ("t", "xyz"):
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-6, rtol=1e-6)
    assert int(got["count"].max()) == int(want["max_count"])
    assert int(got["groups"].sum()) == int(want["n_groups_needed"]) > 0
    assert int(got["groups"].max()) == int(want["n_group_max"])
    dense = T.march_rays(*t, _T(sb), cfg_t, (t[2], t[3]), cull_T,
                         None if noises is None else _T(noises))
    if slots is None:
        for k in ("t", "dt", "valid", "xyz", "count"):
            assert torch.equal(got[k], dense[k]), k
    else:  # the truncation bites: fewer samples, every one of them dense's
        assert int((got["groups"] > slots).sum()) > 10
        kept = got["valid"]
        assert bool((kept <= dense["valid"]).all()) and torch.equal(got["t"][kept],
                                                                  dense["t"][kept])
        assert int(kept.sum()) < int(dense["valid"].sum())


def test_grouped_march_refuses_what_jax_asserts():
    """ValueError at cascade 2, on the general orbit and at more than 24
    groups, where JAX's march_rays_grouped asserts."""
    o = torch.zeros(4, 3)
    z = torch.zeros(4)
    sb = torch.zeros(H**3, dtype=torch.uint8)
    cb = T.build_coarse_bytes(sb, 1, H)
    for kw in (dict(bound=2.0, cascade=2, max_steps=8, dt_gamma=0.0),
               dict(max_steps=64, dt_gamma=1 / 64),
               dict(max_steps=8, dt_gamma=0.0, march_iters=97)):
        cfg = T.MarchConfig(grid_size=H, **kw)
        assert not T.grouped_march_qualifies(cfg)
        with pytest.raises(ValueError):
            T.march_rays_grouped(o, o, z, z, sb, cb, cfg, (z, z))
    assert T.grouped_march_qualifies(T.MarchConfig(grid_size=H, max_steps=8, dt_gamma=0.0,
                                                   march_iters=96))


# -------------------------------------------------- the renderer's choice
NET = dict(exp_eye=True, ind_num=2, grid_levels=4, hidden_dim=32, geo_feat_dim=15,
           hidden_dim_color=32, hidden_dim_ambient=32)


def _small_net(bound):
    return NeRFNetwork(NetworkConfig(**NET, bound=bound), device="cpu",
                       generator=torch.Generator().manual_seed(0))


def _frame(net, rc, state, rng, n=256):
    o, d = _rays(rng, n, -2.5 * rc.bound, 0.3 * rc.bound, 0.2)
    return render_rays(net, rc, state, _T(o), _T(d), None, torch.zeros(n, 2),
                       torch.zeros(1, 6), torch.full((1, 1), 0.25), 0,
                       torch.full((n, 3), 0.5))[0]


@pytest.mark.parametrize("why", ["cascade2", "general", "groups33"])
def test_render_marches_densely_where_grouped_does_not_qualify(why):
    """With march_group set on a config the two-level march does not take
    (cascade 2, the general orbit, ceil(K / 4) = 33 at the defaults),
    render_rays marches densely: the frame of march_group off bit for bit,
    and zero group telemetry."""
    kw = {"cascade2": dict(bound=2.0, grid_size=H, max_steps=8, dt_gamma=0.0),
          "general": dict(grid_size=H, max_steps=64, dt_gamma=1 / 64),
          "groups33": dict(grid_size=128, max_steps=16, dt_gamma=0.0)}[why]
    rc = RenderConfig(**kw)
    assert not T.grouped_march_qualifies(rc.march_config())
    net = _small_net(rc.bound)
    G = rc.grid_size
    coords = T.morton3d_invert(torch.arange(G**3)).float()
    blob = (torch.linalg.norm(2.0 * (coords + 0.5) / G - 1.0, dim=-1) < 0.5).float() * 20.0
    state = make_state(rc, blob[None].repeat(rc.cascade, 1), torch.zeros(G * G), 1.0, 0.0,
                       audio_dim=net.cfg.audio_dim)
    dense = _frame(net, rc, state, np.random.default_rng(1))
    grouped = _frame(net, dataclasses.replace(rc, march_group=True), state,
                     np.random.default_rng(1))
    assert int(dense["n_samples_needed"]) > 100
    for k in ("image", "depth", "weights_sum"):
        assert torch.equal(grouped[k], dense[k]), k
    assert int(grouped["n_groups_needed"]) == int(grouped["n_group_max"]) == 0


# ---------------------------------------------------- the state invariant
def _coarse_in_step(state):
    cas, ncells = state.density_grid.shape
    G = round(ncells ** (1 / 3))
    return torch.equal(state.coarse_bytes, T.build_coarse_bytes(state.sigma_bytes, cas, G))


def test_coarse_bytes_follow_the_sigma_bytes(tmp_path):
    """After make_state, update_density_grid, mark_untrained_grid, a
    checkpoint round trip and convert.state_from_numpy the state's coarse
    bytes are build_coarse_bytes of its sigma bytes (the converted state's
    also JAX's coarse_rows); the checkpoint restores march_group_slots."""
    rc = RenderConfig(grid_size=H, max_steps=8, dt_gamma=0.0, march_group=True,
                      march_group_slots=3)
    rng = np.random.default_rng(5)
    xyz = 2.0 * _coords(H).astype(np.float32) / (H - 1) - 1.0
    # a blob wide enough for eroded codes, which the upkeep's decay moves
    grid = np.where(np.linalg.norm(xyz, axis=-1) < 0.85, 20.0, 0.0).astype(np.float32)[None]
    torso = rng.uniform(0.0, 0.2, H * H).astype(np.float32)

    state = state_from_numpy(rc, grid, torso, 1.0, 0.05, thresh=1.0, device="cpu")
    assert _coarse_in_step(state) and int((state.coarse_bytes > 128).sum()) >= 8
    rc_j = JRenderConfig(grid_size=H, max_steps=8, dt_gamma=0.0)
    state_j = JRendererState.create(rc_j).replace(density_grid=jnp.asarray(grid)) \
        .with_sigma_bytes(jmarch.build_sigma_bytes(jnp.asarray(grid), 1.0))
    np.testing.assert_array_equal(state.coarse_bytes.numpy(),
                                  _np(state_j.coarse_rows).reshape(-1))

    tr = Trainer(Options(exp_eye=True), NetworkConfig(**NET), rc, device="cpu",
                 workspace=str(tmp_path))
    state = make_state(rc, _T(grid), _T(torso), 1.0, 0.05, audio_dim=tr.net.cfg.audio_dim)
    assert _coarse_in_step(state)
    before = state.coarse_bytes.clone()
    gen = torch.Generator().manual_seed(0)
    state = update_density_grid(tr.net, rc, state, None, torch.full((1, 1), 0.25), gen)
    assert _coarse_in_step(state) and not torch.equal(state.coarse_bytes, before)
    pose = torch.eye(4)
    pose[2, 3] = 3.0
    pose[:3, :3] = torch.diag(torch.tensor([1.0, -1.0, -1.0]))
    state = mark_untrained_grid(rc, state, pose[None], (40.0, 40.0, 16.0, 16.0))
    assert _coarse_in_step(state) and bool((state.density_grid == -1).any())

    tr.state = state
    tr.save_checkpoint("ckpt")
    fresh = Trainer(Options(exp_eye=True), NetworkConfig(**NET),
                    dataclasses.replace(rc, march_group_slots=None), device="cpu",
                    workspace=str(tmp_path / "fresh"))
    assert _coarse_in_step(fresh.state)  # the empty state's zeros
    fresh.load_checkpoint(str(tmp_path / "checkpoints" / "ckpt.npz"))
    assert fresh.render_cfg.march_group_slots == 3
    assert _coarse_in_step(fresh.state)
    assert torch.equal(fresh.state.coarse_bytes, state.coarse_bytes)
