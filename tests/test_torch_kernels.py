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
another order, and A''s table gradient, where one row may sum tens of
thousands of terms, to max(1e-5, 4 sqrt(n_busiest) 2^-24). Kernel A is held
bit for bit, and so is its bf16 variant A-bf16 (the same float32 products,
rounded to bf16 at the same places); A'-bf16 is held as A'.
"""

import math

import numpy as np
import pytest
import torch

from radnerf_tpu_torch import ops as T
from radnerf_tpu_torch.ops import _kernels
from radnerf_tpu_torch.ops.marching import MAX_SLOTS

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    _kernels.build_all()
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _grid_points(layout, n, input_dim, rng):
    """Points in [-1, 1]^D laid out as the grid encoders meet them:
    "spread" uniform over the box and a little past it; "ray" runs of 16
    samples 0.02 apart along straight rays, the march's order; "collapsed"
    every point within 1e-4 of one spot, the untrained ambient MLP's output."""
    if layout == "spread":
        return rng.uniform(-1.02, 1.02, (n, input_dim)).astype(np.float32)
    if layout == "ray":
        o = rng.uniform(-0.6, 0.6, (n // 16, 1, input_dim))
        d = rng.normal(size=(n // 16, 1, input_dim))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (o + 0.02 * np.arange(16)[:, None] * d).reshape(n, input_dim).astype(np.float32)
    return (rng.uniform(-0.5, 0.5, input_dim)
            + rng.uniform(-1e-4, 1e-4, (n, input_dim))).astype(np.float32)


# the earlier uniform-spread cases keep their ids ("2", "3")
_LAYOUTS = [pytest.param(layout, dim, id=str(dim) if layout == "spread" else f"{layout}-{dim}")
            for layout in ("spread", "ray", "collapsed") for dim in (2, 3)]


@pytest.mark.parametrize("layout,input_dim", _LAYOUTS)
def test_grid_encode_kernel_matches_twin(dev, layout, input_dim):
    spec = T.GridSpec.create(input_dim=input_dim, desired_resolution=2048)
    rng = np.random.default_rng(input_dim)
    emb = _t(rng.uniform(-4, 4, (spec.n_embeddings, 2)).astype(np.float32), dev)
    x = _grid_points(layout, 50_000, input_dim, rng)
    x[:2] = [-1.0] * input_dim, [1.0] * input_dim
    x = _t(x, dev)
    before = _kernels.KERNELS["grid_encode"].launches
    got = T.grid_encode(x, emb, spec)
    assert _kernels.KERNELS["grid_encode"].launches == before + 1
    want = T.grid_encode_plain(x, emb, spec)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) == 0.0  # bit for bit
    assert T.grid_encode(x[:0], emb, spec).shape == (0, 32)


def _march_scene(N, H, rng):
    """A blob of density 30 (radius 0.5) with scattered cells of 300 on a
    grid of H (Morton order) and N rays from z = -3 towards +z through it."""
    coords = T.morton3d_invert(torch.arange(H**3)).numpy()
    xyz = 2.0 * (coords + 0.5) / H - 1.0
    dens = np.where(np.linalg.norm(xyz, axis=-1) < 0.5, 30.0, 0.0).astype(np.float32)
    dens[rng.random(H**3) < 0.02] = 300.0
    o = np.zeros((N, 3), np.float32)
    o[:, 2] = -3.0
    o[:, :2] = rng.uniform(-0.8, 0.8, (N, 2))
    d = np.zeros((N, 3), np.float32)
    d[:, 2] = 1.0
    d[:, :2] = rng.uniform(-0.1, 0.1, (N, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dens, o, d


# S = 16 is the shipped lattice, 13 not a multiple of 4 (rows off 16-byte
# lines); N = 20,003 is not a multiple of any block's ray count
@pytest.mark.parametrize("noises", [False, True], ids=["plain", "noises"])
@pytest.mark.parametrize("slots", [16, 13])
@pytest.mark.parametrize("cull_T", [0.0, 1e-4])
def test_march_kernel_matches_twin(dev, cull_T, slots, noises):
    """Kernel B bit for bit with its twin: valid and count identical on
    every ray, t, dt and xyz equal, unused slots exactly 0; with rays whose
    count exceeds S (without the cull), a tenth of the windows empty
    (t_lo == t_hi) and a tenth inverted (t_lo > t_hi), with and without
    noises."""
    H, N = 64, 20_003
    cfg = T.MarchConfig(grid_size=H, max_steps=16, dt_gamma=0.0, sample_slots=slots)
    rng = np.random.default_rng(5 + slots + 2 * noises)
    dens, o, d = _march_scene(N, H, rng)
    sb = T.build_sigma_bytes(_t(dens, dev), 5.0)
    o, d = _t(o, dev), _t(d, dev)
    aabb = torch.tensor([-1, -0.5, -1, 1, 0.5, 1], dtype=torch.float32, device=dev)
    nears, fars = T.near_far_from_aabb(o, d, aabb, 0.05)
    t_lo, t_hi = nears + 0.3, fars - 0.2
    kind = _t(rng.integers(0, 10, N), dev)
    t_hi = torch.where(kind == 0, t_lo, torch.where(kind == 1, t_lo - 0.5, t_hi))
    args = (o, d, nears, fars, sb, cfg, (t_lo, t_hi), cull_T)
    kw = {"noises": _t(rng.random(N).astype(np.float32), dev)} if noises else {}
    k = _kernels.KERNELS["march_rays"]
    before = k.launches
    got = T.march_rays(*args, **kw)
    assert k.launches == before + 1
    want = T.march_rays_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int(want["valid"].sum()) > 10_000
    if cull_T == 0.0:  # truncated rays (the cull keeps at most 13 points a ray here)
        assert int((want["count"] > slots).sum()) > 1000
    # an inverted window marches nothing, an empty one at most the step at t_lo
    assert int(want["count"][kind == 1].max()) == 0
    assert int(want["count"][kind == 0].max()) <= 1
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["count"], want["count"])
    for key in ("t", "dt", "xyz"):
        assert torch.equal(got[key], want[key]), key
        assert int((got[key].reshape(N, slots, -1)[~got["valid"]] != 0).sum()) == 0
    if noises:
        assert not torch.equal(got["t"], T.march_rays(*args)["t"])


def test_march_kernel_takes_the_widest_lattice(dev):
    """At S = MAX_SLOTS a block's tile needs more than the default 48 KB of
    shared memory (the launch opts in to more): kernel B stays bit for bit
    with its twin."""
    H, N = 64, 1_003
    cfg = T.MarchConfig(grid_size=H, max_steps=MAX_SLOTS, dt_gamma=0.0)
    assert cfg.n_sample_slots == MAX_SLOTS
    dens, o, d = _march_scene(N, H, np.random.default_rng(9))
    sb = T.build_sigma_bytes(_t(dens, dev), 5.0)
    o, d = _t(o, dev), _t(d, dev)
    aabb = torch.tensor([-1, -0.5, -1, 1, 0.5, 1], dtype=torch.float32, device=dev)
    nears, fars = T.near_far_from_aabb(o, d, aabb, 0.05)
    args = (o, d, nears, fars, sb, cfg, (nears, fars), 0.0)
    got, want = T.march_rays(*args), T.march_rays_plain(*args)
    torch.cuda.synchronize()
    assert int(want["count"].max()) > 100
    for key in ("valid", "count", "t", "dt", "xyz"):
        assert torch.equal(got[key], want[key]), key


def test_kernel_wrapper_refuses_bad_inputs(dev):
    spec = T.GridSpec.create(input_dim=3, num_levels=2)
    emb = torch.zeros(spec.n_embeddings, 2, device=dev)
    with pytest.raises(ValueError):
        T.grid_encode(torch.zeros(4, 3, device=dev, dtype=torch.float64), emb, spec)
    with pytest.raises(ValueError):
        T.grid_encode(torch.zeros(4, 3, device=dev), emb.cpu(), spec)
    # what the kernels do not take: 17 channels, 33 levels, 4-D points, the
    # bf16 kernels on a hash grid
    for kw, dtype in ((dict(level_dim=17), None), (dict(num_levels=33), torch.bfloat16),
                      (dict(input_dim=4), None), (dict(gridtype="hash"), torch.bfloat16)):
        s = T.GridSpec.create(**{"num_levels": 2, "base_resolution": 4,
                                 "log2_hashmap_size": 8, **kw})
        with pytest.raises(ValueError):
            T.grid_encode(torch.zeros(4, s.input_dim, device=dev),
                          torch.zeros(s.n_embeddings, s.level_dim, device=dev), s,
                          table_dtype=dtype)
    z = torch.zeros(4, 2, device=dev)
    with pytest.raises(ValueError):  # rgbs [4, 3, 3] do not fit [N, S, 3]
        T.composite_rays(z, torch.zeros(4, 3, 3, device=dev), z, z, z.bool(), z)
    o = torch.zeros(4, 3, device=dev)
    sb = torch.zeros(32**3, dtype=torch.uint8, device=dev)
    mcfg = T.MarchConfig(grid_size=32, dt_gamma=0.0)
    with pytest.raises(ValueError):  # nears of the wrong length
        T.march_rays(o, o, z[:3, 0], z[:, 0], sb, mcfg, (z[:, 0], z[:, 0]))
    with pytest.raises(ValueError):  # more slots than a block's tile holds
        T.march_rays(o, o, z[:, 0], z[:, 0], sb,
                     T.MarchConfig(grid_size=32, dt_gamma=0.0, max_steps=MAX_SLOTS + 1),
                     (z[:, 0], z[:, 0]))
    with pytest.raises(RuntimeError):  # kernel B has no backward
        T.march_rays(o.clone().requires_grad_(True), o, z[:, 0], z[:, 0], sb, mcfg,
                     (z[:, 0], z[:, 0]))
    # kernels C and C' refuse an array that does not start 16-byte aligned
    # (their wrappers copy such a view first)
    buf = torch.zeros(64, device=dev)
    p = buf.data_ptr()
    for name, fn, n_arrays in (("composite_rays", "composite_rays_fwd", 10),
                               ("composite_rays_backward", "composite_rays_bwd", 15)):
        k = _kernels.KERNELS[name]
        before = k.launches
        with pytest.raises(RuntimeError):
            k.launch(fn, dev, p + 4, *[p] * (n_arrays - 1), 1, 4, 1e-4)
        assert k.launches == before


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _busiest_row(x, spec):
    """The most contributions, one per (in-box point, level, corner), that
    any table row takes from these points."""
    from radnerf_tpu_torch.ops.grid_encode import _corner_index

    x01 = (x + 1.0) / 2.0
    x01 = x01[((x01 >= 0) & (x01 <= 1)).all(dim=-1)]
    counts = torch.zeros(spec.n_embeddings, dtype=torch.int64, device=x.device)
    for level in range(spec.num_levels):
        pg = torch.floor(x01 * spec.level_scale(level) + spec.shift).long()
        for corner in range(1 << spec.input_dim):
            bits = torch.tensor([(corner >> d) & 1 for d in range(spec.input_dim)],
                                device=x.device)
            rows = _corner_index(spec, level, pg + bits) + spec.offsets[level]
            counts += torch.bincount(rows, minlength=spec.n_embeddings)
    return int(counts.max())


@pytest.mark.parametrize("layout,input_dim", _LAYOUTS)
def test_grid_encode_backward_kernel_matches_plain(dev, layout, input_dim):
    """A''s table gradient within max(1e-5, 4 sqrt(n_busiest) 2^-24) of the
    largest value (a row summing n float32 terms in two orders differs by
    about sqrt(n) roundings), its x gradient within 1e-5."""
    spec = T.GridSpec.create(input_dim=input_dim, desired_resolution=2048)
    rng = np.random.default_rng(input_dim + 20)
    emb = _t(rng.normal(size=(spec.n_embeddings, 2)).astype(np.float32), dev)
    x = _t(_grid_points(layout, 50_000, input_dim, rng), dev)
    g = _t(rng.normal(size=(50_000, 32)).astype(np.float32), dev)
    table_tol = max(1e-5, 4.0 * math.sqrt(_busiest_row(x, spec)) * 2.0**-24)
    k = _kernels.KERNELS["grid_encode_backward"]
    gt_p, gx_p = T.grid_encode_backward_plain(x, emb, g, spec)
    before = k.launches
    gt_k, gx_k = T.grid_encode_backward(x, emb, g, spec)
    assert k.launches == before + 1
    torch.cuda.synchronize()
    assert _rel_err(gt_k, gt_p) <= table_tol
    assert _rel_err(gx_k, gx_p) <= 1e-5
    outside = ((x < -1.0) | (x > 1.0)).any(dim=-1)
    assert bool((gx_k[outside] == 0).all())
    # the x gradient alone
    none, gx_only = T.grid_encode_backward(x, emb, g, spec, need_table=False)
    assert none is None and _rel_err(gx_only, gx_p) <= 1e-5
    # the autograd path: a grad_fn backed by kernel A', x's gradient on request
    xr, er = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    out = T.grid_encode(xr, er, spec)
    assert out.grad_fn is not None
    before = k.launches
    (out * g).sum().backward()
    assert k.launches == before + 1
    assert _rel_err(er.grad, gt_p) <= table_tol and _rel_err(xr.grad, gx_p) <= 1e-5
    assert T.grid_encode_backward(x, emb, g, spec, need_x=False)[1] is None


# the variant grids: (name, GridSpec arguments); the hash grid is
# get_encoder("hashgrid")'s at a smaller table (2^16 rows)
_VARIANTS = {
    "hash-2-3": dict(input_dim=3, gridtype="hash"),
    "smoothstep-2-2": dict(input_dim=2, interpolation="smoothstep"),
    "align-2-3": dict(input_dim=3, align_corners=True),
    "tiled-1-3": dict(input_dim=3, level_dim=1),
    "tiled-4-2": dict(input_dim=2, level_dim=4),
    "tiled-4-3": dict(input_dim=3, level_dim=4),
    "tiled-8-3": dict(input_dim=3, level_dim=8),
    "all-4-3": dict(input_dim=3, level_dim=4, gridtype="hash", interpolation="smoothstep",
                    align_corners=True),
    # the channel counts the kernels take at run time
    "tiled-3-3": dict(input_dim=3, level_dim=3),
    "tiled-3-2": dict(input_dim=2, level_dim=3),
    "tiled-16-3": dict(input_dim=3, level_dim=16),
    "all-16-2": dict(input_dim=2, level_dim=16, gridtype="hash", interpolation="smoothstep",
                     align_corners=True),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_grid_variant_kernels_match_plain(dev, variant):
    """A and A' on the variant grids (hash grids, smoothstep,
    align_corners, 1, 4 and 8 channels): A bit for bit with its plain
    version, A''s table gradient within max(1e-5, 4 sqrt(n_busiest) 2^-24)
    of its largest value and its x gradient within 1e-5, on 50,000 spread
    points (a few outside the box) and the autograd path."""
    kw = dict(num_levels=16, level_dim=2, desired_resolution=2048, log2_hashmap_size=16)
    kw.update(_VARIANTS[variant])
    spec = T.GridSpec.create(**kw)
    D, C = spec.input_dim, spec.level_dim
    rng = np.random.default_rng(40 + len(variant))
    emb = _t(rng.normal(size=(spec.n_embeddings, C)).astype(np.float32), dev)
    x = _t(_grid_points("spread", 50_000, D, rng), dev)
    g = _t(rng.normal(size=(50_000, spec.output_dim)).astype(np.float32), dev)
    fwd, bwd = _kernels.KERNELS["grid_encode"], _kernels.KERNELS["grid_encode_backward"]
    before = fwd.launches
    got = T.grid_encode(x, emb, spec)
    assert fwd.launches == before + 1
    want = T.grid_encode_plain(x, emb, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # bit for bit
    gt_p, gx_p = T.grid_encode_backward_plain(x, emb, g, spec)
    table_tol = max(1e-5, 4.0 * math.sqrt(_busiest_row(x, spec)) * 2.0**-24)
    xr, er = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    before = bwd.launches
    (T.grid_encode(xr, er, spec) * g).sum().backward()
    assert bwd.launches == before + 1
    torch.cuda.synchronize()
    assert _rel_err(er.grad, gt_p) <= table_tol
    assert _rel_err(xr.grad, gx_p) <= 1e-5
    outside = ((x < -1.0) | (x > 1.0)).any(dim=-1)
    assert bool((xr.grad[outside] == 0).all()) and bool(outside.any())


@pytest.mark.parametrize("case", ["cascade2-affine", "cascade1-general", "cascade2-general"])
@pytest.mark.parametrize("noises", [False, True], ids=["plain", "noises"])
def test_march_variant_kernel_matches_twin(dev, case, noises):
    """Kernel B off the shipped orbit bit for bit with its twin: the
    mip cascade (bound 2: two levels) on the affine orbit, the general orbit
    (max_steps 256 on grid 64: dt_min < dt_max, dt_gamma 1/64 so the step
    varies) at cascade 1 and 2, with the 1e-4 cull and a window."""
    H, N = 64, 20_003
    bound = 1.0 if case == "cascade1-general" else 2.0
    general = case.endswith("general")
    cfg = T.MarchConfig(bound=bound, cascade=1 + int(bound > 1), grid_size=H,
                        max_steps=256 if general else 32, dt_gamma=1 / 64 if general else 0.0)
    assert cfg.affine != general
    rng = np.random.default_rng(60 + 2 * noises + len(case))
    dens, o, d = _march_scene(N, H, rng)
    dens = np.concatenate([dens, dens[::-1]])[:cfg.cascade * H**3]
    o = o * bound
    sb = T.build_sigma_bytes(_t(dens, dev), 5.0)
    o, d = _t(o, dev), _t(d, dev)
    aabb = torch.tensor([-bound, -bound / 2, -bound, bound, bound / 2, bound],
                        dtype=torch.float32, device=dev)
    nears, fars = T.near_far_from_aabb(o, d, aabb, 0.05)
    args = (o, d, nears, fars, sb, cfg, (nears + 0.3, fars - 0.2), 1e-4)
    kw = {"noises": _t(rng.random(N).astype(np.float32), dev)} if noises else {}
    k = _kernels.KERNELS["march_rays"]
    before = k.launches
    got = T.march_rays(*args, **kw)
    assert k.launches == before + 1
    want = T.march_rays_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int(want["valid"].sum()) > 10_000
    for key in ("valid", "count", "t", "dt", "xyz"):
        assert torch.equal(got[key], want[key]), key
    if general:
        assert len(torch.unique(want["dt"][want["valid"]])) > 1


BITFIELD_CASES = {"cascade1-affine": (1.0, 16, 0.0), "cascade2-affine": (2.0, 32, 0.0),
                  "cascade1-general": (1.0, 256, 1 / 64), "cascade2-general": (2.0, 256, 1 / 64)}


@pytest.mark.parametrize("grid_cull", [False, True], ids=["nocull", "gridcull"])
@pytest.mark.parametrize("case", list(BITFIELD_CASES))
def test_march_bitfield_kernel_matches_twin(dev, case, grid_cull):
    """B-bitfield bit for bit with its twin on both orbits at cascade 1 and
    2, with noises and a window, with and without the float-grid cull
    (1e-4 on a grid of hundreds, so it drops samples): valid, count, t, dt
    and xyz; its own launch count, none of B's."""
    bound, max_steps, dt_gamma = BITFIELD_CASES[case]
    H, N = 64, 20_003
    cfg = T.MarchConfig(bound=bound, cascade=1 + int(bound > 1), grid_size=H,
                        max_steps=max_steps, dt_gamma=dt_gamma)
    rng = np.random.default_rng(70 + len(case) + grid_cull)
    dens, o, d = _march_scene(N, H, rng)
    dens = np.concatenate([dens, dens[::-1]])[:cfg.cascade * H**3] * 10.0
    grid = _t(dens, dev)
    bits = T.packbits(grid, 5.0)
    o, d = _t(o * bound, dev), _t(d, dev)
    aabb = torch.tensor([-bound, -bound / 2, -bound, bound, bound / 2, bound],
                        dtype=torch.float32, device=dev)
    nears, fars = T.near_far_from_aabb(o, d, aabb, 0.05)
    kw = dict(bitfield=bits, sigma_grid=grid if grid_cull else None,
              noises=_t(rng.random(N).astype(np.float32), dev))
    args = (o, d, nears, fars, None, cfg, (nears + 0.3, fars - 0.2), 1e-4)
    k, b = _kernels.KERNELS["march_rays_bitfield"], _kernels.KERNELS["march_rays"]
    before = (k.launches, b.launches)
    got = T.march_rays(*args, **kw)
    assert (k.launches, b.launches) == (before[0] + 1, before[1])
    want = T.march_rays_plain(*args, **kw)
    torch.cuda.synchronize()
    kept = int(want["valid"].sum())
    assert kept > 10_000
    selected = int(torch.clamp(want["count"], max=cfg.n_sample_slots).sum())
    assert (kept < selected) == grid_cull  # the grid cull drops samples
    for key in ("valid", "count", "t", "dt", "xyz"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("slots", [None, 3], ids=["allgroups", "slots3"])
@pytest.mark.parametrize("cull_T", [0.0, 1e-4])
def test_march_grouped_kernel_matches_twin(dev, cull_T, slots):
    """B-grouped bit for bit with its twin (t, dt, valid, xyz, count and the
    kept groups) on grid 64 (K = 65, 17 groups), with noises, a tenth of the
    windows empty and a tenth inverted, with and without the cull, every
    kept group marched and 3 a ray; with every group marched, bit for bit
    with kernel B."""
    H, N = 64, 20_003
    cfg = T.MarchConfig(grid_size=H, max_steps=16, dt_gamma=0.0)
    assert -(-cfg.n_march_iters // 4) == 17
    rng = np.random.default_rng(80 + (slots or 0) + int(cull_T > 0))
    dens, o, d = _march_scene(N, H, rng)
    sb = T.build_sigma_bytes(_t(dens, dev), 5.0)
    cb = T.build_coarse_bytes(sb, 1, H)
    o, d = _t(o, dev), _t(d, dev)
    aabb = torch.tensor([-1, -0.5, -1, 1, 0.5, 1], dtype=torch.float32, device=dev)
    nears, fars = T.near_far_from_aabb(o, d, aabb, 0.05)
    t_lo, t_hi = nears + 0.3, fars - 0.2
    kind = _t(rng.integers(0, 10, N), dev)
    t_hi = torch.where(kind == 0, t_lo, torch.where(kind == 1, t_lo - 0.5, t_hi))
    noises = _t(rng.random(N).astype(np.float32), dev)
    args = (o, d, nears, fars, sb, cb, cfg, (t_lo, t_hi), slots, cull_T, noises)
    k = _kernels.KERNELS["march_rays_grouped"]
    before = k.launches
    got = T.march_rays_grouped(*args)
    assert k.launches == before + 1
    want = T.march_rays_grouped_plain(*args)
    torch.cuda.synchronize()
    assert int(want["valid"].sum()) > 10_000
    if slots is not None:  # the truncation bites
        assert int((want["groups"] > slots).sum()) > 1000
    for key in ("valid", "count", "groups", "t", "dt", "xyz"):
        assert torch.equal(got[key], want[key]), key
    if slots is None:
        dense = T.march_rays(o, d, nears, fars, sb, cfg, (t_lo, t_hi), cull_T, noises)
        for key in ("valid", "count", "t", "dt", "xyz"):
            assert torch.equal(got[key], dense[key]), key


@pytest.mark.parametrize("layout,input_dim", _LAYOUTS)
def test_grid_encode_bf16_kernels_match_plain(dev, layout, input_dim):
    """The bf16 policy's kernels: A-bf16 (the float32 master cast to a bf16
    copy in the wrapper) bit for bit with its plain version, bf16 out, with
    its own launch count; A'-bf16 from a bf16 grad_out to float32
    gradients, the table's within max(1e-5, 4 sqrt(n_busiest) 2^-24) and
    x's within 1e-5 of the plain version's largest value (float32 sums in
    another order); autograd through the encode launches both and gives
    the float32 master a float32 gradient."""
    spec = T.GridSpec.create(input_dim=input_dim, desired_resolution=2048)
    rng = np.random.default_rng(input_dim + 30)
    emb = _t(rng.uniform(-4, 4, (spec.n_embeddings, 2)).astype(np.float32), dev)
    x = _grid_points(layout, 50_000, input_dim, rng)
    x[:2] = [-1.0] * input_dim, [1.0] * input_dim
    x = _t(x, dev)
    g = _t(rng.normal(size=(50_000, 32)).astype(np.float32), dev).to(torch.bfloat16)
    bf16 = torch.bfloat16
    fwd = _kernels.KERNELS["grid_encode_bf16"]
    bwd = _kernels.KERNELS["grid_encode_backward_bf16"]
    before = (fwd.launches, _kernels.KERNELS["grid_encode"].launches)
    got = T.grid_encode(x, emb, spec, table_dtype=bf16)
    assert (fwd.launches, _kernels.KERNELS["grid_encode"].launches) == \
        (before[0] + 1, before[1])
    want = T.grid_encode_plain(x, emb, spec, table_dtype=bf16)
    torch.cuda.synchronize()
    assert got.dtype == bf16 and torch.equal(got, want)
    assert torch.equal(T.grid_encode(x, emb.to(bf16), spec), want)

    table_tol = max(1e-5, 4.0 * math.sqrt(_busiest_row(x, spec)) * 2.0**-24)
    gt_p, gx_p = T.grid_encode_backward_plain(x, emb.to(bf16), g, spec)
    before = bwd.launches
    gt_k, gx_k = T.grid_encode_backward(x, emb.to(bf16), g, spec)
    assert bwd.launches == before + 1
    torch.cuda.synchronize()
    assert gt_k.dtype == gx_k.dtype == torch.float32
    assert _rel_err(gt_k, gt_p) <= table_tol and _rel_err(gx_k, gx_p) <= 1e-5
    xr, er = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    out = T.grid_encode(xr, er, spec, table_dtype=bf16)
    before = bwd.launches
    (out.float() * g.float()).sum().backward()
    assert bwd.launches == before + 1 and er.grad.dtype == torch.float32
    assert _rel_err(er.grad, gt_p) <= table_tol and _rel_err(xr.grad, gx_p) <= 1e-5


# the bf16 policy's grids: (name, GridSpec arguments), tiled grids of 16
# levels to 2048 at 2^16 rows
_BF16_VARIANTS = {
    "tiled-1-3": dict(input_dim=3, level_dim=1),
    "tiled-1-2": dict(input_dim=2, level_dim=1),
    "tiled-4-3": dict(input_dim=3, level_dim=4),
    "tiled-4-2": dict(input_dim=2, level_dim=4),
    "tiled-8-3": dict(input_dim=3, level_dim=8),
    "smoothstep-2-2": dict(input_dim=2, interpolation="smoothstep"),
    "align-2-3": dict(input_dim=3, align_corners=True),
    "tiled-3-3": dict(input_dim=3, level_dim=3),
    "tiled-16-2": dict(input_dim=2, level_dim=16),
    "all-4-3": dict(input_dim=3, level_dim=4, interpolation="smoothstep",
                    align_corners=True),
    "all-3-2": dict(input_dim=2, level_dim=3, interpolation="smoothstep",
                    align_corners=True),
}


@pytest.mark.parametrize("variant", list(_BF16_VARIANTS))
def test_grid_bf16_variant_kernels_match_plain(dev, variant):
    """The bf16 kernels on the -O policy's other grids (1, 3, 4, 8 and 16
    channels, smoothstep, align_corners): the packing pass and A-bf16 bit
    for bit with their plain versions, each with its own launch count;
    A'-bf16's table gradient within max(1e-5, 4 sqrt(n_busiest) 2^-24) and
    its x gradient within 1e-5 of the plain version's largest value, also
    through autograd, on 50,000 spread points (a few outside the box)."""
    kw = dict(num_levels=16, level_dim=2, desired_resolution=2048, log2_hashmap_size=16)
    kw.update(_BF16_VARIANTS[variant])
    spec = T.GridSpec.create(**kw)
    D, C = spec.input_dim, spec.level_dim
    bf16 = torch.bfloat16
    rng = np.random.default_rng(70 + len(variant))
    emb = _t(rng.uniform(-4, 4, (spec.n_embeddings, C)).astype(np.float32), dev)
    tb = emb.to(bf16)
    x = _t(_grid_points("spread", 50_000, D, rng), dev)
    g = _t(rng.normal(size=(50_000, spec.output_dim)).astype(np.float32), dev).to(bf16)
    pack, fwd = _kernels.KERNELS["grid_pack_bf16"], _kernels.KERNELS["grid_encode_bf16"]
    bwd = _kernels.KERNELS["grid_encode_backward_bf16"]
    before = pack.launches
    packed = T.pack_table(tb, spec)
    assert pack.launches == before + 1
    want_packed = T.pack_table_plain(tb, spec)
    torch.cuda.synchronize()
    assert torch.equal(packed.view(torch.int16), want_packed.view(torch.int16))
    before = fwd.launches
    got = T.grid_encode(x, tb, spec, packed=packed)
    assert fwd.launches == before + 1
    want = T.grid_encode_plain(x, tb, spec)
    torch.cuda.synchronize()
    assert got.dtype == bf16 and torch.equal(got.view(torch.int16), want.view(torch.int16))

    table_tol = max(1e-5, 4.0 * math.sqrt(_busiest_row(x, spec)) * 2.0**-24)
    gt_p, gx_p = T.grid_encode_backward_plain(x, tb, g, spec)
    before = bwd.launches
    gt_k, gx_k = T.grid_encode_backward(x, tb, g, spec)
    assert bwd.launches == before + 1
    torch.cuda.synchronize()
    assert _rel_err(gt_k, gt_p) <= table_tol and _rel_err(gx_k, gx_p) <= 1e-5
    outside = ((x < -1.0) | (x > 1.0)).any(dim=-1)
    assert bool((gx_k[outside] == 0).all()) and bool(outside.any())
    xr, er = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    (T.grid_encode(xr, er, spec, table_dtype=bf16).float() * g.float()).sum().backward()
    assert _rel_err(er.grad, gt_p) <= table_tol and _rel_err(xr.grad, gx_p) <= 1e-5


def test_grid_kernels_take_every_channel_count(dev):
    """Every tiled linear grid of 1 to 16 channels at 32 levels runs in
    float32 and under the bf16 policy (each run-time-C unit width among
    them: float4, float2 and float units, and the packing pass's 2-, 4-, 8-
    and 16-byte units): A equal to its plain version, A-bf16 and the
    packing pass bit for bit, A' and A'-bf16 within max(1e-5, 4
    sqrt(n_busiest) 2^-24) (table) and 1e-5 (x) of the largest, on 4,096
    spread points."""
    bf16 = torch.bfloat16
    for C in range(1, 17):
        D = 2 + C % 2
        spec = T.GridSpec.create(input_dim=D, num_levels=32, level_dim=C,
                                 base_resolution=4, per_level_scale=1.1,
                                 log2_hashmap_size=12)
        rng = np.random.default_rng(90 + C)
        emb = _t(rng.uniform(-4, 4, (spec.n_embeddings, C)).astype(np.float32), dev)
        x = _t(_grid_points("spread", 4096, D, rng), dev)
        g = _t(rng.normal(size=(4096, spec.output_dim)).astype(np.float32), dev)
        table_tol = max(1e-5, 4.0 * math.sqrt(_busiest_row(x, spec)) * 2.0**-24)
        for table, go in ((emb, g), (emb.to(bf16), g.to(bf16))):
            got = T.grid_encode(x, table, spec)
            want = T.grid_encode_plain(x, table, spec)
            torch.cuda.synchronize()
            # float32: equal values (outside the box the plain version's
            # 0 * w * e sums may carry the sign of zero, the kernel stores +0)
            assert torch.equal(got, want) if table.dtype == torch.float32 else \
                torch.equal(got.view(torch.int16), want.view(torch.int16)), (C, table.dtype)
            gt_k, gx_k = T.grid_encode_backward(x, table, go, spec)
            gt_p, gx_p = T.grid_encode_backward_plain(x, table, go, spec)
            torch.cuda.synchronize()
            assert _rel_err(gt_k, gt_p) <= table_tol and _rel_err(gx_k, gx_p) <= 1e-5, C
        packed = T.pack_table(emb, spec)
        assert torch.equal(packed.view(torch.int16),
                           T.pack_table_plain(emb, spec).view(torch.int16)), C


@pytest.mark.parametrize("input_dim", [2, 3])
def test_pack_table_kernel_matches_plain(dev, input_dim):
    """A-bf16's packing pass (kernel grid_pack_bf16, its own launch count)
    bit for bit with its plain version, from a bf16 table and from the
    float32 master; a packed copy given to the encode gives the encode's own
    result, with no packing launch."""
    spec = T.GridSpec.create(input_dim=input_dim, desired_resolution=2048)
    rng = np.random.default_rng(input_dim + 40)
    emb = _t(rng.uniform(-4, 4, (spec.n_embeddings, 2)).astype(np.float32), dev)
    pack = _kernels.KERNELS["grid_pack_bf16"]
    before = pack.launches
    got = T.pack_table(emb.to(torch.bfloat16), spec)
    assert pack.launches == before + 1
    want = T.pack_table_plain(emb.cpu(), spec)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    assert torch.equal(T.pack_table(emb, spec), got)
    x = _t(_grid_points("ray", 20_000, input_dim, rng), dev)
    before = pack.launches
    with_copy = T.grid_encode(x, emb.to(torch.bfloat16), spec, packed=got)
    assert pack.launches == before
    assert torch.equal(with_copy, T.grid_encode(x, emb.to(torch.bfloat16), spec))


def test_grid_encode_bf16_subnormal_products_bit_for_bit(dev):
    """A-bf16's bf16x2 corner products round once, as the plain version's
    round_bf16(bf16(w) * e): bit for bit on a table of bf16 subnormals and
    values near the smallest normal, whose products with the weights are
    subnormal, and of ordinary values."""
    bf16 = torch.bfloat16
    for input_dim in (2, 3):
        spec = T.GridSpec.create(input_dim=input_dim, desired_resolution=2048)
        rng = np.random.default_rng(input_dim + 50)
        mant = rng.uniform(1.0, 2.0, (spec.n_embeddings, 2))
        expo = rng.integers(-133, -118, (spec.n_embeddings, 2)).astype(np.float64)
        vals = np.where(rng.random((spec.n_embeddings, 2)) < 0.8,
                        mant * np.exp2(expo), rng.uniform(-4, 4, (spec.n_embeddings, 2)))
        sign = np.where(rng.random((spec.n_embeddings, 2)) < 0.5, -1.0, 1.0)
        tb = _t((sign * vals).astype(np.float32), dev).to(bf16)
        assert bool(((tb.float().abs() < 2.0**-126) & (tb != 0)).any())
        x = _t(_grid_points("spread", 50_000, input_dim, rng), dev)
        got, want = T.grid_encode(x, tb, spec), T.grid_encode_plain(x, tb, spec)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_bf16_render_refuses_reduced_precision_gemm_sums(dev):
    """Under the bf16 policy render_rays refuses cuBLAS's bf16 reduction of
    split-K partials (PyTorch's default), which JAX does not do."""
    from radnerf_tpu_torch.models import NeRFNetwork, NetworkConfig, RenderConfig, \
        RendererState, render_rays

    net = NeRFNetwork(NetworkConfig(compute_dtype="bfloat16", ind_num=4, grid_levels=2),
                      device=dev)
    rc = RenderConfig(grid_size=16)
    st = RendererState.create(rc, device=dev)
    z3, z = torch.zeros(4, 3, device=dev), torch.zeros(4, 2, device=dev)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        with pytest.raises(RuntimeError, match="reduced-precision"):
            render_rays(net, rc, st, z3, z3, None, z, torch.zeros(1, 6, device=dev), None, 0,
                        z3)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def composite_rows(layout, N, S, rng):
    """Composite inputs (sigma, rgb, dt, t, valid, ambient) as numpy (the
    CPU parity of tests/test_torch_ops.py builds its rows here too):
    "dense" rows (85% valid, transmittance crossing T_thresh = 1e-4
    mid-lattice: the training step), "sparse" (at most one valid slot a ray,
    none on half the rays: the frame), "empty", "stop-first" (every slot
    valid; every other ray stops after its first slot) and "stop-last"
    (every slot valid; the crossing step is the second-to-last slot on half
    the rays, the last on the other half) and "long" (every slot valid,
    sigma U(0, 2): rays stop after ~180 slots, so a walk spans many
    16-slot tiles when S is large). A stop-first ray alone would
    hold C' to nothing: its one processed step has an alpha that rounds to
    1 in float32, so the forward's transmittance after it is exactly 0 and
    C' gives d sigma = 0 where autograd's exp gives ~1e-10."""
    sig = rng.uniform(0.0, 40.0, (N, S)).astype(np.float32)
    dts = np.full((N, S), 0.05, np.float32)
    ts = (3.0 + np.cumsum(dts, axis=1)).astype(np.float32)
    valid = np.ones((N, S), bool)
    if layout == "dense":
        valid = rng.random((N, S)) < 0.85
    elif layout == "long":
        sig *= np.float32(0.05)
    elif layout == "sparse":
        valid = np.zeros((N, S), bool)
        valid[np.arange(N), rng.integers(0, S, N)] = True
        valid[rng.random(N) < 0.5] = False
    elif layout == "empty":
        valid[:] = False
    elif layout == "stop-first":
        sig[::2, 0] = 400.0  # optical depth 20 > -ln(1e-4) in the first step
    elif layout == "stop-last":
        sig[:] = 1.0  # 0.05 a step
        last = np.where(np.arange(N) % 2 == 0, S - 2, S - 1)
        sig[np.arange(N), last] = 400.0
    dts[~valid] = 0.0
    return (sig, rng.random((N, S, 3)).astype(np.float32), dts, ts, valid,
            rng.random((N, S)).astype(np.float32))


# S = 16: vector loads of every input and of the valid row; 20: vector
# loads, valid bytes one by one, two tiles of C'; 13: scalar loads;
# 2,048: 128 tiles of C' ("long" rows live through ~11 of them);
# "offset": S = 16 with every input, upstream gradient and saved output one
# element past a 16-byte line (the wrappers copy them); "few": dense rows
# on fewer rays than a block of C'. N = 50,003 (4,099 at S = 2,048; 37 for
# "few") is a multiple of no block's ray count
_COMPOSITE_CASES = [("dense", 16), ("sparse", 16), ("empty", 16), ("stop-first", 16),
                    ("stop-last", 16), ("dense", 20), ("dense", 13), ("sparse", 13),
                    ("stop-last", 13), ("offset", 16), ("dense", 2048), ("long", 2048),
                    ("few", 16)]


def _offset(v):
    """v's values in a view that starts one element past a 16-byte line."""
    flat = torch.zeros(v.numel() + 1, dtype=v.dtype, device=v.device)
    flat[1:] = v.reshape(-1)
    return flat[1:].view(v.shape)


@pytest.mark.parametrize("layout,S", _COMPOSITE_CASES, ids=lambda v: str(v))
def test_composite_kernels_match_plain(dev, layout, S):
    """Kernel C within 1e-5 of its twin, and kernel C' on C's outputs within
    1e-5 of the largest gradient of autograd through the twin (see the
    module's note); all three gradients exactly 0 on every invalid slot and
    every slot past a ray's early stop."""
    rng = np.random.default_rng(6 + S)
    N = 4_099 if S == 2048 else 37 if layout == "few" else 50_003
    arrays = composite_rows("dense" if layout in ("offset", "few") else layout, N, S, rng)
    args = [_t(v, dev) for v in arrays]
    if layout == "offset":
        args = [_offset(v) for v in args]
    kc, kb = _kernels.KERNELS["composite_rays"], _kernels.KERNELS["composite_rays_backward"]
    before = kc.launches
    got = T.composite_rays(*args, T_thresh=1e-4)
    assert kc.launches == before + 1
    want = T.composite_rays_plain(*args, T_thresh=1e-4)
    torch.cuda.synchronize()
    for k in got:
        assert float((got[k] - want[k]).abs().max()) <= 1e-5, k
    if layout == "empty":
        assert all(float(v.abs().max()) == 0.0 for v in got.values())
    if layout == "stop-first":  # the even rays stop after their first slot
        assert bool((want["weights_sum"][::2] > 0.999).all())
        assert bool((got["depth"][::2] == (args[3][::2, 0] + args[2][::2, 0]) *
                     got["weights_sum"][::2]).all())
    if layout == "stop-last":  # every ray stops at or before its last slot
        assert bool((want["weights_sum"] > 0.999).all())

    keys = ("image", "depth", "weights_sum", "ambient_sum")
    grads = {k: _t(rng.normal(size=(N, 3) if k == "image" else (N,)).astype(np.float32), dev)
             for k in keys}
    outs = got
    if layout == "offset":
        grads = {k: _offset(v) for k, v in grads.items()}
        outs = {k: _offset(v) for k, v in got.items()}
    before = kb.launches
    g_k = T.composite_rays_backward(*args, grads, outs, T_thresh=1e-4)
    assert kb.launches == before + 1
    g_p = T.composite_rays_backward_plain(*args, grads, T_thresh=1e-4)
    torch.cuda.synchronize()
    for a, b in zip(g_k, g_p):
        assert _rel_err(a, b) <= 1e-5
    # no gradient into an invalid slot or a slot past the early stop: the
    # plain version's d ambient is the upstream gradient (never 0 here) on
    # exactly the valid slots processed
    processed = g_p[2] != 0
    for g in g_k:
        assert float(g[~processed].abs().sum()) == 0.0
    if layout == "long":  # the walks run through many 16-slot tiles
        last = (processed * torch.arange(S, device=dev)).max(dim=1).values
        assert float(last.float().mean()) > 100
    if (layout, S) == ("dense", 16):  # the autograd path
        sr, rr, ar = (v.clone().requires_grad_(True) for v in (args[0], args[1], args[5]))
        out = T.composite_rays(sr, rr, args[2], args[3], args[4], ar, T_thresh=1e-4)
        assert out["image"].grad_fn is not None
        sum((out[k2] * grads[k2]).sum() for k2 in keys).backward()
        for a, b in zip((sr.grad, rr.grad, ar.grad), g_p):
            assert _rel_err(a, b) <= 1e-5


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


def test_rasterize_kernel_matches_plain(dev):
    """Kernel E against rasterize_plain bit for bit on a seeded batch of 4
    frames of 512x512: a jittered 175 x 198 lattice (the BFM's density, ~69k
    triangles over a face-sized region) over a coarse lattice of large
    triangles reaching past the borders (whose margins the trim keeps or
    drops by their size), one repeated triangle (an exact depth tie) and one
    degenerate triangle; the same at 450x450; a batch whose second
    frame has every triangle off the image; no triangle at all; one
    triangle covering the whole frame behind the lattice."""
    rng = np.random.default_rng(0)

    def lattice(gx, gy, x0, x1, y0, y1):
        xs, ys = np.meshgrid(np.linspace(x0, x1, gx), np.linspace(y0, y1, gy), indexing="xy")
        i, j = np.meshgrid(np.arange(gy - 1), np.arange(gx - 1), indexing="ij")
        a = (i * gx + j).reshape(-1)
        tris = np.concatenate([np.stack([a, a + gx, a + 1], -1),
                               np.stack([a + 1, a + gx, a + gx + 1], -1)])
        return np.stack([xs, ys], -1).reshape(-1, 2), tris

    def check(xy, z, tris, H, W):
        xy_t, z_t, tris_t = _t(xy, dev), _t(z, dev), _t(tris, dev)
        before = _kernels.KERNELS["rasterize"].launches
        got = T.rasterize(xy_t, z_t, tris_t, H, W)
        assert _kernels.KERNELS["rasterize"].launches == before + 1
        want = T.rasterize_plain(xy_t, z_t, tris_t, H, W)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (xy.shape[0], H, W)
        assert torch.equal(got, want)
        return got

    xy1, t1 = lattice(175, 198, 110.0, 400.0, 80.0, 460.0)
    xy2, t2 = lattice(9, 9, -40.0, 560.0, -40.0, 560.0)
    tris = np.concatenate([t1, t2 + len(xy1), t1[5000:5001], [[0, 0, 1]]]).astype(np.int32)
    B = 4
    xy = np.stack([np.concatenate([xy1 + rng.normal(0, 0.3, xy1.shape),
                                   xy2 + rng.normal(0, 3.0, xy2.shape)])
                   for _ in range(B)]).astype(np.float32)
    z = np.concatenate([rng.uniform(5.0, 5.5, (B, len(xy1))),
                        rng.uniform(4.0, 8.0, (B, len(xy2)))], 1).astype(np.float32)
    got = check(xy, z, tris, 512, 512)
    assert float((got >= 0).float().mean()) > 0.5
    assert not bool((got == len(tris) - 2).any())  # the tie goes to the lower id
    check(xy, z, tris, 450, 450)
    far = xy[:2].copy()
    far[1] += 1000.0  # every triangle of frame 1 off the image
    got = check(far, z[:2], tris, 512, 512)
    assert bool((got[1] == -1).all()) and bool((got[0] >= 0).any())
    got = check(xy[:2], z[:2], np.zeros((0, 3), np.int32), 512, 512)
    assert bool((got == -1).all())
    whole = np.array([[-10.0, -10.0], [2000.0, -10.0], [-10.0, 2000.0]], np.float32)
    xy_w = np.concatenate([xy[:2, :len(xy1)], np.broadcast_to(whole, (2, 3, 2))], 1)
    z_w = np.concatenate([z[:2, :len(xy1)], np.full((2, 3), 9.0, np.float32)], 1)
    tris_w = np.concatenate([t1, [[len(xy1), len(xy1) + 1, len(xy1) + 2]]]).astype(np.int32)
    got = check(xy_w, z_w, tris_w, 512, 512)
    assert bool((got >= 0).all()) and bool((got == len(t1)).any())
    with pytest.raises(RuntimeError, match="no backward"):
        T.rasterize(_t(xy, dev).requires_grad_(True), _t(z, dev), _t(tris, dev), 512, 512)
