"""The port's bf16 policy (``-O``: bf16 MLPs, grid encodes on bf16 tables
with a bf16 lerp) against the JAX package's, on the CPU, on the same numpy
inputs and the same weights (``convert.network_from_jax``).

Where XLA:CPU rounds the bf16 lerp: run op by op, ``grid_encode01_packed``
rounds each weight x corner product to bf16 and sums the products in
float32 (``jnp.sum`` upcasts), rounding the sum once; under ``jit`` XLA keeps
the products in float32 (excess precision), which moves about a third of
the outputs by one bf16 ulp. The port's twin (and kernel A-bf16) round as
the op-by-op run does: equal to it, within one ulp of the jitted run.

Tolerances, and why:
- encode values: equal to JAX op by op; against JAX under jit, within 1
  bf16 ulp for more than 90% of them (93% here): the jitted products are
  unrounded, and where they cancel, half an ulp of each product is several
  ulps of the small sum;
- encode gradients against JAX: JAX rounds every term to bf16 and
  scatter-adds them into a bf16 table, the port sums exact float32 terms
  (a deliberate difference): the table gradient within 2^-6 of each row's
  absolute sum of terms (a few bf16 roundings of that sum), the x gradient
  within 2^-6 of its largest value;
- encode gradients against float64 arithmetic on the same bf16 forward
  (bf16 table values and weights, the weights' rounding taken as the
  identity, as autodiff takes a cast): 1e-5 of the largest (float32 sums);
- field and torso: atol 1e-2, the tolerance the JAX package holds its own
  bf16 path to (tests/test_models.py:514), against JAX jitted with XLA's
  excess precision off (``_jit_rounding``: bf16 values rounded where the
  program says, as the port rounds them; with it on, the tables here,
  drawn U(-1, 1), make the sigma MLP's unrounded hidden values move the
  density by up to 0.024);
- the 48x48 frame: port-bf16 nearer JAX-bf16 than JAX-bf16 is to
  JAX-fp32 (the policy's own error), and its PSNR against JAX-bf16 stated;
- the density-grid upkeep against JAX op by op: the grid within 2^-6
  relative, the occupancy bits that differ counted (under 1%);
- one -O head step against JAX's jitted step with XLA's excess precision
  off: the same telemetry and the loss to rel 1e-5; the gradients that do
  not pass through the ambient encode's x gradient (sigma and colour MLPs,
  codes, the ambient table) within 3e-2 of each parameter's largest (bf16
  GEMM roundings in another order); the others (ambient MLP, audio nets,
  spatial table) within 2.5e-1: there JAX rounds each corner's term of the
  x gradient to bf16 and the port keeps it in float32 (kernel A'-bf16's
  deliberate difference), and that gradient is a small difference of terms
  scaled by up to the finest level's resolution, so the roundings move it
  by up to a fifth (measured 0.20 at most). Run op by op (~75 s of JAX
  here, too slow for this suite), JAX's step and the port's agreed within
  0.6% of each parameter's largest gradient, on the unscaled weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.models import NetworkConfig as JNetworkConfig
from radnerf_tpu.models import RenderConfig as JRenderConfig
from radnerf_tpu.models import RendererState as JRendererState
from radnerf_tpu.models import compute_occ_bbox
from radnerf_tpu.models import render_rays as j_render_rays
from radnerf_tpu.models.network import field_forward as j_field_forward
from radnerf_tpu.models.network import forward_torso as j_forward_torso
from radnerf_tpu.models.renderer import compute_occ_sphere
from radnerf_tpu.ops.grid_encode import GridSpec as JGridSpec
from radnerf_tpu.ops.grid_encode import build_packed_table, grid_encode_packed
from radnerf_tpu.ops.marching import build_sigma_bytes
from radnerf_tpu.ops.morton import packbits
from radnerf_tpu.train.losses import head_loss as j_head_loss

from radnerf_tpu_torch import ops as T
from radnerf_tpu_torch.convert import (
    _state_dict_from_jax,
    network_from_jax,
    network_to_jax,
    state_from_numpy,
)
from radnerf_tpu_torch.models import NeRFNetwork, NetworkConfig, RenderConfig, render_rays
from radnerf_tpu_torch.train import head_loss

from test_torch_render import frame_inputs  # noqa: F401  (the 48x48 scene)
from test_torch_train import GRID, SMALL, TELEMETRY, _blob_state_j

BF16 = torch.bfloat16


def _T(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(a, b):
    """One bf16 ulp at the larger magnitude of a and b (the smallest normal's
    at 0)."""
    m = np.maximum(np.abs(a), np.abs(b)).astype(np.float64)
    return np.exp2(np.floor(np.log2(np.maximum(m, 2.0**-126))) - 7)


def _jit_rounding(fn, *args):
    """fn jitted and compiled with XLA's excess precision off, so that
    every bf16 value is rounded where the program says, as op by op (and as
    in the port); with it on, XLA keeps fused bf16 intermediates in
    float32. Returns fn's value at args."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _specs(input_dim):
    # 4 levels to 512: the 2-D level 0 (289 rows) takes JAX's one-hot
    # fetch, the larger levels its row gather
    kw = dict(input_dim=input_dim, num_levels=4, level_dim=2, base_resolution=16,
              log2_hashmap_size=16, desired_resolution=512)
    return JGridSpec.create(**kw), T.GridSpec.create(**kw)


def _encode_case(input_dim, n=1024):
    rng = np.random.default_rng(40 + input_dim)
    jspec, tspec = _specs(input_dim)
    emb = rng.normal(size=(jspec.n_embeddings, 2)).astype(np.float32)
    x = rng.uniform(-1.05, 1.05, (n, input_dim)).astype(np.float32)  # some outside
    g = _T(rng.normal(size=(n, 2 * jspec.num_levels)).astype(np.float32)).to(BF16)
    return jspec, tspec, emb, x, g.float().numpy()


@pytest.mark.parametrize("input_dim", [2, 3])
def test_bf16_encode_matches_jax(input_dim):
    """The bf16 encode's plain version: equal to JAX's packed bf16 encode op
    by op, within 1 bf16 ulp of it under jit for 90% of the outputs (module
    docstring); points outside the box give
    exactly 0; a bf16 table and the float32 master with table_dtype give the
    same."""
    jspec, tspec, emb, x, _ = _encode_case(input_dim)
    packed = build_packed_table(jnp.asarray(emb), jspec, jnp.bfloat16)
    op = np.asarray(grid_encode_packed(jnp.asarray(x), packed, jspec, 1.0).astype(jnp.float32))
    jit = np.asarray(jax.jit(lambda a, p: grid_encode_packed(a, p, jspec, 1.0))(
        jnp.asarray(x), packed).astype(jnp.float32))
    got = T.grid_encode(_T(x), _T(emb), tspec, 1.0, table_dtype=BF16)
    assert got.dtype == BF16 and got.shape == (x.shape[0], 8)
    assert torch.equal(got, T.grid_encode(_T(x), _T(emb).to(BF16), tspec, 1.0))
    got = got.float().numpy()
    np.testing.assert_array_equal(got, op)
    # under jit the products stay unrounded (and x * scale + 0.5 may become an
    # FMA that moves a point into the next cell): within 1 ulp where the
    # products' roundings do not cancel, which is most outputs
    assert np.mean(np.abs(got - jit) <= _bf16_ulp(got, jit)) > 0.9
    assert (got != jit).mean() > 0.05  # the jitted run really rounds elsewhere
    oob = (np.abs(x) > 1.0).any(axis=-1)
    assert oob.sum() > 10 and np.all(got[oob] == 0.0)


def _pack_specs(input_dim):
    # 5 levels of 8 to 256 with 2^10-row levels: dense levels and wrapped ones
    kw = dict(input_dim=input_dim, num_levels=5, level_dim=2, base_resolution=8,
              log2_hashmap_size=10, desired_resolution=256)
    return JGridSpec.create(**kw), T.GridSpec.create(**kw)


@pytest.mark.parametrize("input_dim", [2, 3])
def test_pack_table_matches_jax(input_dim):
    """Kernel A-bf16's corner-packed table (the plain version of its packing
    pass): row k of level l holds, corner by corner, the bf16 rows JAX's
    build_packed_table(dtype=bfloat16) puts in entry k of level l
    (channel-major there), at dense levels and at wrapped 2^10-row ones."""
    jspec, tspec = _pack_specs(input_dim)
    rng = np.random.default_rng(60 + input_dim)
    emb = rng.normal(size=(jspec.n_embeddings, 2)).astype(np.float32)
    jpacked = build_packed_table(jnp.asarray(emb), jspec, jnp.bfloat16)
    got = T.pack_table(_T(emb), tspec)
    D, offs = input_dim, tspec.offsets
    assert got.dtype == BF16 and got.shape == (tspec.n_embeddings, 1 << D, 2)
    sizes = [offs[l + 1] - offs[l] for l in range(tspec.num_levels)]
    assert 1024 in sizes and any(s < 1024 for s in sizes)
    for level, size in enumerate(sizes):
        want = np.asarray(jpacked[level][:size].astype(jnp.float32))
        want = want.reshape(size, 2, 1 << D).transpose(0, 2, 1)  # [T, corner, channel]
        np.testing.assert_array_equal(got[offs[level]:offs[level + 1]].float().numpy(), want)
    assert torch.equal(T.pack_table(_T(emb).to(BF16), tspec), got)


@pytest.mark.parametrize("input_dim", [2, 3])
def test_packed_encode_matches_row_layout(input_dim):
    """The bf16 encode through the packed table (the plain version of what
    kernel A-bf16 reads) is bit for bit the row-layout twin's, at dense and
    wrapped levels, points outside the box included."""
    _, tspec = _pack_specs(input_dim)
    rng = np.random.default_rng(70 + input_dim)
    tb = _T(rng.normal(size=(tspec.n_embeddings, 2)).astype(np.float32)).to(BF16)
    x = _T(rng.uniform(-1.05, 1.05, (2048, input_dim)).astype(np.float32))
    got = T.grid_encode(x, tb, tspec, packed=T.pack_table(tb, tspec))
    want = T.grid_encode_plain(x, tb, tspec)
    assert got.dtype == BF16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("input_dim", [2, 3])
def test_corner_pairs_key_their_first_row(input_dim):
    """What kernel A'-bf16's pair keys rest on: at every level, dense or
    wrapped, corner 2q + 1's row is corner 2q's plus one modulo the level's
    size (dim 0's stride is 1), so a pair's terms can go whole into the key
    of its first row, and row r's gradient is keys[r].xy + keys[r - 1].zw:
    equal (to float64 rounding) to the row-wise scatter of the same terms."""
    from radnerf_tpu_torch.ops.grid_encode import _level_corners

    _, tspec = _pack_specs(input_dim)
    rng = np.random.default_rng(80 + input_dim)
    x01 = _T(rng.uniform(0, 1, (4096, input_dim)).astype(np.float32))
    g = _T(rng.normal(size=(4096, 2)))
    for level in range(tspec.num_levels):
        off = tspec.offsets[level]
        size = tspec.offsets[level + 1] - off
        corners = _level_corners(x01, tspec, level)[0]
        rows = torch.zeros((size, 2), dtype=torch.float64)
        keys = torch.zeros((size, 4), dtype=torch.float64)
        for c0 in range(0, 1 << input_dim, 2):
            (r0, w0), (r1, w1) = corners[c0], corners[c0 + 1]
            r0, r1 = r0 - off, r1 - off
            assert torch.equal(r1, (r0 + 1) % size)
            t0, t1 = w0.double()[:, None] * g, w1.double()[:, None] * g
            rows.index_add_(0, r0, t0).index_add_(0, r1, t1)
            keys.index_add_(0, r0, torch.cat([t0, t1], dim=1))
        rebuilt = keys[:, :2] + keys.roll(1, dims=0)[:, 2:]
        torch.testing.assert_close(rebuilt, rows, rtol=1e-12, atol=1e-12)


def test_packed_copy_follows_the_table():
    """The network's packed copy of a table is made once per table value:
    the same object while the parameter is unchanged, a new packing of the
    new bf16 copy after an in-place update."""
    net = NeRFNetwork(NetworkConfig(**SMALL, compute_dtype="bfloat16"), device="cpu")
    spec = net.cfg.grid_spec
    packed = net.packed_copy("encoder", spec)
    assert net.packed_copy("encoder", spec) is packed
    assert torch.equal(packed, T.pack_table(net.table_copy("encoder"), spec))
    with torch.no_grad():
        net.encoder.mul_(2.0)
    again = net.packed_copy("encoder", spec)
    assert again is not packed
    assert torch.equal(again, T.pack_table(net.table_copy("encoder"), spec))


def _float64_gradients(x, emb, g, tspec):
    """Table and x gradients of the bf16 forward in float64: the terms
    bf16(w) * g with bf16 table values, the fractions from the float32
    positions, the weights' rounding taken as the identity."""
    from radnerf_tpu_torch.ops.grid_encode import _level_corners

    D, L = tspec.input_dim, tspec.num_levels
    x01 = (_T(x) + 1.0) / 2.0
    live = ((x01 >= 0) & (x01 <= 1)).all(dim=-1)
    tb = _T(emb).to(BF16).double()
    gg = _T(g).double().reshape(-1, L, 2)
    g_table = torch.zeros(tb.shape, dtype=torch.float64)
    g_x = torch.zeros(x01.shape, dtype=torch.float64)
    for level in range(L):
        corners, frac = _level_corners(x01, tspec, level)
        frac = frac.double()
        gl = gg[:, level]
        for corner, (rows, w) in enumerate(corners):
            g_table.index_add_(0, rows[live], (w.to(BF16).double()[:, None] * gl)[live])
            dot = (gl * tb[rows]).sum(-1)
            for d in range(D):
                dw = torch.ones_like(dot) * (1.0 if (corner >> d) & 1 else -1.0)
                for e in range(D):
                    if e != d:
                        dw = dw * (frac[:, e] if (corner >> e) & 1 else 1.0 - frac[:, e])
                g_x[:, d] += torch.where(live, dot * dw * tspec.level_scale(level) / 2.0, 0.0)
    return g_table.numpy(), g_x.numpy()


@pytest.mark.parametrize("input_dim", [2, 3])
def test_bf16_encode_gradients(input_dim):
    """Autograd through the bf16 encode (the plain versions of A-bf16 and
    A'-bf16) against jax.grad of JAX's packed bf16 encode (module docstring's
    2^-6 bounds) and against float64 arithmetic on the same bf16 forward (1e-5
    of the largest); float32 gradients to the float32 master table; zero for
    points outside the box; the backward wrapper's plain version equal to
    autograd's."""
    jspec, tspec, emb, x, g = _encode_case(input_dim)

    def f(xj, ej):
        packed = build_packed_table(ej, jspec, jnp.bfloat16)
        return jnp.sum(grid_encode_packed(xj, packed, jspec, 1.0).astype(jnp.float32) * g)

    want_x, want_t = (np.asarray(v) for v in jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(emb)))
    xt, et = _T(x).requires_grad_(True), _T(emb).requires_grad_(True)
    (T.grid_encode(xt, et, tspec, 1.0, table_dtype=BF16).float() * _T(g)).sum().backward()
    got_t, got_x = et.grad.numpy(), xt.grad.numpy()
    assert et.grad.dtype == xt.grad.dtype == torch.float32
    oob = (np.abs(x) > 1.0).any(axis=-1)
    assert np.all(got_x[oob] == 0.0)

    # each row's absolute sum of terms, sum |bf16(w) * g|
    abs_rows = T.grid_encode_backward(_T(x), _T(emb).to(BF16), _T(np.abs(g)).to(BF16), tspec,
                                      1.0, need_x=False)[0].numpy()
    assert np.all(np.abs(got_t - want_t) <= 2.0**-6 * abs_rows)
    assert np.abs(got_x - want_x).max() <= 2.0**-6 * np.abs(want_x).max()

    ref_t, ref_x = _float64_gradients(x, emb, g, tspec)
    assert np.abs(got_t - ref_t).max() <= 1e-5 * np.abs(ref_t).max()
    assert np.abs(got_x - ref_x).max() <= 1e-5 * np.abs(ref_x).max()

    g_table, g_x = T.grid_encode_backward(_T(x), _T(emb), _T(g).to(BF16), tspec, 1.0,
                                          table_dtype=BF16)
    np.testing.assert_array_equal(g_table.numpy(), got_t)
    np.testing.assert_array_equal(g_x.numpy(), got_x)


# ------------------------------------------------------------- the field
@pytest.fixture(scope="module")
def torso_params():
    """The narrow model with the torso drawn by the port (seed 23) as the
    JAX pytree, its grid tables drawn U(-1, 1) and the sigma MLP's last layer
    x4 so they shape the field; numpy leaves."""
    net = NeRFNetwork(NetworkConfig(**SMALL, torso=True), device="cpu",
                      generator=torch.Generator().manual_seed(23))
    params = network_to_jax(net)
    for k in ("encoder", "encoder_ambient", "torso_encoder"):
        params[k] = params[k] * 1e4
    params["sigma_net"]["layers"][-1]["w"] = params["sigma_net"]["layers"][-1]["w"] * 4.0
    return params


def _nets(params, **kw):
    jcfg = JNetworkConfig(**SMALL, torso=True, compute_dtype="bfloat16", **kw)
    net = network_from_jax(params, NetworkConfig(**SMALL, torso=True, compute_dtype="bfloat16",
                                                 **kw), device="cpu")
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), net


def test_bf16_field_and_torso_match_jax(torso_params):
    """field_forward and forward_torso under bf16 against JAX's (jitted with
    its bf16 roundings kept, ``_jit_rounding``) at atol 1e-2, float32
    outputs; the network's bf16 table copies are made once per
    parameter value and are no parameters (so no checkpoint holds them)."""
    jcfg, pj, net = _nets(torso_params)
    rng = np.random.default_rng(24)
    N = 512
    x = rng.uniform(-0.95, 0.95, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    enc_a = rng.normal(size=(1, 64)).astype(np.float32)
    e = np.array([[0.25]], np.float32)
    want = _jit_rounding(lambda *a: j_field_forward(pj, jcfg, *a),
                         jnp.asarray(x), jnp.asarray(d), jnp.asarray(enc_a),
                         pj["individual_codes"][0], jnp.asarray(e))
    with torch.no_grad():
        got = net.field_forward(_T(x), _T(d), _T(enc_a), net.individual_codes[0], _T(e))
    for gv, w in zip(got, want):
        assert gv.dtype == torch.float32
        np.testing.assert_allclose(gv.numpy(), np.asarray(w, np.float32), atol=1e-2, rtol=0)
    assert np.asarray(want[0]).std() > 0.02  # the density varies over x

    xt = rng.uniform(-1.0, 1.0, (N, 2)).astype(np.float32)
    pose6 = rng.normal(size=(1, 6)).astype(np.float32)
    want = _jit_rounding(lambda *a: j_forward_torso(pj, jcfg, *a),
                         jnp.asarray(xt), jnp.asarray(pose6), pj["individual_codes_torso"][0])
    with torch.no_grad():
        got = net.forward_torso(_T(xt), _T(pose6), net.individual_codes_torso[0])
    for gv, w in zip(got, want):
        assert gv.dtype == torch.float32
        np.testing.assert_allclose(gv.numpy(), np.asarray(w, np.float32), atol=1e-2, rtol=0)

    copy = net.table_copy("encoder")
    assert copy.dtype == BF16 and net.table_copy("encoder") is copy
    with torch.no_grad():
        net.encoder.mul_(2.0)  # an in-place update: a new copy
    assert not torch.equal(net.table_copy("encoder"), copy)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert not any(t.dtype == BF16 for t in net.state_dict().values())


def test_network_config_bf16_policy():
    """The -O options build the bf16 policy's config: MLPs in bf16, bf16
    tables; anything but float32 and bfloat16 is refused."""
    from radnerf_tpu_torch.config import Options

    cfg = NetworkConfig.from_options(Options().apply_O())
    assert cfg.compute_dtype == "bfloat16" and cfg.exp_eye
    assert cfg.dtype == BF16 and cfg.table_dtype == BF16
    assert NetworkConfig().dtype == torch.float32 and NetworkConfig().table_dtype is None
    with pytest.raises(ValueError):
        NetworkConfig(compute_dtype="float16")


# ------------------------------------------------------------- the frame
def test_bf16_frame_nearer_jax_bf16_than_jax_fp32(frame_inputs):  # noqa: F811
    """tests/test_torch_render.py's 48x48 head+torso frame (full-width
    imported weights) under bf16: the port's distance to JAX-bf16 is below
    JAX-bf16's distance to JAX-fp32, and the telemetry equal."""
    params, f = frame_inputs
    thresh = 1.0
    rc_j = JRenderConfig(torso=True, exp_eye=True, grid_size=GRID, max_steps=8, dt_gamma=0.0,
                         sample_capacity_mult=16.0, ray_capacity_frac=1.0, cull_T=1e-6)
    grid = jnp.asarray(f["grid"])
    state_j = JRendererState.create(rc_j).replace(
        density_grid=grid, density_bitfield=packbits(grid, thresh),
        mean_density=jnp.asarray(1.0, jnp.float32),
        density_grid_torso=jnp.asarray(f["torso_grid"]),
        mean_density_torso=jnp.asarray(0.05, jnp.float32),
        occ_bbox=compute_occ_bbox(rc_j, grid, thresh),
        occ_sphere=compute_occ_sphere(rc_j, grid, thresh),
    ).with_sigma_bytes(build_sigma_bytes(grid, thresh))
    a = {k: jnp.asarray(v) for k, v in f.items()}
    images = {}
    for dtype in ("float32", "bfloat16"):
        cfg_j = JNetworkConfig(torso=True, exp_eye=True, compute_dtype=dtype)
        res, _ = jax.jit(lambda p, s: j_render_rays(
            p, cfg_j, rc_j, s, a["rays_o"], a["rays_d"], a["auds"], a["bg_coords"],
            a["pose6"], a["eye"], jnp.zeros((), jnp.int32), a["bg_color"],
            training=False))(params, state_j)
        images[dtype] = np.asarray(res["image"], np.float64)
    rc = RenderConfig(torso=True, grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=1e-6)
    net = network_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           NetworkConfig(torso=True, exp_eye=True, compute_dtype="bfloat16"),
                           device="cpu")
    state = state_from_numpy(rc, f["grid"], f["torso_grid"], 1.0, 0.05, thresh=thresh,
                             device="cpu")
    t = {k: _T(v) for k, v in f.items()}
    got, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"], t["bg_coords"],
                         t["pose6"], t["eye"], 0, t["bg_color"])
    for k in ("n_hit", "n_samples_needed", "n_max_count", "n_torso_mask"):
        assert int(got[k]) == int(res[k]), k
    img = got["image"].numpy().astype(np.float64)
    assert np.isfinite(img).all() and float(got["weights_sum"].max()) > 0.05

    def mse(p, q):
        return float(np.mean((p - q) ** 2))

    port_to_jax = mse(img, images["bfloat16"])
    policy = mse(images["bfloat16"], images["float32"])
    print(f"\n[bf16 frame] PSNR port-bf16 vs JAX-bf16 {10 * np.log10(1 / port_to_jax):.2f} dB, "
          f"JAX-bf16 vs JAX-fp32 {10 * np.log10(1 / policy):.2f} dB")
    assert port_to_jax < policy


# ------------------------------------------------------------ a -O step
# the parameters whose gradients do not pass through the ambient encode's x
# gradient
DIRECT = ("sigma_net", "color_net", "individual_codes", "encoder_ambient")


def test_bf16_head_train_step_matches_jax(torso_params):
    """One head-stage step under bf16 (tests/test_torch_train.py's blob scene,
    512 rays, the same noises) against JAX's jitted step compiled with XLA's
    excess precision off (so XLA rounds to bf16 where the program says, as
    the port does; with it on, fused bf16 ops keep float32 values and the
    jitted gradients move by up to the size of a small parameter's own):
    the same telemetry, the loss to rel 1e-5, the gradients as the module
    docstring says; every gradient float32."""
    params = {k: v for k, v in torso_params.items()
              if k not in ("torso_deform_net", "torso_encoder", "torso_net",
                           "individual_codes_torso")}
    bf16_head_step_vs_jax(params, SMALL)


def bf16_head_step_vs_jax(params, net_kw, with_jax_spread=False, losses=None):
    """test_bf16_head_train_step_matches_jax's step and checks for the head
    model of NetworkConfig(**net_kw) with the JAX pytree ``params``. With
    ``with_jax_spread`` each tolerance also takes JAX's own move: how far
    its jitted step moves (the loss, each parameter's gradient) when XLA
    keeps its bf16 intermediates in float32 (excess precision on). A dict
    ``losses`` receives the port's loss and JAX's: jitted with excess
    precision off, on (with the spread), and run op by op (slow)."""
    from radnerf_tpu.data.rays import get_bg_coords, get_rays
    from test_train import _blob_grid

    rng = np.random.default_rng(25)
    n = 512
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.3
    rays = get_rays(pose, (80.0, 80.0, 24.0, 24.0), 48, 48, n, rng=rng)
    f = dict(rays_o=rays["rays_o"], rays_d=rays["rays_d"],
             bg_coords=get_bg_coords(48, 48)[rays["inds"]],
             pose6=np.zeros((1, 6), np.float32),
             auds=rng.normal(size=(8, 44, 16)).astype(np.float32),
             bg_color=rng.random((n, 3)).astype(np.float32),
             eye=np.array([[0.25]], np.float32),
             images=rng.random((n, 3)).astype(np.float32),
             noises=rng.random(n).astype(np.float32))
    face_mask = rng.random(n) < 0.5
    index, step, iters = 3, 40, 100
    grid = _blob_grid(GRID)
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, exp_eye=True,
                         sample_capacity_mult=16.0, ray_capacity_frac=1.0, cull_T=1e-6)
    state_j = _blob_state_j(rc_j, grid, 1.0)
    cfg_j = JNetworkConfig(**net_kw, compute_dtype="bfloat16")
    a = {k: jnp.asarray(v) for k, v in f.items()}

    def loss_fn(p):
        res, _ = j_render_rays(p, cfg_j, rc_j, state_j, a["rays_o"], a["rays_d"], a["auds"],
                               a["bg_coords"], a["pose6"], a["eye"],
                               jnp.asarray(index, jnp.int32), a["bg_color"],
                               noises=a["noises"], training=True)
        loss = j_head_loss(res, a["images"], jnp.asarray(face_mask),
                           jnp.asarray(step, jnp.float32), iters, 0.1)
        return loss, {k: res[k] for k in TELEMETRY}

    (loss_j, tel_j), grads_j = _jit_rounding(jax.value_and_grad(loss_fn, has_aux=True),
                                             jax.tree_util.tree_map(jnp.asarray, params))
    want = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    loss_spread, spread = 0.0, {name: 0.0 for name in want}
    if with_jax_spread:
        (loss_e, _), grads_e = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
        loss_spread = abs(float(loss_e) - float(loss_j))
        moved = _state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_e))
        spread = {name: float(np.abs(moved[name] - w).max()) for name, w in want.items()}
        if losses is not None:
            losses["jax_jit_excess_precision"] = float(loss_e)
    if losses is not None:
        losses["jax_jit"] = float(loss_j)
        with jax.disable_jit():
            losses["jax_op_by_op"] = float(loss_fn(jax.tree_util.tree_map(jnp.asarray,
                                                                          params))[0])

    net = network_from_jax(params, NetworkConfig(**net_kw, compute_dtype="bfloat16"),
                           device="cpu")
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, cull_T=1e-6)
    state = state_from_numpy(rc, grid, np.zeros(GRID * GRID, np.float32), 1.0, 0.0,
                             thresh=1.0, device="cpu")
    t = {k: _T(v) for k, v in f.items()}
    res, _ = render_rays(net, rc, state, t["rays_o"], t["rays_d"], t["auds"], t["bg_coords"],
                         t["pose6"], t["eye"], index, t["bg_color"], noises=t["noises"],
                         training=True)
    loss = head_loss(res, t["images"], _T(face_mask), step, iters, 0.1)
    loss.backward()
    if losses is not None:
        losses["port"] = float(loss.detach())

    assert int(res["n_samples_needed"]) > 300
    for k in TELEMETRY:
        assert int(res[k]) == int(tel_j[k]), k
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5,
                               atol=loss_spread)
    got = dict(net.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None and g.dtype == torch.float32, name
        err = float(np.abs(g.numpy() - w).max())
        share = 3e-2 if name.startswith(DIRECT) else 2.5e-1
        tol = share * float(np.abs(w).max()) + spread[name]
        assert err <= tol, f"{name}: max |g - g_jax| {err} > {tol}"
    assert float(np.abs(want["encoder"]).max()) > 0


# ------------------------------------------------------------- the upkeep
def test_bf16_density_grid_upkeep_matches_jax(torso_params):
    """update_density_grid under bf16 at grid 32 with JAX's own jitter draws
    against JAX's run op by op (under jit, x * scale + jitter becomes an FMA
    and moves ~0.3% of the points into another fine cell, 7.5% off in
    density): the grid within 2^-6 relative (a few bf16 roundings of the
    density MLP's output, through exp), cells at -1 still -1, the mean
    density to rel 2^-7; the occupancy bits may differ where a cell's
    density is within that tolerance of the threshold: their count is
    printed and held under 1% of the cells (0 here)."""
    from radnerf_tpu.models import update_density_grid as j_update_density_grid
    from radnerf_tpu.models.network import encode_audio
    from radnerf_tpu.ops import morton as jmorton

    from radnerf_tpu_torch.models import RendererState, reset_extra_state, update_density_grid

    params = {k: v for k, v in torso_params.items()
              if k not in ("torso_deform_net", "torso_encoder", "torso_net",
                           "individual_codes_torso")}
    rng = np.random.default_rng(26)
    rc_j = JRenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0, exp_eye=True)
    rc = RenderConfig(grid_size=GRID, max_steps=8, dt_gamma=0.0)
    grid0 = rng.uniform(0.0, 3.0, (1, GRID**3)).astype(np.float32)
    grid0[:, rng.random(GRID**3) < 0.2] = -1.0
    cfg_j = JNetworkConfig(**SMALL, compute_dtype="bfloat16")
    auds = rng.normal(size=(8, 44, 16)).astype(np.float32)
    eye = np.array([[0.3]], np.float32)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    enc_a = encode_audio(pj, cfg_j, jnp.asarray(auds))
    key = jax.random.PRNGKey(6)
    state_j = JRendererState.create(rc_j).replace(density_grid=jnp.asarray(grid0))
    want = j_update_density_grid(pj, cfg_j, rc_j, state_j, enc_a, jnp.asarray(eye), key)
    jitter, k = [], key
    for cas in range(rc_j.cascade):
        half = min(2**cas, rc_j.bound) / GRID
        k, sub = jax.random.split(k)
        jitter.append(_T(np.asarray(jax.random.uniform(sub, (GRID**3, 3), minval=-half,
                                                       maxval=half))))

    net = network_from_jax(params, NetworkConfig(**SMALL, compute_dtype="bfloat16"),
                           device="cpu")
    state = reset_extra_state(rc, RendererState.create(rc, device="cpu"))
    state.density_grid = _T(grid0)
    with torch.no_grad():
        enc_t = net.encode_audio(_T(auds))
    got = update_density_grid(net, rc, state, enc_t, _T(eye), jitter=jitter)

    g_j = np.asarray(want.density_grid)
    np.testing.assert_allclose(got.density_grid.numpy(), g_j, rtol=2.0**-6, atol=1e-6)
    np.testing.assert_array_equal(got.density_grid.numpy() == -1.0, g_j == -1.0)
    np.testing.assert_allclose(float(got.mean_density), float(want.mean_density),
                               rtol=2.0**-7)
    bits = T.unpackbits(got.density_bitfield, 1, GRID).numpy()
    bits_j = np.asarray(jmorton.unpackbits(want.density_bitfield, 1, GRID))
    flipped = int((bits != bits_j).sum())
    print(f"\n[bf16 upkeep] {flipped} of {bits.size} occupancy bits differ from JAX's")
    assert flipped < 0.01 * bits.size
    assert 0.05 < bits_j.mean() < 0.95  # the threshold splits the grid
