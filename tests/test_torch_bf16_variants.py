"""The bf16 policy (``-O``) at every tiled grid the JAX package builds -- 1,
4 and 8 channels, linear and smoothstep, with and without align_corners, 2-
and 3-D -- in the port against the JAX package, on the CPU: the same numpy
inputs go through JAX's ``build_packed_table(dtype=bfloat16)`` +
``grid_encode_packed`` and through the plain versions of kernels A-bf16,
its packing pass and A'-bf16 (on CPU tensors the wrappers run them); then
one -O head step at the JAX bench's 8x4 grid.

JAX runs op by op: under ``jit`` XLA keeps the bf16 products in float32
(test_torch_bf16.py), and even with its excess precision off a jitted
gradient moved one row past the bounds below (a contracted ``x * scale +
shift`` can move a point to another cell). Op by op, each new set of
shapes costs JAX seconds of compiles, so the grids of one interpolation,
align_corners and D share one JAX encode at 8 channels: every channel's
encode, packed rows and table gradient depend on that channel of the
table and of the upstream gradient alone, so the 1- and 4-channel grids
take the first channels of the 8-channel table and JAX's results on them;
x's gradient sums over channels, so JAX's comes from the same encode's
vjp with the upstream gradient of the other channels set to zero.
Tolerances:
- the encode: equal to JAX's, through the row layout and through the
  packed copy; points outside the box encode to 0;
- the packed rows: equal to JAX's (channel-major there, corner-major here);
- the gradients: against jax.vjp of the packed encode, the table gradient
  within 2^-6 of each row's sum of |terms| and x within 2^-6 of its largest
  value (JAX rounds each term to bf16 and scatter-adds them into a bf16
  table, the port sums exact float32 terms: the deliberate difference
  test_torch_bf16.py states); against float64 arithmetic on the same bf16
  forward (bf16 table values and weights, the weights' rounding taken as
  the identity, smoothstep's slope from the float32 fractions) within 1e-5
  of the largest;
- the step: test_torch_bf16.py's -O step tolerances, each plus JAX's own
  move between its jitted step with XLA's excess precision off (the
  reference) and on. At 8x4 JAX's jitted bf16 step leaves its own op-by-op
  run by more than those tolerances (the loss by 1.15e-5 relative, where
  the port's is within 5e-7 of the op-by-op run's; running this file as a
  script prints them): its jitted bf16 GEMMs sum in another order, and at
  64 grid features a sigma-MLP input (16 at test_torch_bf16.py's grid)
  more sums land near a bf16 rounding tie; and JAX rounds each corner's
  term of the x gradient to bf16, four channels a dot here. JAX's own move
  under excess precision is larger (the loss by 3.8e-5); the port's
  distance stays inside it. Run op by op, JAX's step costs ~50 s for the
  loss alone, too slow for this suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.ops.grid_encode import GridSpec as JGridSpec
from radnerf_tpu.ops.grid_encode import build_packed_table, grid_encode_packed

from radnerf_tpu_torch import ops as T
from radnerf_tpu_torch.ops.grid_encode import _level_corners

from test_torch_bf16 import bf16_head_step_vs_jax
from test_torch_train import SMALL

BF16 = torch.bfloat16


def _T(a):
    return torch.from_numpy(np.array(a))


# (channels, interpolation, align_corners, D)
CASES = [(c, it, ac, d) for c in (1, 4, 8) for it in ("linear", "smoothstep")
         for ac in (False, True) for d in (2, 3)]
_SHARED = {}


def _spec_kw(C, interpolation, align_corners, D):
    return dict(input_dim=D, num_levels=3, level_dim=C, base_resolution=8 if D == 2 else 4,
                log2_hashmap_size=6, per_level_scale=2.0, interpolation=interpolation,
                align_corners=align_corners)


def _shared(interpolation, align_corners, D):
    """JAX's run at 8 channels for the grids of this interpolation,
    align_corners and D -- 3 levels of 2^6 rows: the finer ones wrapped, the
    first wrapped too (9^2 and 5^3 vertices) or, under align_corners, dense
    (8^2 and 4^3), so that every grid of one D has the same shapes and JAX
    compiles its ops for them once: the seeded table, points (some outside
    the box) and bf16 upstream gradient; JAX's encode, packed rows [T + 1,
    8, 2^D] a level, and for each C in (1, 4, 8) the gradients with the
    upstream gradient of channels C.. set to zero."""
    key = (interpolation, align_corners, D)
    if key in _SHARED:
        return _SHARED[key]
    jspec = JGridSpec.create(**_spec_kw(8, interpolation, align_corners, D))
    assert jspec.offsets == (0, 64, 128, 192)
    rng = np.random.default_rng(10 * D + 2 * align_corners + (interpolation == "smoothstep"))
    emb = rng.normal(size=(jspec.n_embeddings, 8)).astype(np.float32)
    x = rng.uniform(-1.05, 1.05, (256, D)).astype(np.float32)
    x[0], x[1] = -1.0, 1.0
    g = _T(rng.normal(size=(256, 3, 8)).astype(np.float32)).to(BF16).float().numpy()

    def encode(xj, ej):
        return grid_encode_packed(xj, build_packed_table(ej, jspec, jnp.bfloat16), jspec, 1.0)

    out, vjp = jax.vjp(encode, jnp.asarray(x), jnp.asarray(emb))
    grads = {}
    for C in (1, 4, 8):
        gc = np.where(np.arange(8) < C, g, 0.0).reshape(256, 24)
        want_x, want_t = vjp(jnp.asarray(gc).astype(jnp.bfloat16))
        grads[C] = (np.asarray(want_x), np.asarray(want_t))
    packed = build_packed_table(jnp.asarray(emb), jspec, jnp.bfloat16)
    run = dict(emb=emb, x=x, g=g, out=np.asarray(out.astype(jnp.float32)).reshape(256, 3, 8),
               packed=[np.asarray(p.astype(jnp.float32)).reshape(p.shape[0], 8, 1 << D)
                       for p in packed], grads=grads)
    _SHARED[key] = run
    return run


def _run(case):
    """The grid of ``case``: its spec, its table (the first C channels of the
    shared 8-channel one), points and upstream gradient, and JAX's encode,
    packed rows [T + 1, C, 2^D] a level and gradients (``_shared``)."""
    C, interpolation, align_corners, D = case
    tspec = T.GridSpec.create(**_spec_kw(C, interpolation, align_corners, D))
    n = tspec.level_resolution(0) + (0 if align_corners else 1)  # level 0's vertices a dim
    assert (n**D == 64) if align_corners else (n**D > 64)
    r = _shared(interpolation, align_corners, D)
    want_x, want_t = r["grads"][C]
    return dict(spec=tspec, emb=np.ascontiguousarray(r["emb"][:, :C]), x=r["x"],
                g=np.ascontiguousarray(r["g"][:, :, :C].reshape(256, 3 * C)),
                out=r["out"][:, :, :C].reshape(256, 3 * C),
                packed=[p[:, :C] for p in r["packed"]], want_x=want_x,
                want_t=np.ascontiguousarray(want_t[:, :C]))


@pytest.mark.parametrize("case", CASES, ids=lambda v: str(v))
def test_bf16_variant_encode_matches_jax(case):
    """The bf16 encode's plain version equal to JAX's packed bf16 encode op
    by op, from the float32 master with table_dtype and from a bf16 table,
    through the row layout and through the packed copy kernel A-bf16 reads;
    points outside the box give exactly 0."""
    r = _run(case)
    spec, x, emb = r["spec"], _T(r["x"]), _T(r["emb"])
    got = T.grid_encode(x, emb, spec, 1.0, table_dtype=BF16)
    assert got.dtype == BF16 and got.shape == (256, spec.output_dim)
    np.testing.assert_array_equal(got.float().numpy(), r["out"])
    tb = emb.to(BF16)
    packed = T.grid_encode(x, tb, spec, 1.0, packed=T.pack_table(tb, spec))
    assert torch.equal(packed.view(torch.int16), got.view(torch.int16))
    oob = (np.abs(r["x"]) > 1.0).any(axis=-1)
    assert oob.sum() > 5 and np.all(got.float().numpy()[oob] == 0.0)


@pytest.mark.parametrize("case", CASES, ids=lambda v: str(v))
def test_bf16_variant_packing_matches_jax(case):
    """The packing pass's plain version: row k of level l holds, corner by
    corner, the bf16 rows of JAX's build_packed_table(dtype=bfloat16) entry
    k of level l, at the dense level and at the wrapped ones."""
    r = _run(case)
    spec = r["spec"]
    C, D, offs = spec.level_dim, spec.input_dim, spec.offsets
    got = T.pack_table(_T(r["emb"]), spec)
    assert got.dtype == BF16 and got.shape == (spec.n_embeddings, 1 << D, C)
    for level, jp in enumerate(r["packed"]):
        size = spec.level_size(level)
        want = jp[:size].transpose(0, 2, 1)
        np.testing.assert_array_equal(got[offs[level]:offs[level + 1]].float().numpy(), want)


def _float64_gradients(x, emb, g, spec):
    """Table and x gradients of the bf16 forward in float64: the terms
    bf16(w) * g with bf16 table values, the fractions (smoothstepped) from
    the float32 positions, the weights' rounding taken as the identity."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    x01 = (_T(x) + 1.0) / 2.0
    live = ((x01 >= 0) & (x01 <= 1)).all(dim=-1)
    tb = _T(emb).to(BF16).double()
    gg = _T(g).double().reshape(-1, L, C)
    g_table = torch.zeros(tb.shape, dtype=torch.float64)
    g_x = torch.zeros(x01.shape, dtype=torch.float64)
    for level in range(L):
        corners, frac = _level_corners(x01, spec, level)
        frac = frac.double()
        pos = x01 * spec.level_scale(level) + spec.shift
        f = (pos - torch.floor(pos)).double()
        slope = 6.0 * f * (1.0 - f) if spec.interpolation == "smoothstep" else torch.ones_like(f)
        gl = gg[:, level]
        for corner, (rows, w) in enumerate(corners):
            g_table.index_add_(0, rows[live], (w.to(BF16).double()[:, None] * gl)[live])
            dot = (gl * tb[rows]).sum(-1)
            for d in range(D):
                dw = torch.ones_like(dot) * (1.0 if (corner >> d) & 1 else -1.0)
                for e in range(D):
                    if e != d:
                        dw = dw * (frac[:, e] if (corner >> e) & 1 else 1.0 - frac[:, e])
                g_x[:, d] += torch.where(
                    live, dot * dw * slope[:, d] * spec.level_scale(level) / 2.0, 0.0)
    return g_table.numpy(), g_x.numpy()


@pytest.mark.parametrize("case", CASES, ids=lambda v: str(v))
def test_bf16_variant_gradients_match_jax(case):
    """Autograd through the bf16 encode (the plain versions of A-bf16 and
    A'-bf16) against jax.vjp of JAX's packed bf16 encode (the module
    docstring's 2^-6 bounds) and against float64 arithmetic on the same bf16
    forward (1e-5 of the largest); float32 gradients to the float32 master;
    zero x gradient outside the box; the backward wrapper equal to
    autograd."""
    r = _run(case)
    spec, x, emb, g = r["spec"], r["x"], r["emb"], r["g"]
    xt, et = _T(x).requires_grad_(True), _T(emb).requires_grad_(True)
    (T.grid_encode(xt, et, spec, 1.0, table_dtype=BF16).float() * _T(g)).sum().backward()
    got_t, got_x = et.grad.numpy(), xt.grad.numpy()
    assert et.grad.dtype == xt.grad.dtype == torch.float32
    oob = (np.abs(x) > 1.0).any(axis=-1)
    assert np.all(got_x[oob] == 0.0)

    abs_rows = T.grid_encode_backward(_T(x), _T(emb).to(BF16), _T(np.abs(g)).to(BF16), spec,
                                      1.0, need_x=False)[0].numpy()
    assert np.all(np.abs(got_t - r["want_t"]) <= 2.0**-6 * abs_rows)
    assert np.abs(got_x - r["want_x"]).max() <= 2.0**-6 * np.abs(r["want_x"]).max()

    ref_t, ref_x = _float64_gradients(x, emb, g, spec)
    assert np.abs(got_t - ref_t).max() <= 1e-5 * np.abs(ref_t).max()
    assert np.abs(got_x - ref_x).max() <= 1e-5 * np.abs(ref_x).max()

    g_table, g_x = T.grid_encode_backward(_T(x), _T(emb), _T(g).to(BF16), spec, 1.0,
                                          table_dtype=BF16)
    np.testing.assert_array_equal(g_table.numpy(), got_t)
    np.testing.assert_array_equal(g_x.numpy(), got_x)


# the tiled grids past RAD-NeRF's, which the bf16 kernels' general path
# runs, as (C, interpolation, align_corners, D, levels): D = 1, 4, 7 and 8,
# 33 levels, 17 and 32 channels; 2^6-row tables, each level but a 1-D or
# 33-level grid's first wrapped
GENERAL_CASES = [(2, "linear", False, 1, 3), (2, "smoothstep", True, 4, 3),
                 (2, "linear", False, 7, 2), (1, "linear", False, 8, 2),
                 (2, "linear", False, 2, 33), (17, "linear", False, 3, 3),
                 (32, "smoothstep", True, 3, 3)]
_GENERAL_BASE = {1: 16, 2: 8, 3: 4, 4: 2, 7: 1, 8: 1}


@pytest.fixture
def one_thread():
    """torch on one thread for the test: its tensors are tiny, and a pool
    of threads on a busy host waits far longer than it works."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", GENERAL_CASES, ids=lambda v: str(v))
def test_bf16_general_grid_matches_jax(case):
    """The bf16 policy past RAD-NeRF's grids: the plain encode equal to
    JAX's packed bf16 encode op by op (from the float32 master and through
    the packed copy; 0 outside the box), the packing equal to JAX's
    build_packed_table(dtype=bfloat16) rows; the gradients against float64
    arithmetic on the same bf16 forward, within 1e-5 of the largest (JAX's
    op-by-op vjp of these grids takes 5-10 s each: the plain gradient is
    held to JAX at RAD-NeRF's D and channel counts above)."""
    C, interpolation, align_corners, D, L = case
    kw = dict(input_dim=D, num_levels=L, level_dim=C, base_resolution=_GENERAL_BASE[D],
              log2_hashmap_size=6, per_level_scale=2.0 ** (2 / (L - 1)),
              interpolation=interpolation, align_corners=align_corners)
    jspec, spec = JGridSpec.create(**kw), T.GridSpec.create(**kw)
    assert jspec.offsets == spec.offsets
    rng = np.random.default_rng(100 + 10 * D + L + C)
    n = 64
    emb = rng.normal(size=(spec.n_embeddings, C)).astype(np.float32)
    x = rng.uniform(-1.05, 1.05, (n, D)).astype(np.float32)
    x[0], x[1] = -1.0, 1.0
    x[2, 0] = 1.2  # outside -> zeros

    def encode(xj, ej):
        return grid_encode_packed(xj, build_packed_table(ej, jspec, jnp.bfloat16), jspec, 1.0)

    got = T.grid_encode(_T(x), _T(emb), spec, 1.0, table_dtype=BF16)
    tb = _T(emb).to(BF16)
    packed = T.pack_table(tb, spec)
    assert torch.equal(T.grid_encode(_T(x), tb, spec, 1.0, packed=packed).view(torch.int16),
                       got.view(torch.int16))
    assert np.all(got.float().numpy()[2] == 0.0)
    for level, jp in enumerate(build_packed_table(jnp.asarray(emb), jspec, jnp.bfloat16)):
        size = spec.level_size(level)
        want = np.asarray(jp.astype(jnp.float32))[:size].reshape(size, C, 1 << D)
        np.testing.assert_array_equal(
            packed[spec.offsets[level]:spec.offsets[level + 1]].float().numpy(),
            want.transpose(0, 2, 1))
    want = encode(jnp.asarray(x), jnp.asarray(emb))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the gradients against float64 arithmetic on the same bf16 forward
    g = _T(rng.normal(size=(n, L * C)).astype(np.float32)).to(BF16).float().numpy()
    xt, et = _T(x).requires_grad_(True), _T(emb).requires_grad_(True)
    (T.grid_encode(xt, et, spec, 1.0, table_dtype=BF16).float() * _T(g)).sum().backward()
    ref_t, ref_x = _float64_gradients(x, emb, g, spec)
    assert np.abs(et.grad.numpy() - ref_t).max() <= 1e-5 * np.abs(ref_t).max()
    assert np.abs(xt.grad.numpy() - ref_x).max() <= 1e-5 * np.abs(ref_x).max()


# the narrow head model at the JAX bench's 8x4 grid (bench.py:47-58): 8
# levels of 4 channels, 3-D and 2-D
GRID_8X4 = {**SMALL, "grid_levels": 8, "grid_ch": 4}


def _grid_8x4_params():
    """The 8x4 step's JAX pytree: the port's seeded init, the grid tables
    scaled to U(-1, 1), the sigma MLP's last layer x4."""
    from radnerf_tpu_torch.convert import network_to_jax
    from radnerf_tpu_torch.models import NeRFNetwork, NetworkConfig

    net = NeRFNetwork(NetworkConfig(**GRID_8X4), device="cpu",
                      generator=torch.Generator().manual_seed(24))
    assert net.cfg.grid_spec.level_dim == net.cfg.ambient_spec.level_dim == 4
    params = network_to_jax(net)
    for k in ("encoder", "encoder_ambient"):
        params[k] = params[k] * 1e4
    params["sigma_net"]["layers"][-1]["w"] = params["sigma_net"]["layers"][-1]["w"] * 4.0
    return params


def test_bf16_head_train_step_at_grid_8x4_matches_jax():
    """One -O head-stage step at grid 8x4 (tests/test_torch_bf16.py's step:
    the blob scene, 512 rays, the same noises) against JAX's jitted bf16
    step with XLA's excess precision off: the same telemetry, the loss to
    rel 1e-5, the gradients within that test's shares of each parameter's
    largest, each plus JAX's own move under excess precision (module
    docstring). The weights: the port's seeded init, the grid tables scaled
    to U(-1, 1) and the sigma MLP's last layer x4, so that they shape the
    field."""
    bf16_head_step_vs_jax(_grid_8x4_params(), GRID_8X4, with_jax_spread=True)


if __name__ == "__main__":
    # The module docstring's figures: the 8x4 step's loss in the port and in
    # JAX jitted (excess precision off and on) and op by op (~1 min of
    # per-primitive compiles), each relative to JAX's op-by-op loss:
    #     PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_bf16_variants.py
    jax.config.update("jax_platforms", "cpu")
    losses = {}
    bf16_head_step_vs_jax(_grid_8x4_params(), GRID_8X4, with_jax_spread=True, losses=losses)
    ref = losses["jax_op_by_op"]
    for name, value in losses.items():
        print(f"{name:26s} {value:.9f}  rel to JAX op by op {abs(value - ref) / ref:.3e}")
