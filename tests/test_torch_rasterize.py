"""The port's rasterizer and 3DMM renderer against the JAX package's, on
the CPU: ``rasterize_plain`` (kernel E's plain version) against
``_raster_hard`` run op by op (outside ``jit``: XLA:CPU contracts FMAs
inside it, which can move a pixel centre on an edge to the other side), on
meshes under JAX's candidate cap; ``rasterize_attributes``, ``Render3DMM``,
``vertex_normals`` and ``sh_irradiance``, values and gradients. Without JAX:
kernel E's trim (``_trimmed_ranges`` holds every covered centre) and the
binned study design's plain binning (``bin_triangles_plain``).

Tolerances: triangle ids are equal except where both winners have the same
depth (JAX takes the first in its candidate order, the port the lower id).
Interpolated values and gradients run the same float32 operations; the
gradients' scatter-adds and the einsums sum in other orders: 1e-5 of the
largest value (renderer 2e-5, its 255-scale colours).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.preprocess import render_3dmm as J

from radnerf_tpu_torch.ops import rasterize, rasterize_plain
from radnerf_tpu_torch.ops.rasterize import _covered_pairs
from radnerf_tpu_torch.studies.raster import bin_triangles_plain
from radnerf_tpu_torch.preprocess import render_3dmm as P

H = W = 48
# JAX's binning (integer work on floor(x / 16): exact under jit)
_bin = jax.jit(J._bin_triangles, static_argnums=(2, 3, 4, 5))


def _lattice(g, lo, hi):
    xs, ys = np.meshgrid(np.linspace(lo, hi, g), np.linspace(lo, hi, g), indexing="xy")
    tris = []
    for i in range(g - 1):
        for j in range(g - 1):
            a = i * g + j
            tris += [[a, a + g, a + 1], [a + 1, a + g, a + g + 1]]
    return np.stack([xs, ys], -1).reshape(-1, 2), np.asarray(tris, np.int32)


def _mesh(rng, B):
    """Two jittered lattices at different depths over a 48x48 frame (the
    second reaching past the border), one triangle repeated under another id
    (an exact depth tie), and in front a square on pixel centres split along
    its diagonal (edges through centres: w = 0 decides them)."""
    xy1, t1 = _lattice(9, 4.0, 44.0)
    xy2, t2 = _lattice(5, -6.0, 30.0)
    sq = np.array([[4.5, 26.5], [20.5, 26.5], [4.5, 42.5], [20.5, 42.5]])
    n = len(xy1) + len(xy2)
    tris = np.concatenate([t1, t2 + len(xy1), t1[10:11],
                           [[n, n + 1, n + 3], [n, n + 3, n + 2]]]).astype(np.int32)
    xy = np.stack([np.concatenate([xy1 + rng.normal(0, 0.8, xy1.shape),
                                   xy2 + rng.normal(0, 0.8, xy2.shape), sq])
                   for _ in range(B)]).astype(np.float32)
    z = np.concatenate([rng.uniform(2, 3, (B, len(xy1))),
                        rng.uniform(1, 4, (B, len(xy2))), np.full((B, 4), 0.5)],
                       1).astype(np.float32)
    return xy, z, tris


def _zp(xy, z, tris, tri, i, j):
    """Depth of triangle ``tri`` at pixel (i, j) in the rasterizer's float32
    expressions."""
    xy, z = torch.from_numpy(xy), torch.from_numpy(z)
    v = torch.from_numpy(tris[tri]).long()
    p0, p1, p2 = xy[v[0]], xy[v[1]], xy[v[2]]
    e1, e2 = p1 - p0, p2 - p0
    den = e1[0] * e2[1] - e1[1] * e2[0]
    dx, dy = torch.tensor(j + 0.5) - p0[0], torch.tensor(i + 0.5) - p0[1]
    w1 = (dx * e2[1] - dy * e2[0]) / den
    w2 = (e1[0] * dy - e1[1] * dx) / den
    w0 = 1.0 - w1 - w2
    return float(w0 * z[v[0]] + w1 * z[v[1]] + w2 * z[v[2]])


def _jax_raster(xy, z, tris, tile=16, K=128, h=H, w=W):
    """JAX's rasterizer op by op, one frame at a time."""
    return np.stack([np.asarray(J._raster_hard(jnp.asarray(xy[b]), jnp.asarray(z[b]),
                                               jnp.asarray(tris), h, w, tile, K))
                     for b in range(xy.shape[0])])


def test_rasterize_plain_matches_jax_op_by_op():
    rng = np.random.default_rng(0)
    xy, z, tris = _mesh(rng, 3)
    # the mesh stays under JAX's cap: no tile holds more than K = 128
    # candidates, and no triangle spans more than 2 tiles along an axis
    for b in range(3):
        cand = np.asarray(_bin(jnp.asarray(xy[b]), jnp.asarray(tris), H, W, 16, 128))
        assert (cand >= 0).sum(1).max() < 128
        p = xy[b][tris]
        span = np.floor(p.max(1) / 16) - np.floor(p.min(1) / 16)
        assert span.max() <= 1
    want = _jax_raster(xy, z, tris)
    got = rasterize_plain(torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(tris),
                          H, W).numpy()
    assert got.dtype == np.int32 and got.shape == (3, H, W)
    assert (want >= 0).mean() > 0.5
    differ = np.argwhere(got != want)
    for b, i, j in differ:
        assert got[b, i, j] >= 0 and want[b, i, j] >= 0
        assert _zp(xy[b], z[b], tris, got[b, i, j], i, j) == \
            _zp(xy[b], z[b], tris, want[b, i, j], i, j)
    # the repeated triangle ties with its twin: the lower id wins; the square
    # covers its edges' centres (17 x 17 pixels, the diagonal's tie to the
    # lower id)
    assert not (got == 160).any() and (got == 10).any()
    square = got[:, 26:43, 4:21]
    assert np.isin(square, [161, 162]).all()
    assert (np.diagonal(square, axis1=1, axis2=2) == 161).all()
    # the wrapper runs the plain version on CPU tensors
    assert np.array_equal(rasterize(torch.from_numpy(xy), torch.from_numpy(z),
                                    torch.from_numpy(tris), H, W).numpy(), got)


def test_rasterize_plain_matches_jax_on_a_frame_off_the_tiles():
    """A 41 x 43 frame, a multiple of no tile side, with the mesh reaching
    past its last row and column: JAX pads its 16x16 tiles to 48 x 48 and
    crops; the port's plain version tests the same centres."""
    h, w = 41, 43
    rng = np.random.default_rng(5)
    xy, z, tris = _mesh(rng, 2)
    for b in range(2):
        cand = np.asarray(_bin(jnp.asarray(xy[b]), jnp.asarray(tris), h, w, 16, 128))
        assert (cand >= 0).sum(1).max() < 128
    want = _jax_raster(xy, z, tris, h=h, w=w)
    got = rasterize_plain(torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(tris),
                          h, w).numpy()
    assert got.shape == (2, h, w) and (want >= 0).mean() > 0.5
    # the mesh reaches the last row and column
    assert (want[:, -1] >= 0).any() and (want[:, :, -1] >= 0).any()
    for b, i, j in np.argwhere(got != want):
        assert got[b, i, j] >= 0 and want[b, i, j] >= 0
        assert _zp(xy[b], z[b], tris, got[b, i, j], i, j) == \
            _zp(xy[b], z[b], tris, want[b, i, j], i, j)


def _edge_mesh(rng, n):
    """n small triangles whose bounding boxes end within a few float32 ulps
    of pixel centres (the trim's closest calls), some with vertices on pixel
    centres; n slivers, a vertex within 1e-6 (relative) of the line through
    the other two; and large triangles reaching past the frame."""
    c = rng.integers(4, 40, (n, 1, 2)).astype(np.float64) + 0.5
    tiny = rng.integers(-3, 4, (n, 3, 2)) * 2.0**-19
    small = c + rng.uniform(-1.2, 1.2, (n, 3, 2)) * rng.choice([1.0, 0.0], (n, 3, 2)) + tiny
    sliver = c + np.stack([np.zeros((n, 2)), rng.uniform(2, 9, (n, 2)),
                           rng.uniform(2, 9, (n, 2))], 1)
    sliver[:, 2] = sliver[:, 1] * (1 + rng.choice([1e-7, 3e-7, 1e-6], (n, 1))) \
        - sliver[:, 0] * rng.choice([1e-7, 3e-7, 1e-6], (n, 1))
    big = rng.uniform(-20, 70, (n // 8, 3, 2))
    xy = np.concatenate([small, sliver, big]).reshape(1, -1, 2).astype(np.float32)
    tris = np.arange(xy.shape[1]).reshape(-1, 3).astype(np.int32)
    z = rng.uniform(1, 3, (1, xy.shape[1])).astype(np.float32)
    return xy, z, tris


@pytest.mark.parametrize("mesh", ["lattice", "edges"])
def test_trimmed_ranges_hold_every_covered_centre(mesh):
    """Kernel E's trim drops margin rows and columns of the window: every
    covered (pixel, triangle) pair of the untrimmed window lies inside the
    trimmed one; on the lattice (triangles of ~5 px, whose margins are ~40%
    of their windows) the trim leaves under 70% of the centres."""
    from radnerf_tpu_torch.ops.rasterize import _pixel_ranges, _trimmed_ranges

    rng = np.random.default_rng(7)
    xy, z, tris = _mesh(rng, 2) if mesh == "lattice" else _edge_mesh(rng, 3000)
    xy_t, z_t, tris_t = torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(tris)
    i0, i1, j0, j1 = _trimmed_ranges(xy_t, tris_t, H, W)
    pairs = 0
    for b, pix, key in _covered_pairs(xy_t, z_t, tris_t, H, W):
        t = key & 0xFFFFFFFF
        pi, pj = pix // W, pix % W
        assert ((pi >= i0[b, t]) & (pi <= i1[b, t]) & (pj >= j0[b, t]) & (pj <= j1[b, t])).all()
        pairs += pix.numel()
    assert pairs > 1000
    f0, f1, g0, g1 = _pixel_ranges(xy_t, tris_t.long(), H, W)
    full = ((f1 - f0 + 1).clamp_min(0) * (g1 - g0 + 1).clamp_min(0)).sum()
    kept = ((i1 - i0 + 1).clamp_min(0) * (j1 - j0 + 1).clamp_min(0)).sum()
    assert kept < full
    if mesh == "lattice":
        assert kept < 0.7 * full


@pytest.mark.parametrize("tile", [16, 32])
def test_bin_triangles_plain_lists_every_covered_pair(tile):
    """The binned design's binning (``studies/raster_binned.cu``), plain
    version, on a 45 x 80 frame: every covered (pixel, triangle) pair of
    ``_covered_pairs`` has its triangle in the pixel's tile list or in its
    frame's wide list; a triangle off the image and a degenerate one are in
    no list; a triangle wider than 2x2 tiles is in the wide list; no list
    holds a triangle twice."""
    h, w = 45, 80
    rng = np.random.default_rng(6)
    xy, z, tris = _mesh(rng, 2)
    V = xy.shape[1]
    extra = np.array([[[90.0, 5.0], [99.0, 5.0], [95.0, 9.0]],  # off the image
                      [[1.0, 1.0], [75.0, 2.0], [3.0, 43.0]],  # over 3 tiles a row
                      [[5.0, 5.0], [5.0, 5.0], [9.0, 9.0]]], np.float32)  # degenerate
    xy = np.concatenate([xy, np.broadcast_to(extra.reshape(1, 9, 2), (2, 9, 2))], 1)
    z = np.concatenate([z, np.full((2, 9), 3.0, np.float32)], 1)
    tris = np.concatenate([tris, V + np.arange(9).reshape(3, 3)]).astype(np.int32)
    T = len(tris)
    off, big, flat = T - 3, T - 2, T - 1
    xy_t, z_t, tris_t = torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(tris)
    keys = bin_triangles_plain(xy_t, tris_t, h, w, tile)
    n_tx = -(-w // tile)
    n_tiles = n_tx * -(-h // tile)
    assert torch.equal(torch.unique(keys), keys)
    t = keys % T
    assert not torch.isin(t, torch.tensor([off, flat])).any()
    wide = (keys // T) % (n_tiles + 1) == n_tiles
    assert set(t[wide].tolist()) == {big}
    pairs = 0
    for b, pix, key in _covered_pairs(xy_t, z_t, tris_t, h, w):
        tri = key & 0xFFFFFFFF
        k = (pix // w // tile) * n_tx + (pix % w) // tile
        listed = ((b * (n_tiles + 1) + k) * T + tri, (b * (n_tiles + 1) + n_tiles) * T + tri)
        assert (torch.isin(listed[0], keys) | torch.isin(listed[1], keys)).all()
        pairs += pix.numel()
    assert pairs > h * w


def _raster_f32(xy, z, tris):
    """A float32 numpy z-buffer over every pixel of every triangle, in the
    rasterizer's expressions (no binning): the oracle of no drops."""
    out = np.full((H, W), -1, np.int64)
    zbuf = np.full((H, W), np.inf, np.float32)
    jj, ii = np.meshgrid(np.arange(W), np.arange(H))
    px, py = jj.astype(np.float32) + np.float32(0.5), ii.astype(np.float32) + np.float32(0.5)
    for t, v in enumerate(tris):
        p0, p1, p2 = xy[v]
        e1, e2 = p1 - p0, p2 - p0
        den = e1[0] * e2[1] - e1[1] * e2[0]
        if not abs(den) > np.float32(1e-12):
            continue
        dx, dy = px - p0[0], py - p0[1]
        w1 = (dx * e2[1] - dy * e2[0]) / den
        w2 = (e1[0] * dy - e1[1] * dx) / den
        w0 = np.float32(1.0) - w1 - w2
        zp = w0 * z[v[0]] + w1 * z[v[1]] + w2 * z[v[2]]
        win = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (zp < zbuf)
        zbuf[win], out[win] = zp[win], t
    return out


def test_rasterize_plain_drops_nothing():
    """A tile with more than K = 128 candidates and a triangle over 3 tiles:
    JAX's binning drops candidates there; the port equals a z-buffer over
    every triangle."""
    rng = np.random.default_rng(1)
    xy1, t1 = _lattice(13, 1.0, 15.0)  # 288 small triangles in tile (0, 0)
    big = np.array([[2.0, 2.0], [46.0, 5.0], [6.0, 45.0]])
    xy = np.concatenate([xy1 + rng.normal(0, 0.2, xy1.shape), big]).astype(np.float32)
    tris = np.concatenate([t1, [[len(xy1), len(xy1) + 1, len(xy1) + 2]]]).astype(np.int32)
    z = np.concatenate([rng.uniform(1, 2, len(xy1)), [0.5, 0.5, 0.5]]).astype(np.float32)
    got = rasterize_plain(torch.from_numpy(xy)[None], torch.from_numpy(z)[None],
                          torch.from_numpy(tris), H, W).numpy()[0]
    assert np.array_equal(got, _raster_f32(xy, z, tris))
    # what JAX keeps: 128 of tile (0, 0)'s candidates, and the big triangle
    # in 2x2 of the 3x3 tiles it spans
    cand = np.asarray(_bin(jnp.asarray(xy), jnp.asarray(tris), H, W, 16, 128))
    assert (cand[0] >= 0).sum() == 128 and not (cand[[2, 5, 6, 7, 8]] == len(tris) - 1).any()
    assert (got == len(tris) - 1).sum() > 900


@pytest.mark.parametrize("bad", [-1, 3])
def test_rasterize_refuses_vertex_index_out_of_range(bad):
    """A triangle naming a vertex outside [0, V) raises ValueError before any
    pixel is tested (negative indices would wrap round in the plain version,
    and read out of bounds in E): in ``rasterize`` given host triangles, and
    in ``Render3DMM``, which checks its triangles once on their device."""
    xy = torch.tensor([[[2.0, 2.0], [40.0, 3.0], [5.0, 40.0]]])
    z = torch.ones(1, 3)
    assert (rasterize(xy, z, torch.tensor([[0, 1, 2]]), H, W) >= 0).any()
    tris = np.array([[0, 1, 2], [0, bad, 2]], np.int32)
    with pytest.raises(ValueError, match="outside 0..2"):
        rasterize(xy, z, torch.from_numpy(tris), H, W)
    geo = torch.tensor([[[-0.5, -0.5, -3.0], [0.5, -0.5, -3.0], [0.0, 0.5, -3.0]]])
    with pytest.raises(ValueError, match="outside 0..2"):
        P.Render3DMM(60.0, H, W, tris)(geo, torch.full((1, 3, 3), 128.0), torch.zeros(1, 27))


def _scene(rng, B=2):
    xy, z, tris = _mesh(rng, B)
    attrs = rng.uniform(0, 1, (B, xy.shape[1], 3)).astype(np.float32)
    wts = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    return xy, z, tris, attrs, wts


def _fixed_visibility(monkeypatch, xy, z, tris):
    """JAX's visibility of each frame op by op, then handed to its jitted
    renderer in place of ``_raster_hard`` (picked by the frame's first
    vertex), so that XLA's FMAs inside jit move no edge pixel."""
    ids = jnp.asarray(_jax_raster(xy, z, tris))
    keys = jnp.asarray(xy[:, 0, 0])
    monkeypatch.setattr(J, "_raster_hard",
                        lambda p, *a: ids[jnp.argmin(jnp.abs(keys - p[0, 0]))])


def test_rasterize_attributes_values_and_gradients(monkeypatch):
    rng = np.random.default_rng(2)
    xy, z, tris, attrs, wts = _scene(rng)
    _fixed_visibility(monkeypatch, xy, z, tris)

    @jax.jit
    def j_loss(xy_j, at_j):
        img = jax.vmap(lambda a, b, c: J.rasterize_attributes(a, b, c, jnp.asarray(tris),
                                                              H, W)[0])(xy_j, jnp.asarray(z), at_j)
        return jnp.sum(img * wts), img

    (_, img_j), (gx_j, ga_j) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(xy), jnp.asarray(attrs))
    xy_t = torch.from_numpy(xy).requires_grad_(True)
    at_t = torch.from_numpy(attrs).requires_grad_(True)
    img, mask = P.rasterize_attributes(xy_t, torch.from_numpy(z), at_t, tris, H, W)
    (img * torch.from_numpy(wts)).sum().backward()
    img_j = np.asarray(img_j)
    assert mask.shape == (2, H, W) and mask.float().mean() > 0.5
    np.testing.assert_allclose(img.detach().numpy(), img_j, atol=1e-5 * np.abs(img_j).max())
    for got, want in ((xy_t.grad, gx_j), (at_t.grad, ga_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def _unproject(xy, z, focal):
    """Camera-space vertices whose projection (u = f x / z + W / 2,
    v = -f y / z + H / 2, depth -z) is (xy, z)."""
    x = (xy[..., 0] - W / 2.0) * z / focal
    y = -(xy[..., 1] - H / 2.0) * z / focal
    return np.stack([x, y, -z], -1).astype(np.float32)


def test_render3dmm_values_and_gradients(monkeypatch):
    """``Render3DMM`` on the rasterizer test's mesh lifted into camera
    space: normals, SH light, projection, interpolation, the clip."""
    rng = np.random.default_rng(3)
    B, focal = 2, 110.0
    xy, z, tris = _mesh(rng, B)
    geo = _unproject(xy, z, focal)
    tex = rng.uniform(60, 200, (B, geo.shape[1], 3)).astype(np.float32)
    gamma = (rng.normal(size=(B, 27)) * 0.3).astype(np.float32)
    wts = rng.normal(size=(B, H, W, 4)).astype(np.float32)
    rj = J.Render3DMM(focal, H, W, tris)
    rp = P.Render3DMM(focal, H, W, tris)
    xy_j, z_j = rj.project(jnp.asarray(geo))
    _fixed_visibility(monkeypatch, np.asarray(xy_j), np.asarray(z_j), tris)

    @jax.jit
    def j_loss(g, t, l):
        out = rj(g, t, l)
        return jnp.sum(out * wts), out

    (_, out_j), grads_j = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(geo), jnp.asarray(tex), jnp.asarray(gamma))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (geo, tex, gamma)]
    out = rp(*ins)
    (out * torch.from_numpy(wts)).sum().backward()
    out_j = np.asarray(out_j)
    assert out.shape == (B, H, W, 4) and out_j[..., 3].mean() > 0.5
    np.testing.assert_array_equal(out[..., 3].detach().numpy(), out_j[..., 3])
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=2e-5 * 255)
    for got, want in zip(ins, grads_j):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, atol=2e-5 * np.abs(want).max())


def test_vertex_normals_and_sh_irradiance():
    rng = np.random.default_rng(4)
    xy, z, tris = _mesh(rng, 3)
    geo = _unproject(xy, z, 110.0)
    gamma = rng.normal(size=(3, 27)).astype(np.float32)
    vn_j = np.asarray(jax.jit(J.vertex_normals)(jnp.asarray(geo), jnp.asarray(tris)))
    vn = P.vertex_normals(torch.from_numpy(geo), tris)
    np.testing.assert_allclose(vn.numpy(), vn_j, atol=1e-6)
    lit_j = np.asarray(jax.jit(J.sh_irradiance)(jnp.asarray(vn_j), jnp.asarray(gamma)))
    lit = P.sh_irradiance(torch.from_numpy(vn_j), torch.from_numpy(gamma))
    np.testing.assert_allclose(lit.numpy(), lit_j, atol=1e-5 * np.abs(lit_j).max())
    # forward_geo / forward_tex on a seeded basis
    V = geo.shape[1]
    mesh = P.MeshBasis(geo[0], rng.normal(size=(V, 3, 4)).astype(np.float32),
                       rng.normal(size=(V, 3, 3)).astype(np.float32),
                       rng.uniform(0, 255, (V, 3)).astype(np.float32),
                       rng.normal(size=(V, 3, 5)).astype(np.float32), tris)
    ids, exp, tex = (rng.normal(size=(3, n)).astype(np.float32) for n in (4, 3, 5))
    for fj, fp, args in ((J.forward_geo, P.forward_geo, (ids, exp)),
                         (J.forward_tex, P.forward_tex, (tex,))):
        want = np.asarray(fj(mesh, *map(jnp.asarray, args)))
        got = fp(mesh, *map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def jax_cap_drops(frames=(0, 21, 42)):
    """What JAX's binning drops at the reference's mesh density: chip_smoke's
    synthetic BFM-size mesh (34,650 vertices, 68,556 triangles) posed as its
    frames are, at 512x512 and focal 1100, binned by ``_bin_triangles``
    (K large enough to keep everything, to count) and rasterized by
    ``_raster_hard`` at its defaults (tile 16, K = 128, jitted) against
    ``rasterize_plain``. From the repository root: ``PYTHONPATH=. python
    tests/test_torch_rasterize.py``."""
    import sys
    import tempfile
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from radnerf_tpu_torch.preprocess import face_tracker as PT

    binned = jax.jit(J._bin_triangles, static_argnums=(2, 3, 4, 5))
    raster = jax.jit(J._raster_hard, static_argnums=(3, 4, 5, 6))
    with tempfile.TemporaryDirectory() as root:
        paths = chip_smoke.synthetic_3dmm(root)
        mesh = P.mesh_basis_from_file(paths["3DMM"], paths["topology"], paths["keys"])
    truth = {k: torch.from_numpy(v) for k, v in chip_smoke.synthetic_truth(
        np.random.default_rng(1), chip_smoke.PRE_FRAMES).items()}
    size = chip_smoke.PRE_SIZE
    for f in frames:
        geo = P.forward_geo(mesh, truth["id"], truth["exp"][f:f + 1])
        cam = torch.einsum("nij,nkj->nki", PT.euler_rot(truth["euler"][f:f + 1]), geo) \
            + truth["trans"][f:f + 1, None]
        xy, z = P.Render3DMM(chip_smoke.PRE_FOCAL, size, size, mesh.tris).project(cam)
        args = jnp.asarray(xy[0].numpy()), jnp.asarray(z[0].numpy()), jnp.asarray(mesh.tris)
        n = (np.asarray(binned(args[0], args[2], size, size, 16, 4096)) >= 0).sum(1)
        capped = np.asarray(raster(*args, size, size, 16, 128))
        full = rasterize_plain(xy, z, torch.from_numpy(mesh.tris), size, size)[0].numpy()
        print({"frame": f, "tiles_over_K": int((n > 128).sum()), "tiles_with_candidates":
               int((n > 0).sum()), "max_candidates": int(n.max()), "candidates": int(n.sum()),
               "candidates_dropped": int(np.maximum(n - 128, 0).sum()),
               "pixels_covered": int((full >= 0).sum()),
               "pixels_lost_by_jax": int(((capped < 0) & (full >= 0)).sum())})


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax_cap_drops()
