"""Hard z-buffer rasterization: the covering triangle of least depth at
each pixel centre, for a batch of frames.

Counterpart of ``radnerf_tpu/preprocess/render_3dmm.py`` ``_raster_hard``
(:218) with ``_bin_triangles`` (:172), the visibility pass of the 3DMM
renderer. ``rasterize`` is the wrapper of kernel E (``csrc/rasterize.cu``):
on CUDA tensors it launches the kernel, on CPU tensors it runs
``rasterize_plain``.

Both decide a pixel as JAX does, in its float32 expressions and order:
``e1 = p1 - p0``, ``e2 = p2 - p0``, ``den = cross(e1, e2)``, ``d = pix -
p0``, ``w1 = cross(d, e2) / den``, ``w2 = cross(e1, d) / den``, ``w0 = 1 -
w1 - w2``; covered when ``w0, w1, w2 >= 0`` and ``|den| > 1e-12``; depth
``zp = w0 z0 + w1 z1 + w2 z2`` summed left to right. The least ``zp`` wins,
and at equal ``zp`` the lower triangle id (JAX takes the first in its
candidate order, tile by tile, so at an exact tie the two may pick
different triangles of the same depth). Neither drops a triangle: JAX keeps
at most K = 128 candidates a tile and bins a triangle into at most 2x2
tiles, and drops the rest.
"""

from __future__ import annotations

import torch

from ._kernels import KERNELS, refuse_grad, require_cuda_tensors

# (pixel, triangle) pairs the plain version tests at once
_PAIRS_PER_CHUNK = 1 << 22


def _pixel_ranges(xy, tris, H, W):
    """Per (frame, triangle): the rows and columns of the pixel centres
    within one pixel of the triangle's bounding box, clipped to the image
    (kernel E's range; the margin takes in a centre that the rounded tests
    may put inside although it lies an ulp outside the box). Returns
    (i0, i1, j0, j1) int64 [B, T], empty where i0 > i1 or j0 > j1."""
    p = xy[:, tris]  # [B, T, 3, 2]
    lo, hi = p.amin(dim=2), p.amax(dim=2)
    j0 = torch.clamp_min(torch.ceil(lo[..., 0] - 0.5) - 1.0, 0.0)
    j1 = torch.clamp_max(torch.floor(hi[..., 0] - 0.5) + 1.0, float(W - 1))
    i0 = torch.clamp_min(torch.ceil(lo[..., 1] - 0.5) - 1.0, 0.0)
    i1 = torch.clamp_max(torch.floor(hi[..., 1] - 0.5) + 1.0, float(H - 1))
    # NaN bounds and ranges off the image become empty before the cast
    empty = ~((j0 <= j1) & (i0 <= i1))
    rng = [torch.where(empty, torch.zeros_like(v), v).long() for v in (i0, i1, j0, j1)]
    rng[1] = torch.where(empty, rng[0] - 1, rng[1])
    return tuple(rng)


def _ordered_key(zp: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """(order-preserving bits of zp) << 32 | tri as int64 whose signed order
    is kernel E's unsigned order (the top half shifted by 2^31)."""
    u = zp.view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return ((u - 0x80000000) << 32) | tri


def _covered_pairs(xy, z, tris, H, W):
    """Every (pixel, triangle) pair kernel E tests, frame by frame in chunks
    of at most _PAIRS_PER_CHUNK pairs (at least one triangle a chunk):
    yields (frame, pixel index, key) of the covered pairs."""
    tris = tris.long()
    i0, i1, j0, j1 = _pixel_ranges(xy, tris, H, W)
    widths = j1 - j0 + 1
    counts = (i1 - i0 + 1).clamp_min(0) * widths.clamp_min(0)
    T = tris.shape[0]
    for b in range(xy.shape[0]):
        ends = torch.cumsum(counts[b], 0)
        lo_t = 0
        while lo_t < T and int(ends[-1]) > 0:
            base = int(ends[lo_t - 1]) if lo_t else 0
            hi_t = int(torch.searchsorted(ends, base + _PAIRS_PER_CHUNK, right=True))
            hi_t = max(hi_t, lo_t + 1)
            t = torch.arange(lo_t, hi_t, device=xy.device)
            c = counts[b, lo_t:hi_t]
            lo_t = hi_t
            tt = torch.repeat_interleave(t, c)
            if tt.numel() == 0:
                continue
            start = torch.cumsum(c, 0) - c
            off = torch.arange(tt.shape[0], device=xy.device) - torch.repeat_interleave(start, c)
            w = widths[b, tt]
            pi = i0[b, tt] + off // w
            pj = j0[b, tt] + off % w
            v = tris[tt]
            p0, p1, p2 = xy[b, v[:, 0]], xy[b, v[:, 1]], xy[b, v[:, 2]]
            e1, e2 = p1 - p0, p2 - p0
            den = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
            den_ = torch.where(den == 0, torch.ones_like(den), den)
            dx = (pj.float() + 0.5) - p0[:, 0]
            dy = (pi.float() + 0.5) - p0[:, 1]
            w1 = (dx * e2[:, 1] - dy * e2[:, 0]) / den_
            w2 = (e1[:, 0] * dy - e1[:, 1] * dx) / den_
            w0 = 1.0 - w1 - w2
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (den.abs() > 1e-12)
            zv = z[b, v]
            zp = w0 * zv[:, 0] + w1 * zv[:, 1] + w2 * zv[:, 2]
            yield b, (pi * W + pj)[inside], _ordered_key(zp[inside], tt[inside])


def rasterize_plain(xy: torch.Tensor, z: torch.Tensor, tris: torch.Tensor,
                    H: int, W: int) -> torch.Tensor:
    """Plain version of ``rasterize``: every (pixel, triangle) pair that
    kernel E tests is tested in chunks, frame by frame, and the (depth, id)
    keys of the covered ones are reduced by ``scatter_reduce(amin)``."""
    B = xy.shape[0]
    empty_key = torch.iinfo(torch.int64).max
    zbuf = torch.full((B, H * W), empty_key, dtype=torch.int64, device=xy.device)
    for b, pix, key in _covered_pairs(xy, z, tris, H, W):
        zbuf[b].scatter_reduce_(0, pix, key, "amin")
    hit = zbuf != empty_key
    out = torch.where(hit, zbuf & 0xFFFFFFFF, torch.full_like(zbuf, -1)).int()
    return out.view(B, H, W)


def check_triangles(tris: torch.Tensor, n_verts: int) -> None:
    """Raise ValueError unless every vertex index of tris lies in
    [0, n_verts)."""
    if tris.numel():
        lo, hi = (int(v) for v in torch.aminmax(tris))
        if lo < 0 or hi >= n_verts:
            raise ValueError(f"tris index vertices {lo}..{hi}, outside 0..{n_verts - 1}")


def rasterize(xy: torch.Tensor, z: torch.Tensor, tris: torch.Tensor,
              H: int, W: int) -> torch.Tensor:
    """Per-pixel covering triangle of least depth: kernel E on CUDA tensors,
    ``rasterize_plain`` on CPU tensors. xy [B, V, 2] float32 screen
    positions (pixel (i, j) has its centre at (j + 0.5, i + 0.5)), z [B, V]
    float32 positive depth, tris [T, 3] integer -> tri_id [B, H, W] int32,
    -1 where no triangle covers the centre. Visibility has no gradient: an
    input that requires grad raises on the card (callers pass detached
    positions). Triangles on the host are checked: a vertex index outside
    [0, V) raises ValueError (they come from a user's topology file; the
    kernel would read out of bounds). Triangles already on the card are the
    caller's to check once (``check_triangles``; ``Render3DMM`` does), since
    reading their range back would stall every call."""
    if xy.dim() != 3 or xy.shape[-1] != 2 or z.shape != xy.shape[:2]:
        raise ValueError(f"xy must be [B, V, 2] and z [B, V], got {tuple(xy.shape)}, "
                         f"{tuple(z.shape)}")
    if tris.device.type == "cpu":
        check_triangles(tris, xy.shape[1])
    if xy.device.type == "cpu":
        return rasterize_plain(xy, z, tris, H, W)
    if xy.dtype != torch.float32 or z.dtype != torch.float32:
        raise ValueError("kernel E takes float32 xy and z")
    refuse_grad("kernel E", xy=xy, z=z)
    xy, z = xy.contiguous(), z.contiguous()
    tris = tris.to(device=xy.device, dtype=torch.int32).contiguous()
    require_cuda_tensors(xy, z, tris)
    B, V = xy.shape[:2]
    T = tris.shape[0]
    if V >= 2**31 or 3 * T >= 2**31:
        raise ValueError("kernel E takes fewer than 2^31 vertices and 2^31 / 3 triangles "
                         "(32-bit indices into tris)")
    zbuf = torch.empty((B, H, W), dtype=torch.int64, device=xy.device)
    tri_id = torch.empty((B, H, W), dtype=torch.int32, device=xy.device)
    if B * H * W > 0:
        KERNELS["rasterize"].launch(
            "rasterize_fwd", xy.device, xy.data_ptr(), z.data_ptr(), tris.data_ptr(),
            zbuf.data_ptr(), tri_id.data_ptr(), B, V, T, H, W)
    return tri_id
