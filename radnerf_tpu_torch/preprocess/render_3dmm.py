"""Differentiable 3DMM mesh renderer for the photometric tracking stage
(counterpart of ``radnerf_tpu/preprocess/render_3dmm.py``; reference
data_utils/face_tracking/render_3dmm.py).

Deferred visibility, as in JAX: the covering triangle of each pixel comes
from kernel E (``ops.rasterize``, a z-buffer on the card) on detached
positions, and the barycentrics are derived again under autograd from the
projected vertices to interpolate the vertex attributes, so gradients reach
geometry, texture and lighting through the interior shading; visibility
edges carry none. Everything is batched over frames on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.rasterize import check_triangles, rasterize


# ------------------------------------------------------------------ geometry
@dataclasses.dataclass
class MeshBasis:
    """Full-vertex 3DMM: verts = mean + id_base @ id + exp_base @ exp;
    per-vertex albedo tex = tex_mean + tex_base @ tex (0..255, as the BFM).

    mean [V, 3]; id_base [V, 3, id]; exp_base [V, 3, exp]; tex_mean [V, 3];
    tex_base [V, 3, tex]; tris [T, 3]; rigid_ids: the vertices of the
    temporal laplacian (optional). Arrays are numpy, or tensors after
    ``to(device)``.
    """

    mean: np.ndarray
    id_base: np.ndarray
    exp_base: np.ndarray
    tex_mean: np.ndarray
    tex_base: np.ndarray
    tris: np.ndarray
    rigid_ids: Optional[np.ndarray] = None

    @property
    def id_dim(self):
        return self.id_base.shape[-1]

    @property
    def exp_dim(self):
        return self.exp_base.shape[-1]

    @property
    def tex_dim(self):
        return self.tex_base.shape[-1]

    def to(self, device) -> "MeshBasis":
        """The basis as float32 tensors (tris and rigid_ids int64) on device."""
        def f(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        def i(a):
            return None if a is None else torch.as_tensor(a, dtype=torch.int64, device=device)
        return MeshBasis(f(self.mean), f(self.id_base), f(self.exp_base), f(self.tex_mean),
                         f(self.tex_base), i(self.tris), i(self.rigid_ids))


def mesh_basis_from_file(info_path: str, topology_path: str,
                         keys_path: Optional[str] = None,
                         id_dim: int = 100, exp_dim: int = 79,
                         tex_dim: int = 100) -> MeshBasis:
    """A MeshBasis from the reference's ``3DMM_info.npy`` + ``topology_info.npy``
    (tris) [+ ``keys_info.npy`` for rigid_ids] (convert_BFM.py /
    facemodel.py:15-47 formats; sigma folded into the bases so unit-scale
    parameters match the reference's ``para * sig``)."""
    info = np.load(info_path, allow_pickle=True).item()
    topo = np.load(topology_path, allow_pickle=True).item()

    mu = (np.asarray(info["mu_shape"]) + np.asarray(info["mu_exp"])).reshape(-1, 3)
    mu = mu - mu.mean(axis=0, keepdims=True)
    mu = (mu / 100000.0).astype(np.float32)
    V = mu.shape[0]

    def _base(b, sig, dim, scale):
        b = np.asarray(b)[:dim].reshape(dim, V, 3) / scale
        b = b * np.asarray(sig)[:dim, None, None]
        return np.transpose(b, (1, 2, 0)).astype(np.float32)

    rigid = None
    if keys_path is not None:
        keys = np.load(keys_path, allow_pickle=True).item()
        rigid = np.asarray(keys.get("rigid_ids"))
    return MeshBasis(
        mean=mu,
        id_base=_base(info["b_shape"], info["sig_shape"], id_dim, 1e5),
        exp_base=_base(info["b_exp"], info["sig_exp"], exp_dim, 1e5),
        tex_mean=np.asarray(info["mu_tex"], np.float32).reshape(V, 3),
        tex_base=_base(info["b_tex"], info["sig_tex"], tex_dim, 1.0),
        tris=np.asarray(topo["tris"], np.int32),
        rigid_ids=rigid,
    )


def _on(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def forward_geo(basis: MeshBasis, ids: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """[B, id_dim], [B, exp_dim] -> camera-free vertices [B, V, 3]."""
    return (_on(basis.mean, ids)[None]
            + torch.einsum("vdi,bi->bvd", _on(basis.id_base, ids), ids)
            + torch.einsum("vdi,bi->bvd", _on(basis.exp_base, ids), exp))


def forward_tex(basis: MeshBasis, tex: torch.Tensor) -> torch.Tensor:
    """[B, tex_dim] -> per-vertex albedo [B, V, 3] (0..255)."""
    return _on(basis.tex_mean, tex)[None] + torch.einsum(
        "vdi,bi->bvd", _on(basis.tex_base, tex), tex)


def vertex_normals(verts: torch.Tensor, tris) -> torch.Tensor:
    """Area-weighted vertex normals [B, V, 3] (render_3dmm.py:103-111): each
    triangle's unit normal added into its three vertices by ``index_add``
    (on the card in no fixed order), then normalised."""
    tris = torch.as_tensor(tris, device=verts.device).long()
    p0, p1, p2 = verts[:, tris[:, 0]], verts[:, tris[:, 1]], verts[:, tris[:, 2]]
    tn = torch.linalg.cross(p1 - p0, p2 - p0)
    tn = tn / (torch.linalg.vector_norm(tn, dim=-1, keepdim=True) + 1e-12)
    flat = torch.cat([tris[:, 0], tris[:, 1], tris[:, 2]], 0)
    vn = verts.new_zeros(verts.shape).index_add(1, flat, torch.cat([tn, tn, tn], 1))
    return vn / (torch.linalg.vector_norm(vn, dim=-1, keepdim=True) + 1e-12)


# ------------------------------------------------------------------ lighting
_A = (np.pi, 2 * np.pi / np.sqrt(3.0), 2 * np.pi / np.sqrt(8.0))
_C = (1 / np.sqrt(4 * np.pi), np.sqrt(3.0) / np.sqrt(4 * np.pi),
      3 * np.sqrt(5.0) / np.sqrt(12 * np.pi))
_D0 = 0.5 / np.sqrt(3.0)


def sh_irradiance(normals: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """9-band SH lighting (render_3dmm.py:151-189): normals [B, V, 3],
    gamma [B, 27] (3 channels x 9 coefficients, +0.8 ambient on band 0) ->
    per-vertex RGB lighting [B, V, 3]."""
    g = gamma.reshape(-1, 3, 9)
    g = g + g.new_tensor([0.8] + [0.0] * 8)
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    a0, a1, a2 = (float(a) for a in _A)
    c0, c1, c2 = (float(c) for c in _C)
    Y = torch.stack([
        torch.full_like(nx, a0 * c0),
        -a1 * c1 * ny,
        a1 * c1 * nz,
        -a1 * c1 * nx,
        a2 * c2 * nx * ny,
        -a2 * c2 * ny * nz,
        a2 * c2 * float(_D0) * (3 * nz**2 - 1),
        -a2 * c2 * nx * nz,
        a2 * c2 * 0.5 * (nx**2 - ny**2),
    ], -1)  # [B, V, 9]
    return torch.einsum("bvk,bck->bvc", Y, g)


# -------------------------------------------------------------- rasterization
def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def rasterize_attributes(xy: torch.Tensor, z: torch.Tensor, attrs: torch.Tensor, tris,
                         H: int, W: int):
    """Frames of xy [B, V, 2] (differentiable), z [B, V] positive depth,
    attrs [B, V, C] vertex attributes -> image [B, H, W, C], mask [B, H, W]
    (JAX's takes one frame and is vmapped).

    Visibility comes from kernel E on detached inputs; the barycentrics of
    each covered pixel are derived again from xy, so d(image)/d(xy, attrs)
    exists. Only covered pixels are interpolated (JAX interpolates every
    pixel and zeroes the uncovered ones: the same values and gradients)."""
    B = xy.shape[0]
    tris = torch.as_tensor(tris, device=xy.device).long()
    tri_id = rasterize(xy.detach(), z.detach(), tris, H, W)  # [B, H, W]
    flat = tri_id.reshape(-1)
    valid = flat >= 0
    sel = valid.nonzero()[:, 0]
    b = sel // (H * W)
    p = sel % (H * W)
    vid = tris[flat[sel].long()]  # [P, 3]
    pv = xy[b[:, None], vid]  # [P, 3, 2]
    pix = torch.stack([(p % W).float() + 0.5, (p // W).float() + 0.5], -1)
    v0, e1, e2 = pv[:, 0], pv[:, 1] - pv[:, 0], pv[:, 2] - pv[:, 0]
    den = _cross2(e1, e2)
    den = torch.where(den.abs() < 1e-12, torch.ones_like(den), den)
    d = pix - v0
    w1 = _cross2(d, e2) / den
    w2 = _cross2(e1, d) / den
    w0 = 1.0 - w1 - w2
    av = attrs[b[:, None], vid]  # [P, 3, C]
    vals = w0[:, None] * av[:, 0] + w1[:, None] * av[:, 1] + w2[:, None] * av[:, 2]
    C = attrs.shape[-1]
    out = vals.new_zeros((B * H * W, C)).index_put((sel,), vals)
    return out.reshape(B, H, W, C), valid.reshape(B, H, W)


# ------------------------------------------------------------------- facade
class Render3DMM:
    """The reference's Render_3DMM facade (render_3dmm.py:83-209): camera-
    space geometry [B, V, 3] + per-vertex albedo [B, V, 3] (0..255) + SH
    light [B, 27] -> [B, H, W, 4] RGBA (RGB 0..255, A in {0, 1})."""

    def __init__(self, focal, h, w, tris):
        self.focal = float(focal)
        self.h, self.w = int(h), int(w)
        self.tris = tris
        self._tris = {}  # (device, vertex count) -> int64 tensor, checked

    def tris_on(self, device, n_verts: int) -> torch.Tensor:
        """The triangles as int64 on device, checked against the vertex count
        once (kernel E does not check them)."""
        key = (device, n_verts)
        if key not in self._tris:
            tris = torch.as_tensor(self.tris, device=device).long()
            check_triangles(tris, n_verts)
            self._tris[key] = tris
        return self._tris[key]

    def project(self, verts: torch.Tensor):
        """Camera space -> screen, the tracker's convention (geo_transform.py:
        u = f x / z + cx, v = -f y / z + cy, camera looking down -z)."""
        z = torch.maximum(-verts[..., 2], verts.new_tensor(1e-6))
        u = self.focal * verts[..., 0] / z + self.w / 2.0
        v = -self.focal * verts[..., 1] / z + self.h / 2.0
        return torch.stack([u, v], -1), z

    def __call__(self, rott_geometry, texture, gamma):
        tris = self.tris_on(rott_geometry.device, rott_geometry.shape[1])
        normals = vertex_normals(rott_geometry, tris)
        color = texture * sh_irradiance(normals, gamma)  # [B, V, 3]
        xy, z = self.project(rott_geometry)
        img, mask = rasterize_attributes(xy, z, color, tris, self.h, self.w)
        # jnp.clip's gradient: minimum(maximum(...)) splits it at a tie
        img = torch.minimum(torch.maximum(img, img.new_tensor(0.0)), img.new_tensor(255.0))
        return torch.cat([img, mask[..., None].to(img.dtype)], -1)
