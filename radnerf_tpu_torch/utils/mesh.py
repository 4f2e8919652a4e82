"""Mesh export of the density field (counterpart of
``radnerf_tpu/utils/mesh.py``; reference Trainer.save_mesh,
nerf/utils.py:849-891).

``extract_geometry`` queries sigma on a dense lattice over a box, chunk by
chunk on the field's device, and ``marching_tetrahedra`` extracts the
iso-surface at a threshold: each cell is split into six tetrahedra, and a
tetrahedron's 16 sign cases give at most two triangles, so no 256-entry
table is needed. It runs in torch where the field lies: the cases of every
cell come slab by slab along x, then each (tetrahedron, case) takes its
cells in order and forms their triangles. The loop order (tetrahedron, case
1-14, triangle) and the arithmetic (the edge fraction in float32, the
vertex in float64) are the JAX function's, so the triangles come out in the
same order and the vertices agree to float64 rounding. ``save_mesh_ply``
writes the ASCII PLY the JAX package writes.
"""

from __future__ import annotations

import numpy as np
import torch

# the 6 tetrahedra of a cube, as corner indices (corner k = (x, y, z) bits)
_TETS = ((0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6))
_CORNER_OFFSETS = tuple(((k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1) for k in range(8))


def _tet_triangles(case: int):
    """The (up to 2) triangles of a tetrahedron's sign case, each vertex an
    edge (a pair of local corner ids), inside corners first."""
    inside = [i for i in range(4) if case & (1 << i)]
    outside = [i for i in range(4) if not case & (1 << i)]
    if len(inside) in (0, 4):
        return []
    if len(inside) == 1:
        e = [(inside[0], b) for b in outside]
        return [(e[0], e[1], e[2])]
    if len(inside) == 3:
        e = [(b, outside[0]) for b in inside]
        return [(e[0], e[2], e[1])]
    # two in, two out: a quad, two triangles
    a, b = inside
    c, d = outside
    return [((a, c), (b, c), (b, d)), ((a, c), (b, d), (a, d))]


def marching_tetrahedra(field: torch.Tensor, threshold: float, slab: int = 32):
    """The iso-surface ``field > threshold`` of a dense field [X, Y, Z] on
    its device: (vertices [V, 3] float64 in lattice coordinates, triangles
    [F, 3] int64), three vertices of its own per triangle. ``slab`` x-planes
    of cells are classified at a time."""
    X, Y, Z = field.shape
    dev = field.device
    n_yz = (Y - 1) * (Z - 1)
    cases = torch.empty((len(_TETS), (X - 1) * n_yz), dtype=torch.uint8, device=dev)
    for x0 in range(0, X - 1, slab):
        x1 = min(x0 + slab, X - 1)
        inside = [(field[x0 + ox:x1 + ox, oy:Y - 1 + oy, oz:Z - 1 + oz] > threshold)
                  .reshape(-1).to(torch.uint8) for ox, oy, oz in _CORNER_OFFSETS]
        for t, tet in enumerate(_TETS):
            cases[t, x0 * n_yz:x1 * n_yz] = (inside[tet[0]] + 2 * inside[tet[1]]
                                             + 4 * inside[tet[2]] + 8 * inside[tet[3]])
    offsets = torch.tensor(_CORNER_OFFSETS, dtype=torch.int64, device=dev)
    verts, faces, v_count = [], [], 0
    for t, tet in enumerate(_TETS):
        for c in range(1, 15):
            sel = (cases[t] == c).nonzero().squeeze(1)
            n = sel.shape[0]
            if n == 0:
                continue
            base = torch.stack([sel // n_yz, (sel // (Z - 1)) % (Y - 1), sel % (Z - 1)], -1)
            corner = [base + offsets[k] for k in tet]
            tv = [field[p[:, 0], p[:, 1], p[:, 2]] for p in corner]  # [n] float32 each
            for tri in _tet_triangles(c):
                for ia, ib in tri:
                    va, vb = tv[ia], tv[ib]
                    frac = torch.clamp((threshold - va) / (vb - va + 1e-12), 0.0, 1.0)
                    pa, pb = corner[ia].double(), corner[ib].double()
                    verts.append(pa + frac.double()[:, None] * (pb - pa))
                ids = torch.arange(v_count, v_count + 3 * n, device=dev)
                faces.append(ids.view(3, n).t())
                v_count += 3 * n
    if not verts:
        return (torch.zeros((0, 3), dtype=torch.float64, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))
    return torch.cat(verts), torch.cat(faces)


def lattice_axes(bound_min, bound_max, resolution: int):
    """The lattice's coordinates along each axis: float32 [resolution] x 3,
    ``np.linspace`` from bound_min to bound_max as the JAX function takes
    them."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    return [np.linspace(bound_min[i], bound_max[i], resolution).astype(np.float32)
            for i in range(3)]


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float, query_func,
                     chunk: int = 128**2 * 16, device="cpu"):
    """Sigma on a resolution^3 lattice over [bound_min, bound_max] (x
    major), queried ``chunk`` points at a time on ``device``, and its
    iso-surface at ``threshold`` (utils.py:849-869). ``query_func``: float32
    [n, 3] points -> [n] sigma, on the device. Returns (vertices [V, 3]
    float32 in world coordinates, triangles [F, 3] int64), numpy."""
    dev = torch.device(device)
    axes = [torch.from_numpy(a).to(dev) for a in lattice_axes(bound_min, bound_max, resolution)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    vals = torch.empty(pts.shape[0], dtype=torch.float32, device=dev)
    for head in range(0, pts.shape[0], chunk):
        vals[head:head + chunk] = query_func(pts[head:head + chunk])
    del pts
    vertices, triangles = marching_tetrahedra(vals.view(resolution, resolution, resolution),
                                              threshold)
    # lattice -> world, in float64 as numpy promotes it, then float32
    lo = np.asarray(bound_min, np.float32)
    scale = (np.asarray(bound_max, np.float32) - lo) / (resolution - 1)
    vertices = (vertices * torch.from_numpy(scale).double().to(dev)
                + torch.from_numpy(lo).double().to(dev)).float()
    return vertices.cpu().numpy(), triangles.cpu().numpy()


def save_mesh_ply(path: str, vertices: np.ndarray, triangles: np.ndarray):
    """Write an ASCII PLY mesh, byte for byte as the JAX package writes it."""
    head = ("ply\nformat ascii 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(triangles)}\n"
            "property list uchar int vertex_indices\n"
            "end_header\n")
    v_lines = "".join(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in np.asarray(vertices).tolist())
    f_lines = "".join(f"3 {a} {b} {c}\n" for a, b, c in np.asarray(triangles).tolist())
    with open(path, "w") as f:
        f.write(head + v_lines + f_lines)
