"""Attribution study of kernel E (the 3DMM renderer's z-buffer rasterizer)
on the card, on the photometric step's inputs, and the designs measured
against the parent's kernel.

    python3 -m radnerf_tpu_torch.studies.raster PARENT_DIR OUT_JSON

Run from the root of a checkout on one NVIDIA GPU; PARENT_DIR is a checkout
of the commit before E's trimmed windows (its raster pass tests every
centre within one pixel of a triangle's box), e.g. unpacked by ``git
archive <rev> | tar -x -C build/parent``. The inputs: chip_smoke's synthetic BFM-size 3DMM (34,650
vertices, 68,556 triangles) at its 64 frames' true poses, projected at
512x512 and focal 1100 as ``Render3DMM`` projects them (the frames the
photometric step fits are rendered from these). Each side is timed in turns
on the same tensors (``chip_smoke.device_ms``, order a, b, ..., b, a) and
profiled by kernel (``chip_smoke.device_profile``, 10 calls):

- (a) the parent's E, its memset, ``raster_triangles`` and ``unpack_ids``
  apart (the profile);
- (b) the parent's raster pass with plain stores for its ``atomicMin``s,
  with the z-buffer cut to one frame (every frame writes frame 0's 2 MB,
  which stays in L2), and both;
- (c) the (pixel, triangle) centres tested against those covered; those
  that pass the sign test of the barycentric numerators n1, n2; those
  this checkout's E tests after its trim (``_trimmed_ranges``); the tile
  lists at 16x16 and 32x32 tiles (``bin_triangles_plain``);
- (d) the parent's raster pass with one reciprocal and two multiplies in
  place of the two IEEE divisions;
- this checkout's E (the parent's z-buffer, each window trimmed of the
  margin rows and columns no rounded test covers) and its variants
  (THIS_EDITS);
- the queued design (``raster_queued.cu``: the parent's z-buffer, a sign
  test at every centre, the exact tests of those that pass queued a warp
  at a time);
- the binned design (``raster_binned.cu``: tile lists, a warp a 16x16
  tile with its depth buffer in shared memory, tri_id written directly),
  its lists held to ``bin_triangles_plain``, and its variants
  (BINNED_EDITS);
- each library's registers (``-Xptxas -v``) and its shared-memory atomics
  in SASS (``cuobjdump -sass``).

The attribution variants are copies of a source with one text replaced
(EDITS, THIS_EDITS, BINNED_EDITS); (b), (d) and the variants in TIMED_ONLY
compute wrong results by design and are timed only. Every other side is
held bit for bit to ``rasterize_plain``. Writes OUT_JSON after each part.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops.rasterize import _live_ranges

HERE = Path(__file__).resolve().parent
# text edits of the parent's rasterize.cu by name: (text, replacement), each
# text found exactly once
EDITS = {
    "stores": ("        atomicMin(frame + (long long)pi * W + pj, key);",
               "        frame[(long long)pi * W + pj] = key;"),
    "one_frame": ("  unsigned long long* frame = zbuf + (long long)b * H * W;",
                  "  unsigned long long* frame = zbuf;"),
    "multiply": ("      const float w1 = (dx * e2y - dy * e2x) / den_;\n"
                 "      const float w2 = (e1x * dy - e1y * dx) / den_;",
                 "      const float w1 = (dx * e2y - dy * e2x) * inv;\n"
                 "      const float w2 = (e1x * dy - e1y * dx) * inv;"),
    "reciprocal": ("  const float den_ = den;",
                   "  const float den_ = den;\n  const float inv = 1.0f / den_;"),
}
# the parent's sides: tag -> edits
PARENT_SIDES = {"parent": (), "stores": ("stores",), "one_frame": ("one_frame",),
                "one_frame_stores": ("one_frame", "stores"),
                "multiply": ("reciprocal", "multiply")}
# this checkout's variants: tag -> [(text, replacement)] in csrc/rasterize.cu
THIS_EDITS = {
    "no_trim": [("  if (aden <= 0x1p20f * ad && reach < 0x1p40f) {", "  if (false) {")],
    "bounds6": [("__global__ void raster_triangles(",
                 "__global__ void __launch_bounds__(256, 6) raster_triangles(")],
    "bounds8": [("__global__ void raster_triangles(",
                 "__global__ void __launch_bounds__(256, 8) raster_triangles(")],
}
# the binned design's variants, in studies/raster_binned.cu (32x32 tiles: 4
# warps a block hold 32 KB of keys)
BINNED_EDITS = {
    "binned": [],
    "binned_tile32": [("constexpr int kTile = 16;", "constexpr int kTile = 32;"),
                      ("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "binned_no_sign_test": [("  if (fabsf(r.den) <= 0x1p64f) {", "  if (false) {")],
    # timed only: the lists left out; their triangles loaded, no centre
    # tested; a reciprocal and two multiplies for the divisions
    "binned_no_list": [("  for (int e = begin + lane; e < end; e += 32) {",
                        "  for (int e = end + lane; e < end; e += 32) {")],
    "binned_loads_only": [("    for (int pi = i0; pi <= i1; ++pi) {",
                           "    for (int pi = i0; pi <= i1 && r.z0 < -1.0f; ++pi) {")],
    "binned_multiply": [("  const float w1 = n1 / r.den;\n  const float w2 = n2 / r.den;",
                         "  const float w1 = n1 * (1.0f / r.den);\n"
                         "  const float w2 = n2 * (1.0f / r.den);")],
}
TIMED_ONLY = ("stores", "one_frame", "one_frame_stores", "multiply", "binned_no_list",
              "binned_loads_only", "binned_multiply")
# the binned design's tile side (kTile in raster_binned.cu)
TILE = 16
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_ENTRY = {"rasterize_fwd": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _P]}
QUEUED_ENTRY = {"rasterize_queued_fwd": PARENT_ENTRY["rasterize_fwd"]}
# xy, z, tris, scratch, n_scratch, tri_id, B, V, T, H, W, stream
BINNED_ENTRY = {"rasterize_binned_fwd": [_P, _P, _P, _P, _L, _P, _I, _L, _I, _I, _I, _P]}
# a kernel's name in a profile: the parent's, the memset, this checkout's
KERNEL_NAME = re.compile(r"raster_triangles|unpack_ids|memset|raster_bin<\w+>|raster_\w+")


def _nvcc_flags():
    from radnerf_tpu_torch.ops import _kernels
    return [_kernels._nvcc(), *_kernels.NVCC_FLAGS]


def _load(so: Path, entry_points: dict):
    lib = ctypes.CDLL(str(so.resolve()))
    for fn, argtypes in entry_points.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    return lib


def _check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def build_sides(sources: dict, out: Path):
    """{tag: (source text, entry points)} -> {tag: (ctypes library, ptxas
    lines, .so path)}, one nvcc each, all at once; the sources are written
    beside a copy of this checkout's csrc headers."""
    headers = HERE.parent / "csrc"
    procs = {}
    for tag, (text, _) in sources.items():
        d = out / tag
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for h in headers.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "rasterize.cu").write_text(text)
        so = d / "lib.so"
        procs[tag] = (so, subprocess.Popen([*_nvcc_flags(), "-o", str(so), str(d / "rasterize.cu")],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        lines = [s.strip() for s in log.splitlines() if "registers" in s or "spill" in s]
        libs[tag] = (_load(so, sources[tag][1]), lines, so)
    return libs


def edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source does not hold {old!r} once")
        text = text.replace(old, new)
    return text


def shared_atomics(so: Path) -> dict:
    """The shared-memory atomic instructions (ATOMS) in a library's SASS,
    with their counts."""
    cuobjdump = Path(_nvcc_flags()[0]).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for m in re.finditer(r"\b(ATOMS\.[A-Z0-9.]+)", text):
        found[m.group(1)] = found.get(m.group(1), 0) + 1
    return found


def photometric_inputs(S, dev):
    """xy [64, 34,650, 2], z [64, 34,650] float32 and tris [68,556, 3] int32
    on the card: chip_smoke's synthetic 3DMM posed at its frames' true
    parameters (``write_video_inputs``' seed) and projected as
    ``Render3DMM`` projects them."""
    from radnerf_tpu_torch.preprocess import face_tracker as PT
    from radnerf_tpu_torch.preprocess import render_3dmm as P

    N, size = S.PRE_FRAMES, S.PRE_SIZE
    with tempfile.TemporaryDirectory() as root:
        paths = S.synthetic_3dmm(root)
        mesh = P.mesh_basis_from_file(paths["3DMM"], paths["topology"], paths["keys"]).to(dev)
    truth = {k: torch.from_numpy(v).to(dev)
             for k, v in S.synthetic_truth(np.random.default_rng(1), N).items()}
    with torch.no_grad():
        geo = P.forward_geo(mesh, truth["id"].expand(N, -1), truth["exp"])
        cam = torch.einsum("nij,nkj->nki", PT.euler_rot(truth["euler"]), geo) \
            + truth["trans"][:, None]
        xy, z = P.Render3DMM(S.PRE_FOCAL, size, size, mesh.tris).project(cam)
    tris = torch.as_tensor(mesh.tris, device=dev).to(torch.int32).contiguous()
    return xy.contiguous(), z.contiguous(), tris, size, size


def bin_triangles_plain(xy: torch.Tensor, tris: torch.Tensor, H: int, W: int,
                        tile: int = TILE) -> torch.Tensor:
    """Plain version of the binned design's binning (raster_binned.cu). A
    (frame, triangle) that can cover a centre (``|den| > 1e-12`` and a
    pixel range on the image, kernel E's range) goes into the list of every tile of side
    ``tile`` its range touches when that is at most 2x2 tiles, else into
    its frame's wide list. Returns the lists as one sorted int64 tensor of
    keys (b * (n_tiles + 1) + k) * T + t: triangle t in list k of frame b,
    tiles k = ty * n_tx + tx in row-major order (n_tx = ceil(W / tile)),
    k = n_tiles the wide list."""
    B, T = xy.shape[0], tris.shape[0]
    i0, i1, j0, j1, live = _live_ranges(xy, tris, H, W)
    tx0, tx1, ty0, ty1 = j0 // tile, j1 // tile, i0 // tile, i1 // tile
    small = (tx1 - tx0 <= 1) & (ty1 - ty0 <= 1)
    n_tx = -(-W // tile)
    n_tiles = n_tx * -(-H // tile)
    b = torch.arange(B, device=xy.device)[:, None]
    t = torch.arange(T, device=xy.device)[None, :]
    keys = [((b * (n_tiles + 1) + n_tiles) * T + t)[live & ~small]]
    for dy in (0, 1):
        for dx in (0, 1):
            ok = live & small & (ty0 + dy <= ty1) & (tx0 + dx <= tx1)
            k = (ty0 + dy) * n_tx + tx0 + dx
            keys.append(((b * (n_tiles + 1) + k) * T + t)[ok])
    return torch.sort(torch.cat(keys)).values



def binned_scratch_ints(B: int, T: int, H: int, W: int) -> int:
    """The binned design's int32 scratch (``scratch_ints`` there): tile
    counts and list cursors [B, n_tiles] each, wide counts [B], the tile
    lists [4 B T], the wide lists [B, T]."""
    n_tiles = -(-H // TILE) * -(-W // TILE)
    return 2 * B * n_tiles + B + 5 * B * T


def binned_fn(lib, xy, z, tris, H, W):
    """The binned design through its C entry point: fn() -> (tri_id, the
    int32 scratch holding its lists)."""
    B, V, T = xy.shape[0], xy.shape[1], tris.shape[0]
    scratch = torch.empty(binned_scratch_ints(B, T, H, W), dtype=torch.int32, device=xy.device)
    tri_id = torch.empty((B, H, W), dtype=torch.int32, device=xy.device)

    def run():
        _check(lib.rasterize_binned_fwd(xy.data_ptr(), z.data_ptr(), tris.data_ptr(),
                                        scratch.data_ptr(), scratch.numel(), tri_id.data_ptr(),
                                        B, V, T, H, W, torch.cuda.current_stream().cuda_stream),
               "rasterize_binned_fwd")
        return tri_id, scratch
    return run


def binned_lists(scratch, B, T, H, W):
    """The binned design's tile lists read from its scratch, in
    ``bin_triangles_plain``'s form (sorted keys)."""
    scratch = scratch.long()
    n_tiles = -(-H // TILE) * -(-W // TILE)
    BN = B * n_tiles
    counts, n_wide = scratch[:BN], scratch[BN:BN + B]
    ends, lists = scratch[BN + B:2 * BN + B], scratch[2 * BN + B:2 * BN + B + 4 * B * T]
    wide = scratch[2 * BN + B + 4 * B * T:].view(B, T)

    def entries(n, first):
        """(row, position in the scratch) of each entry of rows holding n
        entries from position first."""
        r = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
        pos = (torch.arange(r.numel(), device=n.device)
               - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
               + torch.repeat_interleave(first, n))
        return r, pos

    r, pos = entries(counts, ends - counts)
    keys = [((r // n_tiles) * (n_tiles + 1) + r % n_tiles) * T + lists[pos]]
    r, pos = entries(n_wide, torch.zeros_like(n_wide))
    keys.append((r * (n_tiles + 1) + n_tiles) * T + wide[r, pos])
    return torch.sort(torch.cat(keys)).values


def pair_counts(xy, z, tris, H, W):
    """(c): the centres E tests, those that pass the sign test of n1 and n2
    (both of den's sign or zero: the rest have w1 < 0 or w2 < 0), and those
    covered; the tile lists at 16x16 and 32x32 tiles."""
    from radnerf_tpu_torch.ops.rasterize import _covered_pairs, _tested_pairs, _trimmed_ranges

    tested = signs = 0
    for _, _, _, _, n1, n2, den in _tested_pairs(xy, tris, H, W):
        tested += n1.numel()
        s = torch.where(den > 0, 1.0, -1.0)
        signs += int(((n1 * s >= 0) & (n2 * s >= 0)).sum())
    covered = sum(pix.numel() for _, pix, _ in _covered_pairs(xy, z, tris, H, W))
    i0, i1, j0, j1 = _trimmed_ranges(xy, tris, H, W)
    trimmed = int(((i1 - i0 + 1).clamp_min(0) * (j1 - j0 + 1).clamp_min(0)).sum())
    B, T = xy.shape[0], tris.shape[0]
    out = {"triangles": B * T, "pairs_tested": tested, "pairs_passing_sign_test": signs,
           "pairs_tested_after_trim": trimmed, "pairs_covered": covered,
           "tested_per_triangle": tested / (B * T), "trimmed_per_triangle": trimmed / (B * T)}
    for tile in (16, 32):
        keys = bin_triangles_plain(xy, tris, H, W, tile)
        n_tiles = -(-W // tile) * -(-H // tile)
        k = (keys // T) % (n_tiles + 1)
        small = keys[k < n_tiles]
        per_tile = torch.bincount((keys // T)[k < n_tiles], minlength=B * (n_tiles + 1))
        busy = per_tile[per_tile > 0].float()
        out[f"tile{tile}"] = {"entries": int(small.numel()),
                              "wide": int((k == n_tiles).sum()),
                              "tiles_with_entries": int(busy.numel()),
                              "entries_per_busy_tile_mean": float(busy.mean()),
                              "entries_per_busy_tile_max": int(busy.max())}
    return out


def by_kernel(S, fn, reps=10):
    """Device ms a call of each kernel fn launches (the profile over reps
    calls), keyed by the kernel's name (KERNEL_NAME)."""
    _, events = S.device_profile(lambda i: fn(), reps)
    out = {}
    for e in events:
        m = KERNEL_NAME.search(e.key.lower())
        key = m.group(0) if m else e.key
        out[key] = out.get(key, 0.0) + e.self_device_time_total / reps / 1e3
    return out


def in_turns(S, fns: dict, reps=20) -> dict:
    """chip_smoke.device_ms of each fn in the order a, b, ..., ..., b, a:
    {tag: [first, second]}."""
    order = list(fns) + list(fns)[::-1]
    got = {t: [] for t in fns}
    for t in order:
        got[t].append(S.device_ms(fns[t], reps))
    return got


def parent_fn(lib, xy, z, tris, H, W, entry="rasterize_fwd"):
    """The parent's E (or a design with its C interface, named entry)
    through its C entry point, on its own z-buffer."""
    B, V, T = xy.shape[0], xy.shape[1], tris.shape[0]
    zbuf = torch.empty((B, H, W), dtype=torch.int64, device=xy.device)
    tri_id = torch.empty((B, H, W), dtype=torch.int32, device=xy.device)

    def run():
        _check(getattr(lib, entry)(xy.data_ptr(), z.data_ptr(), tris.data_ptr(), zbuf.data_ptr(),
                                   tri_id.data_ptr(), B, V, T, H, W,
                                   torch.cuda.current_stream().cuda_stream), entry)
        return tri_id
    return run


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("raster study: no CUDA device", file=sys.stderr)
        sys.exit(1)
    parent = Path(argv[0]).resolve()
    out_json = Path(argv[1])
    out_json.parent.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as S

    from radnerf_tpu_torch.ops import _kernels, rasterize, rasterize_plain

    dev = torch.device("cuda")
    build = HERE.parents[1] / "build" / "study_raster"
    build.mkdir(parents=True, exist_ok=True)
    result = {"nvidia_smi": S.nvidia_smi_line(), "parent": str(parent)}

    def save(**parts):
        result.update(parts)
        out_json.write_text(json.dumps(result, indent=1))

    parent_src = (parent / "radnerf_tpu_torch/csrc/rasterize.cu").read_text()
    this_src = _kernels.KERNELS["rasterize"].source.read_text()
    binned_src = (HERE / "raster_binned.cu").read_text()
    sources = {tag: (edited(parent_src, [EDITS[e] for e in edits]), PARENT_ENTRY)
               for tag, edits in PARENT_SIDES.items()}
    this_entry = _kernels.KERNELS["rasterize"].entry_points
    sources.update({tag: (edited(this_src, edits), this_entry)
                    for tag, edits in THIS_EDITS.items()})
    sources["queued"] = ((HERE / "raster_queued.cu").read_text(), QUEUED_ENTRY)
    sources.update({tag: (edited(binned_src, edits), BINNED_ENTRY)
                    for tag, edits in BINNED_EDITS.items()})
    libs = build_sides(sources, build)
    logs = _kernels.build_all()
    this_so = _kernels.KERNELS["rasterize"].library_path()
    result["ptxas"] = {tag: log for tag, (_, log, _) in libs.items()}
    result["ptxas"]["this"] = [s.strip() for s in logs["rasterize"].splitlines()
                               if "registers" in s or "spill" in s]
    result["shared_atomics_sass"] = {"binned": shared_atomics(libs["binned"][2])}
    save()

    xy, z, tris, H, W = photometric_inputs(S, dev)
    B, T = xy.shape[0], tris.shape[0]
    want = rasterize_plain(xy, z, tris, H, W)
    fns = {tag: parent_fn(libs[tag][0], xy, z, tris, H, W) for tag in PARENT_SIDES}
    fns["this"] = lambda: rasterize(xy, z, tris, H, W)
    for tag in THIS_EDITS:
        fns[tag] = (lambda lib=libs[tag][0]: _with_library(lib, lambda: rasterize(
            xy, z, tris, H, W)))
    fns["queued"] = parent_fn(libs["queued"][0], xy, z, tris, H, W, "rasterize_queued_fwd")
    for tag in BINNED_EDITS:
        fns[tag] = binned_fn(libs[tag][0], xy, z, tris, H, W)
    exact = {}
    for tag, fn in fns.items():
        got = fn()
        n = int(((got[0] if tag in BINNED_EDITS else got) != want).sum())
        exact[tag] = n
        if n and tag not in TIMED_ONLY:
            raise RuntimeError(f"{tag} differs from rasterize_plain at {n} pixels")
    lists_equal = torch.equal(binned_lists(fns["binned"]()[1], B, T, H, W),
                              bin_triangles_plain(xy, tris, H, W))
    torch.cuda.synchronize()
    if not lists_equal:
        raise RuntimeError("the binned design's tile lists differ from bin_triangles_plain's")
    save(shapes={"frames": B, "vertices": xy.shape[1], "triangles": T, "H": H, "W": W},
         pixels_differing_from_plain=exact, binned_lists_equal_plain=lists_equal,
         covered_share=float((want >= 0).float().mean()))
    save(counts=pair_counts(xy, z, tris, H, W))
    print(json.dumps({"counts": result["counts"]}), flush=True)
    save(by_kernel={tag: by_kernel(S, fn) for tag, fn in fns.items()})
    print(json.dumps({"by_kernel": result["by_kernel"]}), flush=True)
    save(device_ms_in_turns=in_turns(S, fns))
    print(json.dumps({"device_ms_in_turns": result["device_ms_in_turns"]}), flush=True)
    print(json.dumps({"ok": True, "nvidia_smi": result["nvidia_smi"]}), flush=True)


def _with_library(lib, fn):
    """fn() with kernel E's library swapped for lib (this checkout's entry
    points), so a variant runs through the same wrapper."""
    from radnerf_tpu_torch.ops import _kernels

    k = _kernels.KERNELS["rasterize"]
    own = k._load()
    k._lib = lib
    try:
        return fn()
    finally:
        k._lib = own


if __name__ == "__main__":
    main()
