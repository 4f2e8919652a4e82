"""Attribution study of kernels B-grouped (the two-level march) and
B-bitfield's float-grid cull on the card, and the designs measured against
the parent's kernels; and the adversarial calls ``chip_smoke.py``'s
march_variants phase holds both kernels to their twins on.

    python3 -m radnerf_tpu_torch.studies.march PARENT_DIR OUT_JSON

Run from the root of a checkout on one NVIDIA GPU; PARENT_DIR is a checkout
of the commit before the redesign (B-grouped fine-marching two kept groups
a pass at 64 registers, B-bitfield culling its staged slots in a pass after
the walk), e.g. unpacked by ``git archive <rev> | tar -x -C build/parent``.
The calls are the march_variants phase's own: the sparse two-blob frame
and the portrait bench frame at 512x512 (their rays, windows, sigma and
coarse bytes, K = n_k_span rounded up to even), the bench frame's rays at
K = 129 for B-bitfield with its 1e-4 float-grid cull, and S = 128: the
variants run's march (bound 2, cascade 2, max_steps 128, the general orbit)
on the bench camera over a seeded grid that every cell of occupies, as the
variants eval frame's does (``s128_call``). Each side runs through this
checkout's wrapper with the kernel's library swapped and is timed in turns
on the same tensors (``chip_smoke.device_ms`` after its 50 ms of warm-up,
order a, b, ..., b, a):

- B-grouped: the parent's kernel; its attribution variants: the [N, S]
  stores off, the fine pass off, the coarse pass alone (both off); this
  checkout's kernel (the parent's design at B's occupancy, 32 registers)
  with its stores off; the designs that lost: the kept group of each rank
  found once a chunk and shuffled out ("this_nth_once"), both culls' chains
  looping over the lanes that add more than 0 ("this_skip_chains"), both
  ("this_v3"), and one coarse group a lane, each lane fine-marching its own
  group's 4 steps (march_lane_registers.cu, march_lane_shared.cu); B on the
  same rays and sigma bytes;
- B-bitfield: the parent's kernel with and without the cull, the cull pass
  alone (the walk off, every slot of the tile culled) and the walk off
  without it; this checkout's kernel (the cull in the walk, the grid value
  loaded beside the bit) with and without the cull; the designs that lost:
  the grid value loaded once the slot is known selected
  ("this_late_load"), the chain looping over the selecting lanes
  ("this_skip_chain", and in "this_v3"), the lane designs' culls, 32 rays
  a block at S = 128 (the tile opted in above 48 KB); B on the same rays;
- B: this checkout's against the parent's on every call B takes here;
- each library's registers and spills (``-Xptxas -v``).

The attribution variants are copies of a source with texts replaced
(EDITS); those in TIMED_ONLY compute wrong results by design and are timed
only. Every other side is held bit for bit to its twin
(``march_rays_grouped_plain``, ``march_rays_plain``). Writes OUT_JSON after
each part.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import marching as M
from ..ops.morton import morton3d_invert, packbits
from ..ops.ray_aabb import near_far_from_aabb
from .raster import edited, in_turns

HERE = Path(__file__).resolve().parent
FRAME_SIZE = 512  # the march_variants frames' height and width


# ------------------------------------------------------ adversarial calls
def _grid_coords(H, dev):
    """[H^3, 3] cell centres in [-1, 1] in Morton order."""
    c = morton3d_invert(torch.arange(H**3, device=dev)).float()
    return (2.0 * c + 1.0) / H - 1.0


def _rays_at_cube(n, gen, dev, spread=1.0):
    """n rays from a sphere of radius 3 towards uniform points of the cube
    [-spread, spread]^3 (unit directions)."""
    src = torch.randn(n, 3, generator=gen)
    src = 3.0 * src / src.norm(dim=-1, keepdim=True)
    dst = (torch.rand(n, 3, generator=gen) * 2.0 - 1.0) * spread
    d = dst - src
    return src.to(dev), (d / d.norm(dim=-1, keepdim=True)).to(dev)


def _rays_along_z(n, gen, dev, bound, x_lo, x_hi):
    """n rays parallel to +z from z = -3 bound, x in [x_lo, x_hi) bound,
    y in [-0.9, 0.9) bound."""
    o = torch.empty(n, 3)
    o[:, 0] = (x_lo + (x_hi - x_lo) * torch.rand(n, generator=gen)) * bound
    o[:, 1] = (torch.rand(n, generator=gen) * 1.8 - 0.9) * bound
    o[:, 2] = -3.0 * bound
    d = torch.zeros(n, 3)
    d[:, 2] = 1.0
    return o.to(dev), d.to(dev)


def _near_far(o, d, bound, nan_every=0):
    """(nears, fars) of the box [-bound, bound]^3, every nan_every-th near
    NaN (such a ray marches nothing)."""
    b = float(bound)
    nears, fars = near_far_from_aabb(o, d, o.new_tensor([-b, -b, -b, b, b, b]), 0.05)
    if nan_every:
        nears = nears.clone()
        nears[::nan_every] = float("nan")
    return nears, fars


def grouped_calls(dev, n_rays, cull_T=1e-4):
    """The two-level march's adversarial calls: K = 96 (24 groups over 3
    coarse chunks of 8) on a 128^3 field of a shell, a blob and scattered
    cells (coarse groups kept and dropped, eroded codes the cull reads),
    rays from every side through the cube and their full windows, one near
    in 61 NaN; every kept group marched with and without training noises,
    and group_slots 0, 1 and 11 (a truncation inside the second chunk).
    Returns [(name, args, kwargs)] for ``march_rays_grouped``."""
    gen = torch.Generator().manual_seed(17)
    H = 128
    p = _grid_coords(H, "cpu")
    r = p.norm(dim=-1)
    dens = torch.where((r > 0.62) & (r < 0.7), 40.0, 0.0)
    dens = torch.where(r < 0.3, 400.0 * (1.0 - r / 0.3) + 10.0, dens)
    dens = torch.where(torch.rand(H**3, generator=gen) < 0.002, 30.0, dens)
    sb = M.build_sigma_bytes(dens.to(dev), 5.0)
    cb = M.build_coarse_bytes(sb, 1, H)
    cfg = M.MarchConfig(bound=1.0, grid_size=H, max_steps=16, dt_gamma=0.0, march_iters=96)
    o, d = _rays_at_cube(n_rays, gen, dev)
    nears, fars = _near_far(o, d, 1.0, nan_every=61)
    noises = torch.rand(n_rays, generator=gen).to(dev)
    base = (o, d, nears, fars, sb, cb, cfg, (nears, fars))
    calls = [("k96", base, dict(group_slots=None, cull_T=cull_T)),
             ("k96_noises", base, dict(group_slots=None, cull_T=cull_T, noises=noises)),
             ("k96_no_cull", base, dict(group_slots=None, cull_T=0.0, noises=noises))]
    for slots in (0, 1, 11):
        calls.append((f"k96_slots{slots}", base,
                      dict(group_slots=slots, cull_T=cull_T, noises=noises)))
    return calls


def bitfield_calls(dev, n_rays, cull_T=1e-4):
    """B-bitfield's adversarial calls, with the float-grid cull at cull_T
    (L = -ln(cull_T)), each also without it:

    - "cross" (S = 16, the affine orbit, cascade 1): rays along +z through a
      grid every cell of which is occupied, in x bands whose constant grid
      value c puts the cull's crossing at slot 1 (slot 0's estimate alone
      exceeds L), 8, 15 = S - 1 and 2; among them 2% of cells at -1 (they
      add 0), a slab of NaN cells near the rays' entry in part of the slot-8
      band (the sum turns NaN: every later slot culled) and a slab of 1e12
      cells after the slot-2 band's crossing (fl(fl(s + a) - a) = 0: a slot
      there is kept again); one near in 61 NaN;
    - "s128" (S = 128, K = 257: bound 2, cascade 2, max_steps 128, the
      general orbit): rays from every side through a grid every cell of
      which is occupied, so count > S, U(0, 42) in x > 0 (the cull crosses
      near slot 64) and ten times less in x < 0 (no crossing); training
      noises.

    Returns [(name, args, kwargs)] for ``march_rays`` with ``bitfield``."""
    gen = torch.Generator().manual_seed(23)
    L = M._f32(-math.log(cull_T))
    calls = []

    H = 128
    cfg = M.MarchConfig(bound=1.0, grid_size=H, max_steps=16, dt_gamma=0.0)
    dt, S = M._f32(cfg.dt_min), cfg.n_sample_slots
    p = _grid_coords(H, "cpu")
    grid = torch.zeros(H**3)
    bands = ((-1.0, -0.5, 1), (-0.5, 0.0, 8), (0.0, 0.5, S - 1), (0.5, 1.0, 2))
    for x_lo, x_hi, s_cross in bands:
        # s_cross - 1 slots before sum to below L, s_cross to above it
        c = 4.0 * L / (dt * (s_cross - 0.5))
        grid = torch.where((p[:, 0] >= x_lo) & (p[:, 0] < x_hi), c, grid)
    grid = torch.where(torch.rand(H**3, generator=gen) < 0.02, -1.0, grid)
    # slabs two cells deep (a step is 1.7 cells) among the first S steps
    z_cell = torch.floor((p[:, 2] + 1.0) * H / 2.0)
    grid = torch.where((p[:, 0] >= -0.5) & (p[:, 0] < -0.25) & (z_cell >= 5) & (z_cell <= 6),
                       float("nan"), grid)
    grid = torch.where((p[:, 0] >= 0.5) & (z_cell >= 20) & (z_cell <= 21), 1e12, grid)
    bits = torch.full((H**3 // 8,), 255, dtype=torch.uint8)
    o, d = _rays_along_z(n_rays, gen, dev, 1.0, -0.98, 0.98)
    nears, fars = _near_far(o, d, 1.0, nan_every=61)
    args = (o, d, nears, fars, None, cfg)
    for c in (cull_T, 0.0):
        calls.append(("cross" + ("" if c else "_no_cull"), args,
                      dict(t_window=(nears, fars), cull_T=c, bitfield=bits.to(dev),
                           sigma_grid=grid.to(dev) if c else None)))

    cfg = M.MarchConfig(bound=2.0, cascade=2, grid_size=H, max_steps=128,
                        dt_gamma=1.0 / 256)
    grid2 = torch.rand(2, H**3, generator=gen) * 42.0
    grid2 = torch.where(p[None, :, 0] < 0.0, grid2 * 0.1, grid2) + 1e-3
    bits2 = packbits(grid2, 0.0)
    o, d = _rays_at_cube(n_rays, gen, dev, spread=2.0)
    nears, fars = _near_far(o, d, 2.0)
    noises = torch.rand(n_rays, generator=gen).to(dev)
    args = (o, d, nears, fars, None, cfg)
    for c in (cull_T, 0.0):
        calls.append(("s128" + ("" if c else "_no_cull"), args,
                      dict(t_window=(nears, fars), cull_T=c, noises=noises,
                           bitfield=bits2.to(dev),
                           sigma_grid=grid2.reshape(-1).to(dev) if c else None)))
    return calls


# ------------------------------------------------------------- the study
# text edits of a march_rays.cu by side: (source, [(text, replacement)]),
# each text found exactly once; "parent" is PARENT_DIR's source, "this"
# this checkout's
_WALK = "  for (int kc = 0; __any_sync(kFull, live); kc += kGroup) {"
_STORES = ("    groups_out[n] = kept;\n  }\n  write_tiles(T, rays, S, n0, count_out);",
           "    groups_out[n] = kept;\n  }\n  if (N < 0) write_tiles(T, rays, S, n0, count_out);")
_FINE = ("    for (int p = 0; __any_sync(kFull, 2 * p < n_fine); ++p) {",
         "    for (int p = 0; N < 0 && __any_sync(kFull, 2 * p < n_fine); ++p) {")
# this checkout's B-grouped: the lane of rank gl finds its kept group once a
# chunk and each pass shuffles it out (in place of nth_bit in every pass)
_NTH_ONCE = [
    ("    const int n_fine = min(__popc(m_bits), max(group_slots - kept, 0));\n"
     "    for (int p = 0; __any_sync(kFull, 2 * p < n_fine); ++p) {\n"
     "      const int rank = 2 * p + gl / kMarch, i = gl % kMarch;\n",
     "    const int n_fine = min(__popc(m_bits), max(group_slots - kept, 0));\n"
     "    const int pos = nth_bit(m_bits, gl);\n"
     "    for (int p = 0; __any_sync(kFull, 2 * p < n_fine); ++p) {\n"
     "      const int rank = 2 * p + gl / kMarch, i = gl % kMarch;\n"
     "      const int gid_s = jc + __shfl_sync(kFull, pos, rank & (kGroup - 1), kGroup);\n"),
    ("        const int gid = jc + nth_bit(m_bits, rank);", "        const int gid = gid_s;")]


def _skip_chain(value, var, pred, index, pad):
    """A cull's unrolled 8-step chain of shuffles (its loop indented by pad
    spaces) -> a loop over the lanes whose pred holds in some group of the
    warp (the others add an exact 0)."""
    a, b = " " * pad, " " * (pad + 2)
    return (f"#pragma unroll\n{a}for (int {index} = 0; {index} < kGroup; ++{index}) {{\n"
            f"{b}{var} = {var} + __shfl_sync(kFull, {value}, {index}, kGroup);\n",
            f"{a}unsigned src = __ballot_sync(kFull, {pred});\n"
            f"{a}src = (src | src >> 8 | src >> 16 | src >> 24) & 0xffu;\n"
            f"{a}for (; src; src &= src - 1) {{\n{b}const int {index} = __ffs(src) - 1;\n"
            f"{b}{var} = {var} + __shfl_sync(kFull, {value}, {index}, kGroup);\n")


_SKIP_CHAINS = [_skip_chain("est", "incl_c", "m", "i", 6),
                _skip_chain("est", "incl_f", "occ", "q", 8)]
# B-bitfield: the grid value loaded once the step's slot is known selected,
# not beside the bit
_LATE_LOAD = [
    ("    uint32_t byte = 0;\n    float grid", "    uint32_t byte = 0, cell = 0;\n    float grid"),
    ("        const uint32_t cell =\n            point_cell<",
     "        cell =\n            point_cell<"),
    ("          // the cull's grid value, loaded beside the bit while the ray may\n"
     "          // still select a slot (the load does not wait on the bit)\n"
     "          if (kLookup == kBitfieldCull && count < S && grid_sum <= FLT_MAX) {\n"
     "            grid = sigma_grid[cell];\n          }\n", ""),
    ("        const float own = selected ?",
     "        if (selected) grid = sigma_grid[cell];\n        const float own = selected ?")]
# B-bitfield's chain as a loop over the lanes that select in some ray
_SKIP_CHAIN_BITS = [_skip_chain("own", "grid_sum", "selected", "j", 8)]
EDITS = {
    "parent": ("parent", []),
    "parent_no_stores": ("parent", [_STORES]),
    "parent_no_fine": ("parent", [_FINE]),
    "parent_coarse_only": ("parent", [_FINE, _STORES]),
    # B-bitfield's walk off: the tile's zeros go out; with every slot of the
    # tile taken as selected, the cull pass alone on them
    "parent_walk_off": ("parent", [(_WALK, _WALK.replace("for (int kc = 0; ",
                                                         "for (int kc = 0; N < 0 && "))]),
    "parent_cull_alone": ("parent", [
        (_WALK, _WALK.replace("for (int kc = 0; ", "for (int kc = 0; N < 0 && ")),
        ("    const int n_valid = min(count, S);", "    const int n_valid = S;")]),
    # this checkout's: B-grouped, the parent's design at B's occupancy;
    # B-bitfield, the cull in the walk (its grid value loaded beside the bit)
    "this": ("this", []),
    "this_no_stores": ("this", [_STORES]),
    "this_nth_once": ("this", _NTH_ONCE),
    "this_skip_chains": ("this", _SKIP_CHAINS),
    "this_late_load": ("this", _LATE_LOAD),
    "this_skip_chain": ("this", _SKIP_CHAIN_BITS),
    # the third design: nth_once, skip_chains and skip_chain together
    "this_v3": ("this", _NTH_ONCE + _SKIP_CHAINS + _SKIP_CHAIN_BITS),
    # the first designs of this redesign: one coarse group a lane, each lane
    # fine-marching its group's 4 steps at B's occupancy. march_lane_registers
    # .cu holds the 4 fine estimates in registers (they spill at 32), runs the
    # fine pass where no lane of the warp marches, and loads B-bitfield's
    # grid value after the ballot of its bit; march_lane_shared.cu keeps the
    # estimates in shared memory, skips the empty fine passes, and loads the
    # grid value beside the bit (both B-bitfield cull designs in the walk,
    # one instantiation for the bitfield with and without the cull)
    "lane_registers": ("lane_registers", []),
    "lane_shared": ("lane_shared", []),
    # a block's tile may opt in up to 96 KB before its rays are halved: 32
    # rays at S = 128
    "this_rays32": ("this", [(
        "  while (R > 32 / kGroup && tile_layout(R, S).bytes > kDefaultSmem) R /= 2;",
        "  while (R > 32 / kGroup && tile_layout(R, S).bytes > 2 * kDefaultSmem) R /= 2;")]),
}
TIMED_ONLY = ("parent_no_stores", "parent_no_fine", "parent_coarse_only", "parent_walk_off",
              "parent_cull_alone", "this_no_stores")
# the sides timed on each kind of call ("B": this checkout's kernel B on the
# same rays and sigma bytes; "<side>_no_cull": B-bitfield without the cull)
GROUPED_SIDES = ("this", "parent", "parent_no_stores", "parent_no_fine", "parent_coarse_only",
                 "this_no_stores", "this_nth_once", "this_skip_chains", "this_v3",
                 "lane_registers", "lane_shared", "B")
BITFIELD_SIDES = ("this", "this_no_cull", "parent", "parent_no_cull", "parent_walk_off",
                  "parent_cull_alone", "this_late_load", "this_skip_chain", "this_v3",
                  "lane_shared", "B")


def build_sides(sources: dict, out: Path) -> dict:
    """{tag: source text} -> {tag: (ctypes library, ptxas lines)}, one nvcc
    each, all started at once."""
    from ..ops import _kernels

    procs = {}
    for tag, text in sources.items():
        d = out / tag
        d.mkdir(parents=True, exist_ok=True)
        (d / "march_rays.cu").write_text(text)
        so = d / "lib.so"
        procs[tag] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so), str(d / "march_rays.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    entry = {**_kernels.KERNELS["march_rays"].entry_points,
             **_kernels.KERNELS["march_rays_grouped"].entry_points}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        lib = ctypes.CDLL(str(so.resolve()))
        for fn, argtypes in entry.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        libs[tag] = (lib, ptxas_lines(log))
    return libs


def ptxas_lines(log: str) -> list:
    """A build log's register and spill lines, each under its kernel's name."""
    return [s.strip() for s in log.splitlines()
            if "Function properties" in s or "registers" in s or "spill" in s]


def with_library(kernel: str, lib, fn):
    """fn() with ``kernel``'s library swapped for lib (None: this
    checkout's own), so every side runs through the same wrapper."""
    from ..ops import _kernels

    k = _kernels.KERNELS[kernel]
    own = k._load()
    k._lib = own if lib is None else lib
    try:
        return fn()
    finally:
        k._lib = own


def frame_calls(S, dev):
    """The march_variants phase's frames: for the sparse and the portrait
    scene at FRAME_SIZE x FRAME_SIZE, (name, the grouped call's args,
    cull_T); and the bench frame's B-bitfield call at K = 129: (args,
    kwargs, its sigma bytes and cull_T for B)."""
    from ..models import render_rays
    from ..models.renderer import march_window
    from ..scene import build_scene, build_sparse_scene

    frames, bench = [], None
    for name, build in (("sparse", build_sparse_scene), ("portrait", build_scene)):
        net, rc, state, b, auds = build(FRAME_SIZE, FRAME_SIZE, device=dev)
        span = int(render_rays(net, rc, state, b["rays_o"], b["rays_d"], auds[0],
                               b["bg_coords"], b["poses"], b["eye"], b["index"],
                               b["bg_color"])[0]["n_k_span"])
        K = min(S.MARCH_K_CAP, span + span % 2)
        mcfg = dataclasses.replace(rc, march_iters=K).march_config()
        o, d = b["rays_o"], b["rays_d"]
        nears, fars = near_far_from_aabb(o, d, o.new_tensor(rc.aabb), rc.min_near)
        window = march_window(state, o, d, nears, fars)
        frames.append((name, (o, d, nears, fars, state.sigma_bytes, state.coarse_bytes, mcfg,
                              window), rc.cull_T))
        if name == "portrait":
            bench = ((o, d, nears, fars, None, rc.march_config()),
                     dict(t_window=window, cull_T=S.BITFIELD_CULL_T,
                          bitfield=state.density_bitfield, sigma_grid=state.density_grid),
                     state.sigma_bytes, rc.cull_T)
        del net, auds
    return frames, bench


def s128_call(dev, bench_args, cull_T):
    """S = 128: the variants run's march (bound 2, cascade 2, max_steps 128,
    dt_gamma 1/256: the general orbit, K = 257) on the bench camera's rays
    and their bound-2 box, over a seeded float grid U(0.001, 1.001) at both
    levels: every cell occupied and no sample culled, as on the variants
    eval frame. Returns (args, kwargs, sigma bytes for B)."""
    o, d = bench_args[:2]
    cfg = M.MarchConfig(bound=2.0, cascade=2, grid_size=128, max_steps=128,
                        dt_gamma=1.0 / 256)
    grid = (torch.rand(2 * 128**3, generator=torch.Generator().manual_seed(5)) + 1e-3).to(dev)
    nears, fars = _near_far(o, d, 2.0)
    return ((o, d, nears, fars, None, cfg),
            dict(t_window=(nears, fars), cull_T=cull_T, bitfield=packbits(grid, 0.0),
                 sigma_grid=grid),
            M.build_sigma_bytes(grid, 0.0))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("march study: no CUDA device", file=sys.stderr)
        sys.exit(1)
    parent = Path(argv[0]).resolve()
    out_json = Path(argv[1])
    out_json.parent.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as S

    from ..ops import _kernels, march_rays, march_rays_grouped

    dev = torch.device("cuda")
    result = {"nvidia_smi": S.nvidia_smi_line(), "parent": str(parent)}

    def save(**parts):
        result.update(parts)
        out_json.write_text(json.dumps(result, indent=1))

    texts = {"parent": (parent / "radnerf_tpu_torch/csrc/march_rays.cu").read_text(),
             "this": _kernels.KERNELS["march_rays"].source.read_text(),
             "lane_registers": (HERE / "march_lane_registers.cu").read_text(),
             "lane_shared": (HERE / "march_lane_shared.cu").read_text()}
    sources = {tag: edited(texts[src], edits) for tag, (src, edits) in EDITS.items()}
    build = HERE.parents[1] / "build" / "study_march"
    libs = build_sides(sources, build)
    _kernels.build_all()
    result["ptxas"] = {tag: lines for tag, (_, lines) in libs.items()}
    save()
    lib = {tag: lib for tag, (lib, _) in libs.items()}

    frames, (bench_args, bench_kw, bench_sb, bench_cull) = frame_calls(S, dev)
    s_args, s_kw, s_sb = s128_call(dev, bench_args, S.BITFIELD_CULL_T)
    calls, rows = [], []
    for name, args, cull_T in frames:
        calls.append(("grouped", name, args, dict(cull_T=cull_T)))
    # B-bitfield's calls carry B's sigma bytes and cull_T for B's side
    calls.append(("bitfield", "bench_frame", bench_args,
                  dict(bench_kw, sigma_bytes=bench_sb, cull_T_b=bench_cull)))
    calls.append(("bitfield", "s128", s_args, dict(s_kw, sigma_bytes=s_sb, cull_T_b=bench_cull)))

    for kind, name, args, kw in calls:
        if kind == "grouped":
            cfg, window = args[6], args[7]
            b_args, b_kw = (*args[:5], cfg, window, kw["cull_T"]), {}
            want = want_no_cull = M.march_rays_grouped_plain(*args, None, **kw)
            keys, sides = ("t", "dt", "valid", "xyz", "count", "groups"), GROUPED_SIDES

            def side(tag, args=args, kw=kw):
                return lambda: with_library("march_rays_grouped", lib[tag],
                                            lambda: march_rays_grouped(*args, None, **kw))
        else:
            kw = dict(kw)
            b_cull, sb = kw.pop("cull_T_b"), kw.pop("sigma_bytes")
            cfg = args[5]
            b_args = (*args[:4], sb, cfg)
            b_kw = dict(t_window=kw["t_window"], cull_T=b_cull, noises=kw.get("noises"))
            want = M.march_rays_plain(*args, **kw)
            want_no_cull = M.march_rays_plain(*args, **dict(kw, cull_T=0.0, sigma_grid=None))
            keys = ("t", "dt", "valid", "xyz", "count")
            sides = BITFIELD_SIDES + (("this_rays32",) if name == "s128" else ())

            def side(tag, args=args, kw=kw):
                if tag.endswith("_no_cull"):
                    tag, kw = tag[:-len("_no_cull")], dict(kw, cull_T=0.0, sigma_grid=None)
                return lambda: with_library("march_rays_bitfield", lib[tag],
                                            lambda: march_rays(*args, **kw))
        bb = {"B": lambda: march_rays(*b_args, **b_kw),
              "parent_B": lambda: with_library("march_rays", lib["parent"],
                                               lambda: march_rays(*b_args, **b_kw))}
        fns = {tag: bb["B"] if tag == "B" else side(tag) for tag in sides}
        row = {"kind": kind, "call": name, "n_rays": int(args[0].shape[0]),
               "K": cfg.n_march_iters, "S": cfg.n_sample_slots,
               "n_samples": int(want["valid"].sum()), "differing_from_twin": {}}
        for tag, fn in fns.items():
            if tag != "B":
                got, twin = fn(), want_no_cull if tag.endswith("_no_cull") else want
                bad = [k for k in keys if not torch.equal(got[k], twin[k])]
                row["differing_from_twin"][tag] = bad
                if bad and tag not in TIMED_ONLY:
                    raise RuntimeError(f"{name}: {tag} differs from its twin in {bad}")
        mine, theirs = bb["B"](), bb["parent_B"]()
        if not all(torch.equal(mine[k], theirs[k]) for k in mine):
            raise RuntimeError(f"{name}: B differs from the parent's B")
        torch.cuda.synchronize()
        row["device_ms_in_turns"] = in_turns(S, fns)
        row["B_in_turns"] = in_turns(S, bb)
        mean = {t: sum(v) / len(v) for t, v in row["device_ms_in_turns"].items()}
        row["ratio_to_parent"] = {t: mean[t] / mean["parent"] for t in mean}
        row["ratio_to_B"] = {t: mean[t] / mean["B"] for t in mean}
        bm = {t: sum(v) / len(v) for t, v in row["B_in_turns"].items()}
        row["B_over_parent_B"] = bm["B"] / bm["parent_B"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        save(calls=rows)
    print(json.dumps({"ok": True, "nvidia_smi": result["nvidia_smi"]}), flush=True)


if __name__ == "__main__":
    main()
