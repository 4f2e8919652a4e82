"""Attribution study of kernels A-bf16 and A'-bf16 (the -O policy's grid
encode and its gradient) on the card, on the tensors the -O path records.

    python3 -m radnerf_tpu_torch.studies.grid_bf16 PARENT_DIR OUT_JSON

Run from the root of a checkout on one NVIDIA GPU; PARENT_DIR is a checkout
of the commit before A-bf16's packed rows (its A-bf16 reads the bf16 table
row by row through ``grid_encode_fwd_bf16``), e.g. unpacked by ``git archive
<rev> | tar -x -C build/parent``. Records the calls of the -O frame and the
-O head step as ``chip_smoke.py``'s bf16_frame and bf16_train phases make
them (a 512x512 processed-video directory written in a temporary place),
adds as many points spread uniformly over each grid's box, and times each
side in turns on the same tensors (``chip_smoke.device_ms``, order a, b,
..., b, a):

- A-bf16: the parent's row layout; (b) with every corner read from the
  level's first row pair (the arithmetic without the scatter); (c) with its
  bf16 rounding hooks set to the identity; this checkout's kernel on the
  corner-packed copy, with its packing pass ("this") and on a kept copy
  ("this_cached"), and the packing pass alone;
- A'-bf16: the parent's kernel; (b) its atomics replaced by plain stores;
  (c) its adds restricted to the dense levels, then to the 65,536-row
  levels; this checkout's kernel (pair-keyed reductions); its x gradient
  alone; the level-major design (``grid_level_major.cu``) at cluster sizes
  4 and 8;
- float32 A' on the step's points widened: the parent's kernel against the
  level-major design;
- (d) the rate of float4 reductions into device memory on the step's own
  row pairs and on as many uniform ones, and of a row pair's four float32
  adds into a cluster's distributed shared memory at cluster sizes 1-8
  (``reduction_rates.cu``); the reduction floor of the parent's A'-bf16
  and of this checkout's on each step call and its spread points
  (``reduction_floor``: a design's own issued reductions replayed alone);
- each library's registers (``-Xptxas -v``) and each grid kernel's SASS
  instruction count (``cuobjdump -sass``; one (point, level) a thread).

The attribution variants are copies of the parent's sources with one text
replaced (EDITS); they compute wrong results by design and are timed only.
Every other side is held to the plain versions with chip_smoke's
tolerances. Writes OUT_JSON after each call studied.
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

HERE = Path(__file__).resolve().parent
# text edits of the parent's sources, by side: (file, text, replacement),
# each text found exactly once
EDITS = {
    "stores": [("grid_encode_backward.cu",
                "    atomicAdd(reinterpret_cast<float4*>(table + r0), v);",
                "    *reinterpret_cast<float4*>(table + r0) = v;"),
               ("grid_encode_backward.cu",
                "    atomicAdd(table + r0, make_float2(v.x, v.y));\n"
                "    atomicAdd(table + r1, make_float2(v.z, v.w));",
                "    table[r0] = make_float2(v.x, v.y);\n"
                "    table[r1] = make_float2(v.z, v.w);")],
    "dense_levels": [("grid_encode_backward.cu",
                      "if (grad_table != nullptr) add_pair(",
                      "if (grad_table != nullptr && lv.size != 65536u) add_pair(")],
    "wrapped_levels": [("grid_encode_backward.cu",
                        "if (grad_table != nullptr) add_pair(",
                        "if (grad_table != nullptr && lv.size == 65536u) add_pair(")],
    # the row index still computed (N >> 31 is 0 at run time), its row not read
    "fixed_row": [("grid_encode.cu",
                   "grid::load_pair<T>(emb, grid::corner_row<D>(lv, pg, c0),\n"
                   "                         grid::corner_row<D>(lv, pg, c0 + 1), e0, e1);",
                   "grid::load_pair<T>(emb, lv.offset + (grid::corner_row<D>(lv, pg, c0) &"
                   " (uint32_t)(N >> 31)),\n"
                   "                         lv.offset + 1 + (grid::corner_row<D>(lv, pg, c0 + 1)"
                   " & (uint32_t)(N >> 31)), e0, e1);")],
    "no_rounding": [("grid_common.cuh",
                     "  __device__ static float weight(float w) { return round_bf16(w); }\n"
                     "  __device__ static float term(float v) { return round_bf16(v); }",
                     "  __device__ static float weight(float w) { return w; }\n"
                     "  __device__ static float term(float v) { return v; }")],
}
# the parent's libraries: (tag, source, edits)
PARENT_SIDES = [("fwd_parent", "grid_encode.cu", ()),
                ("fwd_fixed_row", "grid_encode.cu", ("fixed_row",)),
                ("fwd_no_rounding", "grid_encode.cu", ("no_rounding",)),
                ("bwd_parent", "grid_encode_backward.cu", ()),
                ("bwd_stores", "grid_encode_backward.cu", ("stores",)),
                ("bwd_dense_levels", "grid_encode_backward.cu", ("dense_levels",)),
                ("bwd_wrapped_levels", "grid_encode_backward.cu", ("wrapped_levels",))]
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_BWD = [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _P]
# the parent's C entry points (its A-bf16 on the row layout)
ENTRY_POINTS = {"fwd": {"grid_encode_fwd_bf16": [_P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _P]},
                "bwd": {"grid_encode_bwd_bf16": _BWD, "grid_encode_bwd": _BWD}}
STUDY_SOURCES = {  # library -> (source, its C entry points)
    "reduction_rates": ("reduction_rates.cu", {
        "run_red_global_f4": [_P, _P, _L, _P],
        "run_red_cluster": [_P, _L, _I, _I, _P, ctypes.POINTER(_I), _P]}),
    "grid_level_major": ("grid_level_major.cu", {
        "grid_encode_bwd_level_major": [_P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _I, _I, _P]}),
}
TORSO_POINTS = 65536  # a torso step's pixels


def _nvcc_flags():
    from radnerf_tpu_torch.ops import _kernels
    return [_kernels._nvcc(), *_kernels.NVCC_FLAGS]


def _load(so: Path, entry_points: dict):
    lib = ctypes.CDLL(str(so.resolve()))
    for fn, argtypes in entry_points.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    return lib


def _start(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc, what):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n{log}")
    return [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]


def study_library(name: str, out: Path = HERE.parents[1] / "build" / "study"):
    """One of the study's own libraries (STUDY_SOURCES), built with the
    port's flags and its csrc headers; returns the ctypes library."""
    source, entry_points = STUDY_SOURCES[name]
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{name}.so"
    _finish(_start([*_nvcc_flags(), "-I", str(HERE.parent / "csrc"), "-o", str(so),
                    str(HERE / source)]), name)
    return _load(so, entry_points)


def build_parent_sides(parent_csrc: Path, out: Path):
    """The parent's libraries and their variants, one nvcc each, all at
    once: {tag: (ctypes library, ptxas lines, .so path)}."""
    procs = {}
    for tag, source, edits in PARENT_SIDES:
        d = out / tag
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(parent_csrc, d)
        for name in edits:
            for file, text, repl in EDITS[name]:
                f = d / file
                body = f.read_text()
                if body.count(text) != 1:
                    raise RuntimeError(f"the parent's {file} does not hold the {name} text once")
                f.write_text(body.replace(text, repl))
        so = d / "lib.so"
        procs[tag] = (so, _start([*_nvcc_flags(), "-o", str(so), str(d / source)]))
    libs = {}
    for tag, (so, proc) in procs.items():
        log = _finish(proc, tag)
        libs[tag] = (_load(so, ENTRY_POINTS[tag[:3]]), log, so)
    return libs


def sass_counts(so: Path) -> dict:
    """Instructions of each grid-encode kernel function in a library's SASS
    (cuobjdump -sass), by mangled name."""
    cuobjdump = Path(_nvcc_flags()[0]).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return {k: v for k, v in counts.items() if "grid_encode" in k or "pack" in k}


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def in_turns(S, fns: dict, reps=20) -> dict:
    """chip_smoke.device_ms of each fn in the order a, b, ..., ..., b, a:
    {tag: [first, second]}."""
    order = list(fns) + list(fns)[::-1]
    got = {t: [] for t in fns}
    for t in order:
        got[t].append(S.device_ms(fns[t], reps))
    return got


def record_calls(S, out_dir):
    """The -O frame's grid-encode calls and one -O head step's A-bf16 and
    A'-bf16 calls, as chip_smoke records them."""
    from radnerf_tpu_torch.scene import build_scene

    net, rc, state, b, auds = build_scene(512, 512, device="cuda")
    report = {"train_timing": {"train_step_ms_median": None,
                               "profile": {"device_busy_ms_per_step": None,
                                           "ms_per_step_by_class": None}}}
    with tempfile.TemporaryDirectory() as root:
        S.write_dataset(root, (net, rc, state, b))
        frame_calls = S.bf16_frame_phase(report, out_dir, (net, rc, state, b), auds)
        step_calls = S.bf16_train_phase(report, out_dir, root)
    torch.cuda.empty_cache()
    return frame_calls, step_calls


def spread(x, bound, seed):
    """As many points as x, uniform over the grid's box."""
    gen = torch.Generator(x.device).manual_seed(seed)
    return (torch.rand(x.shape, generator=gen, device=x.device) * 2.0 - 1.0) * bound


def forward_cases(frame_calls, step_calls):
    """(where, x, bf16 table, spec, bound) of every A-bf16 call studied."""
    cases = []
    for where, calls in (("frame", frame_calls), ("step", step_calls)):
        for name, args, kw in calls:
            if name == "grid_encode":
                x, table, spec, bound = args
                cases.append((where, x, table.to(torch.bfloat16), spec, bound))
    for i, (where, x, tb, spec, bound) in enumerate(list(cases)):
        if where == "step":
            cases.append(("spread", spread(x, bound, 10 + i), tb, spec, bound))
    return cases


def backward_cases(step_calls):
    """(where, x, bf16 table, bf16 grad_out, spec, bound, need_x) of every
    A'-bf16 call studied: the step's, as many spread points with the same
    grad_out, and the step's first TORSO_POINTS points of the x-gradient
    call."""
    cases = []
    for name, args, kw in step_calls:
        if name != "grid_encode":
            x, table, grad_out, spec, bound = args
            cases.append(("step", x, table, grad_out, spec, bound, kw["need_x"]))
    for i, (where, x, tb, go, spec, bound, need_x) in enumerate(list(cases)):
        cases.append(("spread", spread(x, bound, 20 + i), tb, go, spec, bound, need_x))
        if need_x:
            cases.append(("torso_size", x[:TORSO_POINTS].contiguous(), tb,
                          go[:TORSO_POINTS].contiguous(), spec, bound, need_x))
    return cases


def study_forward(S, libs, cases, save):
    from radnerf_tpu_torch.ops import grid_encode, grid_encode_plain, pack_table
    from radnerf_tpu_torch.ops.grid_encode import _level_tables

    rows = []
    for where, x, tb, spec, bound in cases:
        want = grid_encode_plain(x, tb, spec, bound)
        D, L = spec.input_dim, spec.num_levels
        scales, params = _level_tables(spec, x.device)
        out = torch.empty_like(want)
        packed = pack_table(tb, spec)
        fns = {"this": lambda: grid_encode(x, tb, spec, bound),
               "this_cached": lambda: grid_encode(x, tb, spec, bound, packed=packed),
               "pack": lambda: pack_table(tb, spec)}
        for tag in ("fwd_parent", "fwd_fixed_row", "fwd_no_rounding"):
            def row_layout(lib=libs[tag][0]):
                _check(lib.grid_encode_fwd_bf16(
                    x.data_ptr(), tb.data_ptr(), scales.data_ptr(), params.data_ptr(),
                    out.data_ptr(), x.shape[0], D, L, float(bound),
                    float(np.float32(2.0 * bound)), _stream()), "grid_encode_fwd_bf16")
                return out
            fns[tag] = row_layout
        errs = {}
        for tag in ("this", "this_cached", "fwd_parent"):
            ulps, n_diff = S.bf16_ulp_err(fns[tag](), want)
            errs[tag] = {"max_err_ulps": ulps, "elements_differing": n_diff}
        torch.cuda.synchronize()
        rows.append({"where": where, "D": D, "n_points": int(x.shape[0]),
                     "errors": errs, "device_ms_in_turns": in_turns(S, fns),
                     "bound_ms": S.bound_ms(*S.grid_work(x, spec, bound, elem=2))[0]})
        print(json.dumps({"A_bf16": rows[-1]}), flush=True)
        save(A_bf16=rows)
    return rows


def backward_errors(S, got, want, x, tb, go, spec, bound, need_x):
    """chip_smoke's A'-bf16 check: the table gradient over each row's bound
    2 (n - 1) 2^-24 sum|terms|, the x gradient's error over its largest."""
    from radnerf_tpu_torch.ops import grid_encode_backward_plain

    counts = S.row_counts(x, spec, bound)[0]
    abs_rows = grid_encode_backward_plain(x, tb, go.abs(), spec, bound, need_x=False)[0]
    row_bound = 2.0 * (counts.double() - 1).clamp_min(1)[:, None] * 2.0**-24 \
        * abs_rows.double()
    over = float(((got[0] - want[0]).abs().double() / row_bound.clamp_min(1e-300)).max())
    err = {"table_err_over_row_bound": over}
    if need_x:
        err["x_rel_err"] = S.rel_err(got[1], want[1])
    return err


def parent_backward(lib, x, tb, go, spec, bound, need_x):
    """The parent's A' (float32 grad_out) or A'-bf16 (bf16) through its own
    C entry point: the table gradient into a zeroed [n_emb, 2] float32
    buffer, and x's when need_x."""
    from radnerf_tpu_torch.ops.grid_encode import _level_tables

    scales, params = _level_tables(spec, x.device)
    fn = lib.grid_encode_bwd_bf16 if go.dtype == torch.bfloat16 else lib.grid_encode_bwd

    def run():
        g_table = torch.zeros((spec.n_embeddings, 2), dtype=torch.float32, device=x.device)
        g_x = torch.empty_like(x) if need_x else None
        _check(fn(x.data_ptr(), tb.data_ptr(), go.data_ptr(), scales.data_ptr(),
                  params.data_ptr(), g_table.data_ptr(), g_x.data_ptr() if need_x else None,
                  x.shape[0], spec.input_dim, spec.num_levels, float(bound),
                  float(np.float32(2.0 * bound)), _stream()), "the parent's A'")
        return g_table, g_x
    return run


def level_major_fn(lm, x, tb, go, spec, bound, need_x, cluster):
    """The level-major design: its table gradient, and for need_x the x
    gradient of this checkout's A'-bf16 alone (the point-major pass)."""
    from radnerf_tpu_torch.ops import grid_encode_backward
    from radnerf_tpu_torch.ops.grid_encode import _level_tables

    scales, params = _level_tables(spec, x.device)

    def run():
        g_table = torch.zeros((spec.n_embeddings, 2), dtype=torch.float32, device=x.device)
        _check(lm.grid_encode_bwd_level_major(
            x.data_ptr(), go.data_ptr(), scales.data_ptr(), params.data_ptr(),
            g_table.data_ptr(), x.shape[0], spec.input_dim, spec.num_levels, float(bound),
            float(np.float32(2.0 * bound)), int(go.dtype == torch.bfloat16), cluster,
            _stream()), "grid_encode_bwd_level_major")
        g_x = grid_encode_backward(x, tb, go, spec, bound, need_table=False)[1] \
            if need_x else None
        return g_table, g_x
    return run


def study_backward(S, libs, lm, cases, save, float32=False):
    """A'-bf16 (or, with float32, A' on the same values widened) on each
    case: the parent's kernel and its variants through this checkout's
    wrapper, the x gradient alone, the level-major design."""
    from radnerf_tpu_torch.ops import grid_encode_backward, grid_encode_backward_plain

    kernel = "grid_encode_backward" if float32 else "grid_encode_backward_bf16"
    rows = []
    for where, x, tb, go, spec, bound, need_x in cases:
        if float32:
            tb, go = tb.float(), go.float()
        want = grid_encode_backward_plain(x, tb, go, spec, bound, need_x=need_x)
        tags = ["bwd_parent"] if float32 else [t for t, _, _ in PARENT_SIDES
                                               if t.startswith("bwd")]
        fns = {tag: parent_backward(libs[tag][0], x, tb, go, spec, bound, need_x)
               for tag in tags}
        if not float32:
            fns["this"] = lambda: grid_encode_backward(x, tb, go, spec, bound, need_x=need_x)
        if need_x and not float32:
            fns["x_only"] = lambda: grid_encode_backward(x, tb, go, spec, bound,
                                                         need_table=False)
        for cluster in ((4,) if float32 else (4, 8)):
            fns[f"level_major{cluster}"] = level_major_fn(lm, x, tb, go, spec, bound, need_x,
                                                          cluster)
        errs = {tag: backward_errors(S, fns[tag](), want, x, tb, go, spec, bound, need_x)
                for tag in fns if tag.startswith(("bwd_parent", "this", "level_major"))}
        torch.cuda.synchronize()
        nb, nf = S.grid_backward_work(x, spec, bound, need_x, elem=4 if float32 else 2)
        counts = S.row_counts(x, spec, bound)[0]
        rows.append({"where": where, "D": spec.input_dim, "n_points": int(x.shape[0]),
                     "x_grad": need_x, "errors": errs, "device_ms_in_turns": in_turns(S, fns),
                     "bound_ms": S.bound_ms(nb, nf)[0],
                     "rows_touched": int((counts > 0).sum()),
                     "busiest_row_contributions": int(counts.max())})
        print(json.dumps({kernel: rows[-1]}), flush=True)
        save(**{kernel: rows})
    return rows


def corner_pairs(x, spec, bound):
    """Rows r0 of corner 2q and r1 of corner 2q + 1 of every (point, level,
    q), int64 [N, L, 2^(D-1)] each; -1 at points outside the box."""
    from radnerf_tpu_torch.ops.grid_encode import _corner_index

    D, L = spec.input_dim, spec.num_levels
    x01 = (x + bound) / (2.0 * bound)
    live = ((x01 >= 0) & (x01 <= 1)).all(dim=-1)
    r0, r1 = [], []
    for level in range(L):
        pg = torch.floor(x01 * spec.level_scale(level) + 0.5).long()
        for c0 in range(0, 1 << D, 2):
            for out, c in ((r0, c0), (r1, c0 + 1)):
                bits = torch.tensor([(c >> d) & 1 for d in range(D)], device=x.device)
                row = _corner_index(spec, level, pg + bits) + spec.offsets[level]
                out.append(torch.where(live, row, -1))
    shape = (x.shape[0], L, 1 << (D - 1))
    return torch.stack(r0, 1).reshape(shape), torch.stack(r1, 1).reshape(shape)


def issued_reductions(x, spec, bound, keyed=False):
    """The 16-byte slots (row // 2) of the global reductions kernel A'
    issues on these points, in its order (warp by warp of 32 consecutive
    points at one level; per corner pair, one reduction for each run of
    lanes with equal rows, two where the rows are not an aligned pair),
    int32; with ``keyed``, A'-bf16's (one reduction a run, into the pair
    key of its first row: slot r0)."""
    r0, r1 = corner_pairs(x, spec, bound)
    N, L, P = r0.shape
    pad = (-N) % 32
    if pad:
        r0 = torch.cat([r0, r0.new_full((pad, L, P), -1)])
        r1 = torch.cat([r1, r1.new_full((pad, L, P), -1)])
    # [warp, level, pair, lane]
    r0 = r0.reshape(-1, 32, L, P).permute(0, 2, 3, 1)
    r1 = r1.reshape(-1, 32, L, P).permute(0, 2, 3, 1)
    head = torch.ones_like(r0, dtype=torch.bool)
    head[..., 1:] = (r0[..., 1:] != r0[..., :-1]) | (r1[..., 1:] != r1[..., :-1])
    issue = head & (r0 >= 0)
    if keyed:
        return r0[issue].to(torch.int32)
    aligned = (r1 == r0 + 1) & (r0 % 2 == 0)
    first = torch.where(issue, r0 // 2, -1)
    second = torch.where(issue & ~aligned, r1 // 2, -1)
    pairs = torch.stack([first, second], dim=-1).reshape(-1)
    return pairs[pairs >= 0].to(torch.int32)


def reduction_floor(rates, x, spec, bound, timer, keyed=True):
    """A'-bf16's reduction floor on these points: the float4 reductions
    into device memory it issues (``issued_reductions``; with ``keyed``
    False, the point-major row-pair design's before it) replayed alone in
    its order on a zeroed buffer (``run_red_global_f4`` of the
    ``reduction_rates`` library), timed by ``timer(fn, reps)`` (chip_smoke's
    ``device_ms``). Returns (reductions, ms)."""
    pairs = issued_reductions(x, spec, bound, keyed)
    table = torch.zeros((spec.n_embeddings, 4), dtype=torch.float32, device=x.device)

    def run():
        _check(rates.run_red_global_f4(pairs.data_ptr(), table.data_ptr(), pairs.numel(),
                                       _stream()), "run_red_global_f4")
    return int(pairs.numel()), timer(run, 5)


def study_rates(S, lib, x, spec, bound):
    """(d): float4 reductions into device memory a ms, on the step's own
    row pairs (point-major order, and shuffled) and on as many uniform
    ones; a row pair's four float32 adds into distributed shared memory a
    ms at cluster sizes 1, 2, 4, 8 (65,536 rows a cluster, 8,192 pairs at
    size 1 and 16,384 at size 2, what one and two blocks hold), on uniform
    pairs and on the step's middle level's own."""
    r0 = corner_pairs(x, spec, bound)[0]
    r0 = r0[(r0 >= 0).all(dim=-1).all(dim=-1)]
    pairs = (r0 // 2).reshape(-1).to(torch.int32)
    mid = ((r0[:, spec.num_levels // 2] - spec.offsets[spec.num_levels // 2]) // 2)
    mid = mid.reshape(-1).to(torch.int32)
    n = pairs.numel()
    gen = torch.Generator(x.device).manual_seed(30)
    n_pairs = spec.n_embeddings // 2
    lists = {"step_order": pairs,
             "step_shuffled": pairs[torch.randperm(n, generator=gen, device=x.device)],
             "uniform": torch.randint(0, n_pairs, (n,), generator=gen, device=x.device,
                                      dtype=torch.int32)}
    table = torch.zeros((n_pairs, 4), dtype=torch.float32, device=x.device)
    res = {"reductions": n, "global_f4": {}, "cluster_f32": {}}
    for name, idx in lists.items():
        def run(idx=idx):
            _check(lib.run_red_global_f4(idx.data_ptr(), table.data_ptr(), idx.numel(),
                                         _stream()), "run_red_global_f4")
        ms = S.device_ms(run, 5)
        res["global_f4"][name] = {"ms": ms, "per_ms": n / ms}
    out = torch.zeros((1056, 4), dtype=torch.float32, device=x.device)
    n_clusters = ctypes.c_int(0)
    uniform = torch.randint(0, 1 << 15, (n,), generator=gen, device=x.device,
                            dtype=torch.int32)
    mid = mid.repeat((n + mid.numel() - 1) // mid.numel())[:n].contiguous()
    for cs in (1, 2, 4, 8):
        cp = {1: 8192, 2: 16384}.get(cs, 32768)
        for name, idx in (("uniform", uniform), ("level_mid", mid)):
            def run(idx=idx, cs=cs, cp=cp):
                _check(lib.run_red_cluster(idx.data_ptr(), idx.numel(), cs, cp, out.data_ptr(),
                                           ctypes.byref(n_clusters), _stream()),
                       f"run_red_cluster({cs})")
            ms = S.device_ms(run, 5)
            res["cluster_f32"][f"cs{cs}_{name}"] = {
                "ms": ms, "pair_adds_per_ms": n / ms, "clusters": n_clusters.value,
                "pairs_a_cluster": cp}
    print(json.dumps({"rates": res}), flush=True)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("grid_bf16 study: no CUDA device", file=sys.stderr)
        sys.exit(1)
    parent = Path(argv[0]).resolve()
    out_json = Path(argv[1])
    out_json.parent.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as S

    from radnerf_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    build = HERE.parents[1] / "build" / "study"
    build.mkdir(parents=True, exist_ok=True)
    result = {"nvidia_smi": S.nvidia_smi_line(), "parent": str(parent)}

    def save(**parts):
        result.update(parts)
        out_json.write_text(json.dumps(result, indent=1))

    libs = build_parent_sides(parent / "radnerf_tpu_torch/csrc", build)
    rates, lm = study_library("reduction_rates", build), study_library("grid_level_major", build)
    logs = _kernels.build_all()
    result["ptxas"] = {tag: log for tag, (_, log, _) in libs.items()}
    result["ptxas"]["this"] = {k: [line.strip() for line in v.splitlines() if "registers" in line]
                               for k, v in logs.items()}
    result["sass_instructions"] = {
        "fwd_parent": sass_counts(libs["fwd_parent"][2]),
        "bwd_parent": sass_counts(libs["bwd_parent"][2]),
        "this": sass_counts(_kernels.KERNELS["grid_encode_bf16"].library_path())}
    save()

    frame_calls, step_calls = record_calls(S, str(out_json.parent))
    fwd, bwd = forward_cases(frame_calls, step_calls), backward_cases(step_calls)
    del frame_calls, step_calls
    study_forward(S, libs, fwd, save)
    floors = []
    for where, x, tb, go, spec, bound, need_x in bwd:
        if where != "torso_size":
            row = {"where": where, "D": spec.input_dim}
            for design, keyed in (("parent", False), ("this", True)):
                n, ms = reduction_floor(rates, x, spec, bound, S.device_ms, keyed)
                row[design] = {"reductions": n, "floor_ms": ms}
            floors.append(row)
            print(json.dumps({"reduction_floor": row}), flush=True)
    save(reduction_floor=floors)
    d3 = next(c for c in bwd if c[0] == "step" and c[4].input_dim == 3)
    save(rates=study_rates(S, rates, d3[1], d3[4], d3[5]))
    study_backward(S, libs, lm, bwd, save)
    study_backward(S, libs, lm, [c for c in bwd if c[0] == "step"], save, float32=True)
    print(json.dumps({"ok": True, "nvidia_smi": result["nvidia_smi"]}), flush=True)


if __name__ == "__main__":
    main()
