"""Build and load the hand-written CUDA kernels (``radnerf_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled on first use by one ``nvcc`` into its
own shared library with a plain C interface, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -fmad=false
         -DGRID_MAX_CHANNELS=16 -DGRID_MAX_LEVELS=32
         -shared -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <name>.cu

``-fmad=false`` keeps every ``a*b+c`` rounded twice, as PyTorch's separate
elementwise ops round it, so the kernels and their plain twins land every
sample in the same cell (an FMA moves ``floor(x*scale+0.5)`` and
``o + t*d`` across cell boundaries). ``--use_fast_math`` is never used.

A source may hold several kernels, each with its own ``Kernel`` (its own
C entry points and launch count) over one library: kernel A, its bf16
variant, that variant's packing pass and the tri-plane encode A-tri are all
in ``grid_encode.cu``, A' and A'-bf16 in ``grid_encode_backward.cu``, B,
B-bitfield and B-grouped in ``march_rays.cu`` (B and B-bitfield through one
entry point).

Libraries go into ``build/kernels/`` at the repository root (git-ignored),
named by a hash of the source, every header in ``csrc/`` (``*.cuh``) and
the flags, so an edited source or header rebuilds and an unchanged one
loads. ``build_all`` starts one ``nvcc`` per source, all at once.
Importing this module builds nothing and needs no ``nvcc``.

Every C entry point takes pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; :meth:`Kernel.launch` raises if
that is not 0 and counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.tracing import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# the most channels (level_dim) and levels the specialised kernels A, A'
# and their bf16 variants take (grid_common.cuh kMaxChannels / kMaxLevels
# are built from these): a block of theirs is 32 points x L levels, and
# kernel A stages 32 x (L * C + 1) outputs in shared memory; a grid past
# them, or at D outside (2, 3), runs the kernels' general path
GRID_MAX_CHANNELS, GRID_MAX_LEVELS = 16, 32
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", f"-DGRID_MAX_CHANNELS={GRID_MAX_CHANNELS}",
              f"-DGRID_MAX_LEVELS={GRID_MAX_LEVELS}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


class Kernel:
    """One CUDA source, its library, its C entry points and a launch count.

    ``launches`` goes up by one each time :meth:`launch` runs the kernel and
    nowhere else, so a caller can show that a code path went through it.
    """

    def __init__(self, name: str, entry_points: dict, source: str = ""):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.entry_points = entry_points  # C function -> ctypes argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for path in [self.source, *sorted(self.source.parent.glob("*.cuh"))]:
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source unless its library exists; returns
        the running process or None."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        proc.tmp, proc.out = tmp, out
        return proc

    def finish_build(self, proc):
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(proc.tmp, proc.out)

    def _load(self):
        if self._lib is None:
            with span("kernels.load"):
                proc = self.start_build()
                if proc is not None:
                    self.finish_build(proc)
                lib = ctypes.CDLL(str(self.library_path()))
                for fn, argtypes in self.entry_points.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def launch(self, fn: str, device: torch.device, *args):
        """Call C entry point ``fn`` on ``device``'s current stream; raise on
        a launch error, count the launch otherwise."""
        lib = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err} at launch")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

KERNELS = {
    "grid_encode": Kernel("grid_encode", {
        # x, emb, scales, level_params, out, N, D, L, C, smoothstep, hashed,
        # shift, bound, two_bound, stream
        "grid_encode_fwd": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    }),
    "grid_encode_backward": Kernel("grid_encode_backward", {
        # x, emb, grad_out, scales, level_params, grad_table, grad_x, N, D,
        # L, C, smoothstep, hashed, shift, bound, two_bound, stream
        "grid_encode_bwd": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _F,
                            _P],
    }),
    # the bf16 policy's variants: A-bf16 on the corner-packed bf16 table
    # (bf16 output), its packing pass, A'-bf16 on the bf16 table and grad_out
    "grid_encode_bf16": Kernel("grid_encode_bf16", {
        # x, packed, scales, level_params, out, N, D, L, C, smoothstep, shift,
        # bound, two_bound, stream
        "grid_encode_fwd_bf16_packed": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _F, _F,
                                        _P],
    }, source="grid_encode"),
    "grid_pack_bf16": Kernel("grid_pack_bf16", {
        # emb, level_params, packed, D, L, C, stream
        "grid_pack_bf16": [_P, _P, _P, _I, _I, _I, _P],
    }, source="grid_encode"),
    # ER-NeRF's tri-plane encode (A-tri): three 2-D planes of one point in
    # one launch
    "triplane_encode": Kernel("triplane_encode", {
        # x, emb_xy, emb_yz, emb_xz, scales, level_params, out, N, L, bound,
        # two_bound, stream
        "triplane_encode_fwd": [_P] * 7 + [_L, _I, _F, _F, _P],
    }, source="grid_encode"),
    "grid_encode_backward_bf16": Kernel("grid_encode_backward_bf16", {
        # x, emb, grad_out, scales, level_params, keys, grad_table, grad_x, N,
        # D, L, C, smoothstep, shift, bound, two_bound, stream
        "grid_encode_bwd_bf16_keyed": [_P] * 8 + [_L, _I, _I, _I, _I, _F, _F, _F, _P],
    }, source="grid_encode_backward"),
    "march_rays": Kernel("march_rays", {
        # rays_o, rays_d, nears, fars, t_lo, t_hi, noises, sigma_bytes,
        # bitfield, sigma_grid, t, dt, valid, xyz, count, N, K, S, H, cascade,
        # bound, dt_gamma, dt_min, dt_max, affine, use_cull, log_cull, stream
        "march_rays_fwd": [_P] * 15 + [_L, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _F, _P],
    }),
    # B's variants in march_rays.cu, each with its own launch count: the
    # bitfield march (march_rays_fwd with a bitfield) and the two-level march
    "march_rays_bitfield": Kernel("march_rays_bitfield", {
        "march_rays_fwd": [_P] * 15 + [_L, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _F, _P],
    }, source="march_rays"),
    "march_rays_grouped": Kernel("march_rays_grouped", {
        # rays_o, rays_d, nears, fars, t_lo, t_hi, noises, sigma_bytes, coarse,
        # t, dt, valid, xyz, count, groups, N, K, S, H, group_slots, bound,
        # dt_min, dt_group, use_cull, log_cull, stream
        "march_rays_grouped_fwd": [_P] * 15 + [_L, _I, _I, _I, _I, _F, _F, _F, _I, _F, _P],
    }, source="march_rays"),
    "composite_rays": Kernel("composite_rays", {
        # sigmas, rgbs, dts, ts, valid, ambient, image, depth, weights_sum,
        # ambient_sum, N, S, T_thresh, stream
        "composite_rays_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _L, _I, _F, _P],
    }),
    "composite_rays_backward": Kernel("composite_rays_backward", {
        # sigmas, rgbs, dts, ts, valid, image, depth, weights_sum,
        # grad_image, grad_depth, grad_ws, grad_amb, grad_sigmas, grad_rgbs,
        # grad_ambient, N, S, T_thresh, stream
        "composite_rays_bwd": [_P] * 15 + [_L, _I, _F, _P],
    }),
    "row_gather": Kernel("row_gather", {
        # table, idx, out, P, T, row_bytes, idx_bytes, stream
        "row_gather": [_P, _P, _P, _L, _L, _L, _I, _P],
    }),
    "rasterize": Kernel("rasterize", {
        # xy, z, tris, zbuf, tri_id, B, V, T, H, W, stream
        "rasterize_fwd": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _P],
    }),
}


def build_all() -> dict:
    """Compile every library that is missing, one ``nvcc`` per source, all
    started together; load every kernel. Returns source name -> nvcc log."""
    by_source = {}
    for k in KERNELS.values():
        by_source.setdefault(k.source.stem, k)
    running = {stem: k.start_build() for stem, k in by_source.items()}
    for stem, proc in running.items():
        if proc is not None:
            by_source[stem].finish_build(proc)
    for k in KERNELS.values():
        k._load()
    return {stem: k.build_log for stem, k in by_source.items()}


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def refuse_grad(kernel: str, **tensors):
    """Raise if autograd would want a gradient through ``kernel`` for one of
    the named inputs and the kernel has no backward for it: a CUDA path
    never returns a result that silently drops a gradient."""
    if torch.is_grad_enabled():
        wanted = [k for k, t in tensors.items() if t is not None and t.requires_grad]
        if wanted:
            raise RuntimeError(f"{kernel} has no backward for {wanted}, which require grad")


def require_cuda_tensors(*tensors):
    """Raise unless every given tensor is a contiguous CUDA tensor on one
    device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel inputs must share one CUDA device, got {devs}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
