"""Row gather ``table[idx]`` along axis 0, and the gather study.

Counterpart of ``radnerf_tpu/ops/rowgather.py`` (``take_rows``, an XLA row
fetch without bounds handling) and of the Pallas row-loop gather in
``scripts/bench_gather.py`` (``pallas_row_loop``, the repo's one Pallas
kernel). ``take_rows`` is the wrapper of kernel D (``csrc/row_gather.cu``):
on a CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
``table[idx]``.

``bench_gather_study`` is the port of the study that kernel was written
for: P rows of W bf16 values fetched by random index from tables of T rows,
at the Pallas kernel's own shapes (P = 2 Mi, W = 16, T in {4096, 65536}).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ._kernels import KERNELS, refuse_grad, require_cuda_tensors


def take_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``take_rows``."""
    return table[idx]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along axis 0: kernel D on CUDA tensors, the plain
    indexing on CPU tensors. table [T, ...] of any dtype; idx int32 or int64
    of any shape -> [*idx.shape, *table.shape[1:]]. Indices must lie in
    [0, T). Outside it the two differ: the plain version raises, the kernel
    writes zero rows (its bounds guard keeps memory safe without a sync to
    report the fault). The kernel has no backward: a table that requires
    grad raises."""
    if table.device.type == "cpu":
        return take_rows_plain(table, idx)
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"kernel D takes int32 or int64 indices, got {idx.dtype}")
    refuse_grad("kernel D", table=table)
    table, idx = table.contiguous(), idx.contiguous()
    require_cuda_tensors(table, idx)
    out = torch.empty((*idx.shape, *table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    row_bytes = table[0].numel() * table.element_size() if table.shape[0] else 0
    if idx.numel() > 0 and row_bytes > 0:
        KERNELS["row_gather"].launch(
            "row_gather", table.device, table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            idx.numel(), table.shape[0], row_bytes, idx.element_size())
    return out


def study_inputs(T: int, P: int = 2 * 1024 * 1024, W: int = 16, seed: int = 0,
                 device="cuda"):
    """The study's table [T, W] bf16 (N(0, 1) values) and int32 indices [P],
    uniform over the table, from ``np.random.default_rng(seed)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(T, W)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, T, P).astype(np.int32))
    return table.to(torch.bfloat16).to(dev), idx.to(dev)


def bench_gather_study(P: int = 2 * 1024 * 1024, W: int = 16, tables=(4096, 65536),
                       seed: int = 0, device="cuda") -> dict:
    """Fetch P rows of W bf16 values by random index from each table size
    with ``take_rows`` and check the rows against ``table[idx]`` bit for
    bit. Returns {T: {"equal": bool, "max_abs_err": float, "table": table,
    "idx": idx}}; the inputs come back so that a caller can time the gather
    on them."""
    out = {}
    for T in tables:
        table, idx = study_inputs(T, P, W, seed, device)
        got, want = take_rows(table, idx), take_rows_plain(table, idx)
        out[T] = {"equal": bool(torch.equal(got.view(torch.int16), want.view(torch.int16))),
                  "max_abs_err": float((got.float() - want.float()).abs().max()),
                  "table": table, "idx": idx}
    return out
