"""What every run of the benchmark shares: finding a cell's configuration,
traffic mix, generator and metrics by name, the card checks, the caches,
the set-up of the program, the check that nothing of JAX was loaded, the
host's and the card's state beside a run, and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
# top-level modules a run may not hold once its window has closed, compared
# whole: radnerf_tpu_torch begins with radnerf_tpu and is allowed
BANNED_MODULES = ("jax", "jaxlib", "flax", "radnerf_tpu")


class Refused(Exception):
    """A run that may print no result (exit code 2)."""


def process_start_epoch() -> float:
    """The wall-clock time this process started (from /proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + int(fields[19]) / ticks


def set_cache_dirs():
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths (the program builds its kernels into build/kernels itself)."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def load_benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    """The cell's entry, its configuration file and traffic file, and the
    metrics that it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    cell = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def generator(kind: str):
    """The module ``harness/<kind>.py`` that drives a traffic mix of that
    kind: ``run(ctx, seed, seconds, trace)``, ``check(ctx, res)`` and
    ``controls(ctx, res)``."""
    if not kind.isidentifier() or not (BENCH / "harness" / f"{kind}.py").exists():
        raise Refused(f"traffic kind {kind!r} has no generator harness/{kind}.py")
    return importlib.import_module(f"portbench.harness.{kind}")


def device():
    """The device a run drives (the tests put the CPU in its place)."""
    import torch

    return torch.device("cuda")


def prepare_program():
    """The program's float32 policy (TF32 off) and its kernels, built into
    the checkout's ``build/kernels`` or loaded from there."""
    from radnerf_tpu_torch.main import float32_matmuls
    from radnerf_tpu_torch.ops import _kernels

    float32_matmuls()
    _kernels.build_all()


def prepare(cell: str):
    """Everything before a cell's first run in a process: the caches, the
    cell's files, the card check, one host thread, the program's set-up.
    Returns the cell's context and its generator."""
    set_cache_dirs()
    ctx = find_cell(load_benchmark(), cell)
    require_cards(ctx["cell"]["chips"])
    import torch

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    prepare_program()
    return ctx, generator(ctx["traffic"]["kind"])


def window_count(traffic: dict, seconds: float, least: int) -> int:
    """The frames or steps of a timed window: ``seconds`` at the mix's
    nominal rate (``window_per_s``), the same on every commit, so that every
    side does the same work; at least ``least``."""
    return max(int(least), round(seconds * traffic["window_per_s"]))


def host_probe() -> dict:
    """The host's state at a moment: this process's CPU seconds, the
    machine's jiffies of steal and of all CPU time, the load average."""
    out = {"t": time.perf_counter(), "cpu_s": time.process_time()}
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        out["jiffies"], out["steal"] = sum(v), (v[7] if len(v) > 7 else 0)
        with open("/proc/loadavg") as f:
            out["load1"] = float(f.read().split()[0])
    except (OSError, ValueError):
        pass
    return out


def host_share(a: dict, b: dict) -> dict:
    """Between two probes: the share of the wall time this process ran on a
    CPU, and the share of the machine's CPU time the hypervisor stole."""
    wall = max(b["t"] - a["t"], 1e-9)
    out = {"cpu_share": (b["cpu_s"] - a["cpu_s"]) / wall}
    if "jiffies" in a and "jiffies" in b and b["jiffies"] > a["jiffies"]:
        out["steal_share"] = (b["steal"] - a["steal"]) / (b["jiffies"] - a["jiffies"])
        out["load1"] = b.get("load1")
    return out


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_cards(n: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: this benchmark runs on a card")
    if torch.cuda.device_count() < n:
        raise Refused(f"{torch.cuda.device_count()} cards, the cell needs {n}")


def banned_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED_MODULES)


def gpu_line() -> str:
    """The card's name, power limit, clocks (SM, memory), power draw,
    temperature and active throttle reasons as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,"
                              "power.draw,temperature.gpu,clocks_throttle_reasons.active",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between closest ranks
    (numpy's default), over every value."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown=None) -> str:
    """The contract's last line: ``checks`` is [(name, value, limit)], the
    numbers compared, under the key that comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)


def print_checks(checks: list):
    """Each number compared beside its limit, as the last lines on stderr."""
    for n, v, lim in checks:
        print(f"check {n} = {v!r} (limit {lim!r}: {'ok' if v <= lim else 'FAILED'})",
              file=sys.stderr, flush=True)
