"""Run one cell of the benchmark of radnerf_tpu_torch once, on the card:

    python3 portbench/run.py --workload render512_fp32 --seed 7 --seconds 20 --trace 0

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``, whose ``kind`` names the generator
``harness/<kind>.py``); its correctness limits are ``limits/<cell>.json``. With
``--trace 0`` a window of a fixed number of frames or steps (``--seconds``
at the mix's nominal rate, ``window_per_s``) is timed and the last line of
standard output carries the cell's end-to-end metrics; with ``--trace 1`` a fixed run of
frames or steps is profiled and the line carries its per-layer metrics,
each read by ``metrics/<name>.py``. Either way the frames or steps the
program produced are compared with the plain reference (``reference/``)
after the window, and each number compared is printed beside its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

# one host thread for PyTorch's and OpenMP's CPU work: spinning pool threads
# otherwise compete with the loop's own thread for the host's shared cores
os.environ.setdefault("OMP_NUM_THREADS", "1")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_limits(cell: str) -> dict:
    with open(common.BENCH / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def measure(args) -> dict:
    """One run of a cell: returns the result line's fields and the checks."""
    start = common.process_start_epoch()
    ctx, generator = common.prepare(args.workload)
    limits = load_limits(args.workload)
    res = generator.run(ctx, args.seed, args.seconds, bool(args.trace))
    t_ref = time.perf_counter()
    res["checks"] = generator.check(ctx, res)
    res["reference_s"] = time.perf_counter() - t_ref
    checks = [(n, float(res["checks"][n]), float(lim)) for n, lim in limits.items()]
    metrics = {}
    if args.trace:
        for m in ctx["per_layer"]:
            v = common.metric_reader(m["name"])(res)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(res["metrics"], setup_s=res["setup_done"] - start)
        for m in ctx["end_to_end"]:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    return {"res": res, "checks": checks, "metrics": metrics,
            "correct": all(v <= lim for _, v, lim in checks)}


def main(argv=None) -> int:
    args = parse(argv)
    try:
        out = measure(args)
    except common.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    bad = common.banned_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    res = out["res"]
    device = common.device_info(1)
    breakdown = None
    if args.trace:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        breakdown = res["trace"]["breakdown"]
    attempted = res.get("frames", res.get("steps", 0))
    print(f"portbench: {common.gpu_line()}; {json.dumps(diagnostics(res))}", file=sys.stderr)
    common.print_checks(out["checks"])
    print(common.result_line(out["correct"], attempted, 0, out["metrics"], device,
                             out["checks"], breakdown), flush=True)
    return 0


def diagnostics(res: dict) -> dict:
    """What a run saw beside its metrics, for the record on stderr."""
    keep = ("frames", "steps", "window_s", "reference_s", "samples_start", "samples_end",
            "samples_range", "caps_after_upkeep", "host", "fifths_ms", "parts_fifths_ms",
            "precision")
    d = {k: res[k] for k in keep if k in res}
    d["checks"] = dict(res["checks"])
    return d


if __name__ == "__main__":
    sys.exit(main())
