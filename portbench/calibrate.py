"""Read a cell's correctness numbers over many seeds in one process, beside
the control's (the reference computed in the precision below the one the
configuration states) and, for training, the half-batch fault's: the
readings each limit in ``limits/<cell>.json`` is set from.

    python3 portbench/calibrate.py --workload render512_fp32 --seeds 1,2,3 --seconds 2

Each seed runs the cell as ``run.py`` does (``--trace 0``) and prints one
JSON line (appended to ``--out`` too): the run's checks, and with
``--controls`` the control's and the fault's readings under ``control.``
and ``half_batch.``. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import common  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    ctx, generator = common.prepare(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = generator.run(ctx, seed, args.seconds, False)
        checks = generator.check(ctx, res)
        if args.controls:
            checks.update(generator.controls(ctx, res))
        line = json.dumps({"workload": args.workload, "seed": seed, "checks": checks,
                           "metrics": res["metrics"], "memory": res["memory"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                print(line, file=f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
