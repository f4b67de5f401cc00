"""The readings the refiner's check limits are set from, in one process on the card.

    python3 perfbench/readings_refiner.py --seeds 11,12,... [--workload slam.offline] [--jobs 1]
        [--out readings_refiner.json]

For each seed: a window of the cell's first ``--jobs`` jobs and the check's numbers of the program
against the plain reference (perfbench/check.py with checks/refiner.py: the lower readings), then,
on the same records, the control (checks/refiner.py ``control``: the program's window solve and
verification round with TF32 products: the upper readings). The benchmark's runs never call this;
it is how the refiner's limits in ``workloads/<cell>.json`` were read (PERF.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import check, harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="slam.offline")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings_refiner: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", torch.cuda.current_device())
    cell = harness.Cell(args.workload)
    cell.traffic = dataclasses.replace(cell.traffic, jobs=args.jobs)
    refiner = next(m for m in cell.extras if m.__name__.endswith(".refiner"))
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.measure(cell, seed, 51.0, False, time.perf_counter(), device=device)
        got = check.run_check(cell, run, device)
        row = dict(seed=seed, program={k: v["value"] for k, v in got["numbers"].items()}, correct=got["correct"],
                   refine_stats=[j.result.refine_stats for j in run.jobs])
        ctl = refiner.control(cell, run, device)
        row["control"] = {k: v["value"] for k, v in ctl["numbers"].items()}
        row["control_correct"] = ctl["correct"]
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload, card=harness.power_limit(), rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
