"""The readings a cell's check limits are set from, in one process on the card.

    python3 perfbench/readings.py --workload <cell> --seeds 11,12,... [--seconds S] [--control-only]
        [--out readings_<cell>.json]

For each seed: a short window at the cell's own load (closed loop: one job; open loop: the
camera's first ``S / period`` frames) and the check's numbers of the program against the plain
reference (the lower readings); then, for the same seeds and jobs, the control: the reference
computed with TF32 products put in the program's place (the upper readings). The benchmark's runs
never call this; it is how the limits in ``workloads/<cell>.json`` were read (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import check, harness  # noqa: E402
from perfbench.gen import world  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", torch.cuda.current_device())
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        row = dict(seed=seed)
        if not args.control_only:
            run = harness.measure(cell, seed, args.seconds, False, time.perf_counter(), device=device)
            jobs, group = run.jobs, run.group
            row["program"] = check.run_check(cell, run, device)
            row["job_walls_s"] = [j.wall_s for j in jobs]
        else:
            t = cell.traffic
            n = t.frames_in(args.seconds) if t.loop == "open" else len(cell.world.log)
            jobs = [harness.Job(index=0, seed=world.job_seed(seed, 0), n_frames=n, wall_s=0.0, result=None)]
            group = cell.group()
        row["control"] = check.control(cell, seed, jobs, group, device)
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
