"""Measure the port's CPU baseline (counterpart of tools/measure_cpu_baseline.py).

Runs the SAME full pipeline as the bench (default ``PipelineConfig``, full 376x1241 KITTI
geometry, 100 stereo frames of the synthetic KITTI-00 feed with 6,000 landmarks, seed 0) on the
CPU (``device="cpu"``): one warm run, then one measured run, on frames rendered and quantized
beforehand (``vo_tpu_torch.bench.Preloaded``), so the timed loop measures the pipeline, not host
rendering. Writes ``CPU_BASELINE_TORCH.json`` at the repo's root with the reference's keys and
the machine's CPU model and count; ``vo_tpu_torch/bench.py`` reads it and reports
``cpu_baseline_fps`` and ``vs_baseline`` (card fps over this figure).

    python tools/measure_cpu_baseline_torch.py [--frames 100] [--out CPU_BASELINE_TORCH.json]

``--image-size``, ``--landmarks``, ``--max-keypoints`` and ``--hypotheses`` shrink the run for
tests; the baseline uses none of them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def cpu_model() -> str:
    """The CPU's model name with its vendor, family, model and stepping (``/proc/cpuinfo``: a
    virtual machine may name its model "unknown"), else what ``platform`` knows."""
    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                fields.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    ident = ", ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "stepping") if k in fields)
    name = fields.get("model name") or platform.processor() or platform.machine()
    return f"{name} ({ident})" if ident else name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--out", default=os.path.join(REPO, "CPU_BASELINE_TORCH.json"))
    ap.add_argument("--image-size", default=None, metavar="H,W", help="render at H,W (tests)")
    ap.add_argument("--landmarks", type=int, default=6000, help="landmarks of the feed (tests)")
    ap.add_argument("--max-keypoints", type=int, default=None, help="SIFT capacity (tests)")
    ap.add_argument("--hypotheses", type=int, default=None, help="RANSAC hypotheses (tests)")
    args = ap.parse_args(argv)

    import torch

    from vo_tpu_torch.bench import Preloaded
    from vo_tpu_torch.config import PipelineConfig
    from vo_tpu_torch.eval import metrics
    from vo_tpu_torch.io import synthetic
    from vo_tpu_torch.odometry import runner

    size = tuple(int(x) for x in args.image_size.split(",")) if args.image_size else None
    cfg = PipelineConfig()
    if args.max_keypoints:
        cfg = dataclasses.replace(cfg, sift=dataclasses.replace(cfg.sift, max_keypoints=args.max_keypoints))
    if args.hypotheses:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac, n_hypotheses=args.hypotheses))
    seq = synthetic.kitti_synthetic_sequence(n_frames=args.frames, n_landmarks=args.landmarks, seed=0, image_size=size)
    pre = Preloaded(seq, args.frames)
    # The warm run pays first-use costs; the second run is the measured steady state.
    runner.run_sequence(pre, cfg, n_frames=args.frames, device="cpu")
    res = runner.run_sequence(pre, cfg, n_frames=args.frames, device="cpu")
    ate = metrics.ate(res.poses, np.asarray(seq.gt_poses))

    payload = {
        "cpu_fps": res.frames_per_sec,
        "per_frame_ms": res.per_frame_ms,
        "n_frames": args.frames,
        "ate_rmse_m": ate["rmse"],
        "device": "cpu",
        "cpu": cpu_model(),
        "n_cpus": os.cpu_count(),
        "torch_threads": torch.get_num_threads(),
        "torch": torch.__version__,
        "config": (
            f"the bench's pipeline on the CPU: PipelineConfig with {cfg.sift.max_keypoints} keypoints and "
            f"{cfg.ransac.n_hypotheses} hypotheses, {seq.W}x{seq.H}, {args.landmarks} landmarks, seed 0, "
            "warm run + 1 measured run"
        ),
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
