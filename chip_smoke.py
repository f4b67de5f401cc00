#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (vo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the card's name and power limit (needs CUDA);
  2. build the hand-written kernels from vo_tpu_torch/csrc with nvcc;
  3. K1 (extrema_scores) and K2 (bin_maps) against their plain PyTorch versions
     on the pyramids of rendered full-size frames, at the main path's shapes
     for all four octaves: K1 must be exact, K2 within 1e-5; CUDA-event median
     times of kernel and plain version over 25 repetitions;
  4. the plain-VO main path, odometry.runner.run_sequence, over the 30-frame
     synthetic KITTI-00 feed at the default PipelineConfig: one warm run, then
     a timed run with the kernels' launch counters reset just before it. Fails
     on ATE > 0.05 m, fewer than 28 of 29 pose_ok, a non-finite pose or a
     kernel that the run never launched.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from vo_tpu_torch.config import PipelineConfig
from vo_tpu_torch.eval import metrics
from vo_tpu_torch.frontend import kernels
from vo_tpu_torch.frontend.pyramid import build_pyramid
from vo_tpu_torch.io import synthetic
from vo_tpu_torch.odometry import runner

N_FRAMES = 30
N_LANDMARKS = 6000
REPS = 25
K2_TOL = 1e-5
ATE_MAX_M = 0.05

KERNELS = {
    "extrema_scores": dict(
        source="vo_tpu_torch/csrc/extrema_scores.cu", replaces="vo_tpu/frontend/pallas_kernels.py:180"
    ),
    "bin_maps": dict(source="vo_tpu_torch/csrc/bin_maps.cu", replaces="vo_tpu/frontend/pallas_kernels.py:213"),
}


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call, from CUDA events around each of ``reps`` calls after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check_kernels(feed: runner.StagedSequence, cfg: PipelineConfig) -> dict:
    """Phase 3: each kernel against its plain version at the main path's shapes."""
    s = cfg.sift
    # One group program's detection batch: the left and right images of fused_group frames.
    imgs = torch.stack([im for i in range(cfg.fused_group) for im in feed.frame(i)]).float() / 255.0
    pyr = build_pyramid(imgs, s)
    stats = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0) for k in KERNELS}
    for o in range(s.n_octaves):
        dog = pyr.dog[o].contiguous()
        lev = pyr.gauss[o][:, 1 : s.scales_per_octave + 1].reshape(-1, *dog.shape[2:]).contiguous()
        cases = {
            "extrema_scores": (
                lambda: kernels.extrema_scores(dog, s.contrast_threshold),
                lambda: kernels.extrema_scores_plain(dog, s.contrast_threshold),
                tuple(dog.shape),
            ),
            "bin_maps": (lambda: kernels.bin_maps(lev), lambda: kernels.soft_bin_pool_plain(lev), tuple(lev.shape)),
        }
        for name, (kern, plain, shape) in cases.items():
            got = kern()
            torch.cuda.synchronize()
            err = float((got - plain()).abs().max())
            ms, plain_ms = median_ms(kern), median_ms(plain)
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["ms"] += ms
            st["plain_ms"] += plain_ms
            print(f"  {name} octave {o} in {shape}: max|kernel-plain| {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    if stats["extrema_scores"]["max_abs_err"] != 0.0:
        raise AssertionError(f"K1 extrema_scores differs from its plain version: {stats['extrema_scores']}")
    if not stats["bin_maps"]["max_abs_err"] <= K2_TOL:
        raise AssertionError(f"K2 bin_maps exceeds {K2_TOL}: {stats['bin_maps']}")
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[1] device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t = time.perf_counter()
    lib = kernels.build()
    kernels.load()
    print(f"[2] built {lib.name} from vo_tpu_torch/csrc in {time.perf_counter() - t:.2f} s")

    cfg = PipelineConfig()
    t = time.perf_counter()
    seq = synthetic.kitti_synthetic_sequence(n_frames=N_FRAMES, n_landmarks=N_LANDMARKS, seed=0)
    feed = runner.StagedSequence(seq, N_FRAMES, device)
    print(f"[3] rendered and staged {N_FRAMES} frames {seq.H}x{seq.W} in {time.perf_counter() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = check_kernels(feed, cfg)

    runner.run_sequence(feed, cfg, n_frames=N_FRAMES, device=device)  # warm run
    kernels.reset_launches()
    res = runner.run_sequence(feed, cfg, n_frames=N_FRAMES, device=device)
    launches = dict(kernels.LAUNCHES)
    ate = metrics.ate(res.poses, np.asarray(seq.gt_poses))
    n_ok = int(res.pose_ok.sum())
    print(
        f"[4] main path, {N_FRAMES} frames at the default config: {res.frames_per_sec:.3f} fps, "
        f"{res.per_frame_ms:.3f} ms/frame, ATE rmse {ate['rmse']:.5f} m, pose_ok {n_ok}/{len(res.pose_ok)}, "
        f"median n_tracks {float(np.median(res.n_tracks)):.1f}, landmarks {res.landmarks.shape[0]}, launches {launches}"
    )
    if not np.isfinite(res.poses).all():
        raise AssertionError("non-finite pose in the main path's output")
    if res.poses.shape != (N_FRAMES - 1, 4, 4):
        raise AssertionError(f"expected {N_FRAMES - 1} poses, got {res.poses.shape}")
    if not ate["rmse"] <= ATE_MAX_M:
        raise AssertionError(f"ATE {ate['rmse']} m > {ATE_MAX_M} m")
    if n_ok < N_FRAMES - 2:
        raise AssertionError(f"pose_ok {n_ok} < {N_FRAMES - 2} of {N_FRAMES - 1}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the main path")

    summary = [
        dict(
            name=k,
            route="cuda",
            source=meta["source"],
            replaces=meta["replaces"],
            launches=launches[k],
            max_abs_err=stats[k]["max_abs_err"],
            ms=stats[k]["ms"],
            plain_ms=stats[k]["plain_ms"],
        )
        for k, meta in KERNELS.items()
    ]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
