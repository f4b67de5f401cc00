"""Where the PyTorch/CUDA port's main path spends its time on one CUDA card.

    python tools/profile_torch_step.py [--frames 30]
    python tools/profile_torch_step.py --refined

Renders the synthetic KITTI-00 feed (30 frames, 6000 landmarks, seed 0, as
chip_smoke.py), stages it on the card and runs odometry.runner.run_sequence at
the default PipelineConfig. Prints, with the card's name and power limit:

- the untraced run: ms/frame and fps (host clock around a synchronised run);
- the same run under torch.profiler: device busy ms/frame (sum of kernel and
  copy times on the card; one stream, so they do not overlap), the device's
  idle share (1 - busy / untraced wall), launches per frame, and the kernels
  that take the most device time, with the two hand-written kernels named
  (K1 extrema_scores, K2 bin_maps) whatever their rank;
- per stage of one 2-frame group (batched detection, each frame's _step_core,
  each landmark insert): host time to enqueue, wall time to a synchronise,
  device busy time and launches. Enqueue close to wall with little device time
  means the stage is bound by launches from the host;
- what detection's device time is made of: K1 (one launch over the pyramid),
  the per-octave torch.topk over [4, 3*H*W] that follows K1, and K2 (one
  launch), each run alone on the detection batch's pyramid.

With ``--refined`` it profiles the refined path instead
(run_sequence(use_ba=True, use_loop_closure=True) over chip_smoke.py's
199-frame out-and-back feed): untraced ms/frame and fps, the refiner's stats
(main-thread wait, worker phase seconds), and under torch.profiler the device
busy time (the union of kernel and copy intervals over both streams: the
frame loop's and the refiner's) and idle share.

The summary is also written as JSON to chiprun_out/profile_torch_step.json
(profile_torch_step_refined.json with ``--refined``).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vo_tpu_torch.config import PipelineConfig  # noqa: E402
from vo_tpu_torch.frontend import kernels  # noqa: E402
from vo_tpu_torch.frontend.pyramid import build_pyramid  # noqa: E402
from vo_tpu_torch.frontend.sift import _octave_caps, detect_and_describe  # noqa: E402
from vo_tpu_torch.io import synthetic  # noqa: E402
from vo_tpu_torch.odometry import landmarks, pipeline, runner  # noqa: E402


# Device kernel names of the hand-written kernels (csrc/*.cu), as the profiler reports them.
HAND_WRITTEN = {"extrema_scores_kernel": "K1 extrema_scores", "bin_maps_kernel": "K2 bin_maps"}


def hand_written_ms(by_name) -> dict:
    """{K1 ..., K2 ...: device ms} summed over the profiler's kernel names."""
    return {label: sum(v for k, v in by_name.items() if key in k) for key, label in HAND_WRITTEN.items()}


def device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def traced(fn, reps: int):
    """(device busy ms, launches, {kernel name: ms}) per call of fn, from torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = device_events(prof)
    by_name = collections.Counter()
    for e in evs:
        by_name[e.name] += e.time_range.elapsed_us() / 1000.0 / reps
    return union_ms(evs) / reps, len(evs) / reps, by_name


def union_ms(evs) -> float:
    """Device busy ms: the union of the events' intervals (streams may overlap)."""
    busy, end = 0.0, -float("inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1000.0


def host_times(fn, reps: int):
    """(ms to enqueue, ms to a synchronise) per call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    return 1000.0 * t_enq / reps, 1000.0 * t_all / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--refined", action="store_true", help="profile the refined path (BA + loop closure)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    cfg = PipelineConfig()
    if args.refined:
        return profile_refined(cfg, dev, card)
    seq = synthetic.kitti_synthetic_sequence(n_frames=args.frames, n_landmarks=6000, seed=0)
    feed = runner.StagedSequence(seq, args.frames, dev)

    runner.run_sequence(feed, cfg, device=dev)  # warm: build, allocator, library handles
    res = runner.run_sequence(feed, cfg, device=dev, warmup=False)
    busy, launches, by_name = traced(lambda: runner.run_sequence(feed, cfg, device=dev, warmup=False), 1)
    n = args.frames
    summary = dict(
        card=card,
        frames=n,
        wall_ms_per_frame=res.per_frame_ms,
        fps=res.frames_per_sec,
        device_busy_ms_per_frame=busy / n,
        device_idle_share=1.0 - (busy / n) / res.per_frame_ms,
        launches_per_frame=launches / n,
        top_kernels_ms_per_frame={k: v / n for k, v in by_name.most_common(12)},
        hand_written_ms_per_frame={k: v / n for k, v in hand_written_ms(by_name).items()},
    )
    print(
        f"main path: {res.per_frame_ms:.3f} ms/frame ({res.frames_per_sec:.2f} fps) untraced; device busy "
        f"{busy / n:.3f} ms/frame, idle share {summary['device_idle_share']:.3f}, {launches / n:.0f} launches/frame"
    )
    for k, v in by_name.most_common(12):
        print(f"  {v / n:8.4f} ms/frame  {k[:110]}")
    for k, v in summary["hand_written_ms_per_frame"].items():
        print(f"  {v:8.4f} ms/frame  {k} (hand-written)")

    # --- stages of one 2-frame group, from the state after frame 1 ---
    calib = seq.calib.to(dev)
    imgs = torch.stack([pipeline._normalize(im) for i in (2, 3) for im in feed.frame(i)])
    state = pipeline.init_state(cfg, 0, dev)
    for i in (0, 1):
        state, _ = pipeline.vo_step(state, *feed.frame(i), calib, cfg)
    feats = detect_and_describe(imgs, cfg.sift)
    fl, fr = (pipeline._image_features(feats, k) for k in (0, 1))
    _, out = pipeline._step_core(state, fl, fr, calib, cfg)
    lmap = landmarks.init_map(cfg.landmarks, dev)
    # The pieces of detection that the hand-written kernels and the top-k after K1 account for.
    s = cfg.sift
    pyr = build_pyramid(imgs, s)
    dogs = pyr.dog[: s.n_octaves]
    levels = [G[:, 1 : s.scales_per_octave + 1] for G in pyr.gauss[: s.n_octaves]]
    scores = kernels.extrema_scores_octaves(dogs, s.contrast_threshold)
    caps = _octave_caps(s)
    stages = {
        "detect_and_describe (4 images)": lambda: detect_and_describe(imgs, cfg.sift),
        "  K1 extrema_scores_octaves (1 launch)": lambda: kernels.extrema_scores_octaves(dogs, s.contrast_threshold),
        "  topk after K1 (4 octaves, [4, 3*H*W] each)": lambda: [
            torch.topk(sc.reshape(sc.shape[0], -1), k, dim=1) for sc, k in zip(scores, caps)
        ],
        "  K2 bin_maps_octaves (1 launch)": lambda: kernels.bin_maps_octaves(levels),
        "_step_core (1 frame)": lambda: pipeline._step_core(state, fl, fr, calib, cfg),
        "landmarks.insert (1 frame)": lambda: landmarks.insert(
            lmap, out.new_lm_l_px, out.new_lm_r_px, out.new_lm_mask, out.pose_c2w, calib, cfg.landmarks
        ),
    }
    summary["stages"] = {}
    for name, fn in stages.items():
        enq, wall = host_times(fn, args.reps)
        busy, launches, by = traced(fn, args.reps)
        summary["stages"][name] = dict(enqueue_ms=enq, wall_ms=wall, device_ms=busy, launches=launches)
        print(f"stage {name}: enqueue {enq:.3f} ms, wall {wall:.3f} ms, device {busy:.3f} ms, {launches:.0f} launches")
        for k, v in by.most_common(4):
            print(f"    {v:8.4f} ms  {k[:100]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_step.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


def profile_refined(cfg: PipelineConfig, dev, card: str) -> int:
    from chip_smoke import OUT_FRAMES, OutAndBackFeed

    feed = OutAndBackFeed(OUT_FRAMES, dev)
    n = len(feed)

    def run(warmup=True):
        return runner.run_sequence(feed, cfg, use_ba=True, use_loop_closure=True, device=dev, warmup=warmup)

    run()  # warm
    res = run()
    busy, launches, by_name = traced(lambda: run(warmup=False), 1)
    summary = dict(
        card=card,
        frames=n,
        wall_ms_per_frame=res.per_frame_ms,
        fps=res.frames_per_sec,
        refine_stats=res.refine_stats,
        device_busy_ms_per_frame=busy / n,
        device_idle_share=1.0 - (busy / n) / res.per_frame_ms,
        launches_per_frame=launches / n,
        top_kernels_ms_per_frame={k: v / n for k, v in by_name.most_common(12)},
        hand_written_ms_per_frame={k: v / n for k, v in hand_written_ms(by_name).items()},
    )
    print(
        f"refined path: {res.per_frame_ms:.3f} ms/frame ({res.frames_per_sec:.2f} fps) untraced; device busy "
        f"{busy / n:.3f} ms/frame, idle share {summary['device_idle_share']:.3f}, {launches / n:.0f} launches/frame"
    )
    print(f"refine_stats {json.dumps(res.refine_stats, sort_keys=True)}")
    for k, v in by_name.most_common(12):
        print(f"  {v / n:8.4f} ms/frame  {k[:110]}")
    for k, v in summary["hand_written_ms_per_frame"].items():
        print(f"  {v:8.4f} ms/frame  {k} (hand-written)")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_step_refined.json"), "w") as f:
        json.dump(summary, f, indent=1)
    # After tracing the refiner's second thread and stream, the interpreter's
    # exit hung until the call's time limit on the H100 (torch 2.11): leave
    # without the profiler's teardown, everything is written.
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
