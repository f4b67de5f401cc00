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
     kernel that the run never launched;
  5. the refined path, run_sequence(use_ba=True, use_loop_closure=True), at the
     default PipelineConfig over a 199-frame out-and-back feed (KITTI-00 GT
     poses 0..99 then 98..0, 376x1241, 6000 landmarks, seed 0, noise 0): plain
     VO once, the refined path once warm and once timed with the launch
     counters reset. Fails on a non-finite pose, a wrong pose count, keyframes
     != 39, no window solve, no verified loop candidate, refined ATE > plain
     ATE + 0.02 m, plain ATE > 0.15 m, or a kernel the timed run never launched;
  6. a loop closure that fires on the card: every 5th frame of the phase-5 feed
     from frame 5 on, detected and stereo-matched on the card, archived in a
     default-config LoopCloser with its GT pose drifted +0.1 m in x per
     keyframe. Fails unless a closure fires and the newest keyframe of the loop
     ends closer to its GT pose than half its drifted error.
The line before the last is a JSON summary of the kernels (launches summed
over the timed runs of phases 4 and 5); the last line is
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
from vo_tpu_torch.frontend.sift import detect_and_describe
from vo_tpu_torch.frontend.track import stereo_features_with_matches
from vo_tpu_torch.io import kitti, synthetic
from vo_tpu_torch.odometry import runner
from vo_tpu_torch.odometry.refiner import global_desc
from vo_tpu_torch.slam.loop_closure import ArchivedKeyframe, LoopCloser

N_FRAMES = 30
N_LANDMARKS = 6000
REPS = 25
K2_TOL = 1e-5
ATE_MAX_M = 0.05
OUT_FRAMES = 100  # phase 5: GT poses 0..99 out, 98..0 back
PLAIN_ATE_MAX_M = 0.15
REFINED_ATE_SLACK_M = 0.02
DRIFT_PER_KF_M = 0.1  # phase 6

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


class OutAndBackFeed:
    """GT poses 0..n-1 then n-2..0, staged on ``device``. The way back revisits every pose of the
    way out, so its frames are the outbound frames of the same poses (rendered and staged once)."""

    def __init__(self, n_out: int, device):
        root = synthetic.DEFAULT_KITTI_ROOT
        gt = kitti.read_poses(f"{root}/poses/00.txt")[:n_out]
        self.gt_poses = np.concatenate([gt, gt[-2::-1]])
        seq = synthetic.SyntheticSequence(
            kitti.load_stereo_calib(f"{root}/00"), self.gt_poses, n_landmarks=N_LANDMARKS, seed=0
        )
        self.calib = seq.calib
        out = [tuple(runner.to_device(im, device) for im in seq.frame(i)) for i in range(n_out)]
        self.frames = out + out[-2::-1]
        self.H, self.W = seq.H, seq.W

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int):
        return self.frames[i]


def refined_path(feed: OutAndBackFeed, cfg: PipelineConfig, device) -> dict:
    """Phase 5: plain VO and the refined path over the out-and-back feed."""
    n = len(feed)
    gt = feed.gt_poses
    plain = runner.run_sequence(feed, cfg, device=device)
    runner.run_sequence(feed, cfg, use_ba=True, use_loop_closure=True, device=device)  # warm
    kernels.reset_launches()
    res = runner.run_sequence(feed, cfg, use_ba=True, use_loop_closure=True, device=device)
    launches = dict(kernels.LAUNCHES)
    ate_plain = metrics.ate(plain.poses, gt)["rmse"]
    ate = metrics.ate(res.poses, gt)["rmse"]
    st = res.refine_stats
    print(
        f"[5] refined path, {n} out-and-back frames at the default config: {res.frames_per_sec:.3f} fps, "
        f"{res.per_frame_ms:.3f} ms/frame, ATE rmse {ate:.5f} m; plain VO {plain.frames_per_sec:.3f} fps, "
        f"{plain.per_frame_ms:.3f} ms/frame, ATE rmse {ate_plain:.5f} m; launches {launches}"
    )
    print(f"    refine_stats {json.dumps(st, sort_keys=True)}")
    if not (np.isfinite(res.poses).all() and np.isfinite(plain.poses).all()):
        raise AssertionError("non-finite pose in phase 5")
    if res.poses.shape != (n - 1, 4, 4):
        raise AssertionError(f"expected {n - 1} refined poses, got {res.poses.shape}")
    want_kf = (n - 1) // cfg.ba.keyframe_every
    if st.get("n_keyframes") != want_kf:
        raise AssertionError(f"n_keyframes {st.get('n_keyframes')} != {want_kf}")
    if st.get("ba_solves", 0) < 1:
        raise AssertionError("no window BA solve was accepted")
    if st.get("lc_verified", 0) < 1:
        raise AssertionError("no loop candidate was verified")
    if not ate_plain <= PLAIN_ATE_MAX_M:
        raise AssertionError(f"plain ATE {ate_plain} m > {PLAIN_ATE_MAX_M} m")
    if not ate <= ate_plain + REFINED_ATE_SLACK_M:
        raise AssertionError(f"refined ATE {ate} m > plain ATE {ate_plain} m + {REFINED_ATE_SLACK_M} m")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the refined path")
    return launches


def closure_fires(feed: OutAndBackFeed, cfg: PipelineConfig, device) -> None:
    """Phase 6: keyframes with growing drift through a default-config LoopCloser on the card."""
    calib = feed.calib.to(device)
    lc = LoopCloser(feed.calib, cfg.loop, matcher=cfg.matcher, device=device)
    gt = feed.gt_poses
    fired = None
    kf_frames = list(range(cfg.ba.keyframe_every, len(feed), cfg.ba.keyframe_every))
    for k, i in enumerate(kf_frames):
        imgs = torch.stack(feed.frame(i)).float() / 255.0
        f = detect_and_describe(imgs, cfg.sift)
        fl, fr = (type(f)(*(x[j] for x in f)) for j in (0, 1))
        sf, _ = stereo_features_with_matches(fl, fr, cfg.matcher, cfg.max_tracks)
        pose = gt[i].astype(np.float32).copy()
        pose[0, 3] += DRIFT_PER_KF_M * k
        res = lc.add_keyframe(
            ArchivedKeyframe(
                frame_idx=i, pose_c2w=pose, l_px=None, r_px=None, l_desc=None, mask=None,
                global_desc=global_desc(fl.desc, fl.mask).cpu().numpy(),
                dev=(sf.l_xy, sf.r_xy, sf.l_desc, sf.mask),
            ),
            query_dev=(fl.xy, fl.desc, fl.mask),
        )
        fired = res if res is not None else fired
    fired = lc.flush() or fired
    if fired is None:
        raise AssertionError(f"no loop closure fired ({lc.n_verified} candidates verified)")
    old_k, new_k = fired["loop"]
    fi = lc.keyframes[new_k].frame_idx
    err_drift = DRIFT_PER_KF_M * kf_frames.index(fi)
    err = float(np.linalg.norm(fired["corrected"][new_k][:3, 3] - gt[fi][:3, 3]))
    print(
        f"[6] loop closure on the card: {len(kf_frames)} keyframes, {lc.n_verified} candidates verified, "
        f"loop {old_k}->{new_k} (frames {lc.keyframes[old_k].frame_idx}->{fi}), newest loop keyframe error "
        f"{err:.4f} m against {err_drift:.4f} m drifted, {lc.skipped_small} skipped as small, "
        f"phase seconds {json.dumps({k: round(v, 4) for k, v in lc.phase_s.items()})}"
    )
    if not err < 0.5 * err_drift:
        raise AssertionError(f"closure left the newest loop keyframe {err} m off, not under half of {err_drift} m")


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

    t = time.perf_counter()
    feed5 = OutAndBackFeed(OUT_FRAMES, device)
    print(f"[5] rendered and staged {OUT_FRAMES} frames {feed5.H}x{feed5.W} for a {len(feed5)}-frame feed in "
          f"{time.perf_counter() - t:.1f} s")
    for k, v in refined_path(feed5, cfg, device).items():
        launches[k] += v
    closure_fires(feed5, cfg, device)

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
