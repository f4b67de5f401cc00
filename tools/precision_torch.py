"""What TF32 would do to the port's plain step, against float32, on the card.

    python tools/precision_torch.py [--frames 30] [--repeats 5] [--sustained-frames 200]

``utils.precision`` runs every precision name of the reference in float32 on an H100, its
``"default"`` included. This tool measures the mapping it declined, TF32, by setting both TF32
flags itself (``tf32_allowed``) around each side of the comparison; the solvers pin float32
inside it on their own, as they would under a TF32 ``"default"``:

- detections: over the bench's 30-frame feed (synthetic KITTI-00, 6000 landmarks, seed 0,
  staged on the card), one detection call per frame on its stereo pair at the default
  ``SIFTConfig``. A float32 keypoint is shared where the TF32 call has a keypoint within
  0.01 px; the rest flicker;
- the plain step (``plain_run``: ``run_sequence``'s deferred plain path, bare, since
  ``run_sequence`` pins its own precision): one warm run and ``--repeats`` timed runs over the
  30-frame feed, then one run over ``--sustained-frames`` fresh frames (KITTI-00 GT poses,
  9000 landmarks, ``bench.preload_cached``), each at both settings: ms/frame, ATE, pose_ok;
- ``run_sequence`` itself once over the 30-frame feed, held to the float32 bare loop (the
  largest pose difference), so that the bare loop is known to be the runner's path.

Prints one JSON line with those figures and the card with its power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

XY_TOL_PX = 0.01


def shared(a_xy: np.ndarray, b_xy: np.ndarray) -> np.ndarray:
    """For each row of ``a_xy``, whether ``b_xy`` has a point within XY_TOL_PX (both axes)."""
    if not len(a_xy) or not len(b_xy):
        return np.zeros(len(a_xy), bool)
    return (np.abs(a_xy[:, None] - b_xy[None]).max(-1) < XY_TOL_PX).any(axis=1)


@contextlib.contextmanager
def tf32_allowed(on: bool):
    """Both TF32 flags set to ``on`` within the block, the caller's given back after it."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = mm.allow_tf32, cudnn.allow_tf32
    mm.allow_tf32 = cudnn.allow_tf32 = on
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = before


def plain_run(feed, n: int, cfg, device):
    """``run_sequence``'s deferred plain path over ``feed``'s first ``n`` frames, at whatever
    precision the caller set: groups of ``cfg.fused_group`` frames (a single-frame tail),
    landmarks inserted where ``cfg.view_3d``, the history read back once at the end.
    -> (poses of frames 1..n-1, their pose_ok, ms per frame)."""
    from vo_tpu_torch.odometry import landmarks
    from vo_tpu_torch.odometry.pipeline import init_state, vo_step, vo_step_multi

    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
    calib = feed.calib.to(device)
    state = init_state(cfg, 0, device)
    lmap = landmarks.init_map(cfg.landmarks, device) if cfg.view_3d else None
    outs = []
    sync(device)
    t0 = time.perf_counter()
    i = 0
    while i < n:
        g = cfg.fused_group if i + cfg.fused_group <= n else 1
        frames = [im for k in range(g) for im in feed.frame(i + k)]
        if g == 1:
            state, out = vo_step(state, frames[0], frames[1], calib, cfg)
            new = [out]
        else:
            state, new = vo_step_multi(state, frames, calib, cfg)
        if lmap is not None:
            for out in new:
                landmarks.insert(lmap, out.new_lm_l_px, out.new_lm_r_px, out.new_lm_mask, out.pose_c2w, calib, cfg.landmarks)
        outs += new
        i += g
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / n
    poses = torch.stack([o.pose_c2w for o in outs[1:]]).cpu().numpy()
    ok = torch.stack([o.pose_ok for o in outs[1:]]).cpu().numpy()
    return poses, ok, ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--sustained-frames", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("precision_torch: needs a CUDA card", file=sys.stderr)
        return 2

    from vo_tpu_torch import bench
    from vo_tpu_torch.config import PipelineConfig
    from vo_tpu_torch.eval import metrics
    from vo_tpu_torch.frontend.sift import detect_and_describe
    from vo_tpu_torch.io import kitti, synthetic
    from vo_tpu_torch.odometry.runner import StagedSequence, run_sequence

    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    n = args.frames
    seq = synthetic.kitti_synthetic_sequence(n_frames=n, n_landmarks=bench.N_LANDMARKS, seed=0)
    feed = StagedSequence(seq, n, dev)
    gt = np.asarray(seq.gt_poses)
    found = {}
    for side, tf32 in (("float32", False), ("tf32", True)):
        with tf32_allowed(tf32):
            found[side] = []
            for i in range(n):
                imgs = torch.stack(list(feed.frame(i))).float() / 255.0
                f = detect_and_describe(imgs, cfg.sift)
                xy, mask = f.xy.cpu().numpy(), f.mask.cpu().numpy()
                found[side] += [xy[b][mask[b]] for b in range(xy.shape[0])]
    per_image = [shared(a, b) for a, b in zip(found["float32"], found["tf32"])]
    flicker = [1.0 - s.mean() if len(s) else 0.0 for s in per_image]

    feed_s = gt_s = None
    if args.sustained_frames:
        root = synthetic.DEFAULT_KITTI_ROOT
        gt_s = kitti.read_poses(os.path.join(root, "poses", "00.txt"))[: args.sustained_frames]
        pre_s = bench.preload_cached(
            kitti.load_stereo_calib(os.path.join(root, "00")), gt_s, args.sustained_frames, bench.SUSTAINED_LANDMARKS,
            seed=0, workers=min(8, os.cpu_count() or 1),
        )
        feed_s = bench.stage_frames(pre_s, dev)
    step, poses32 = {}, None
    for side, tf32 in (("float32", False), ("tf32", True)):
        with tf32_allowed(tf32):
            plain_run(feed, n, cfg, dev)  # warm
            runs = [plain_run(feed, n, cfg, dev) for _ in range(args.repeats)]
            ms = [r[2] for r in runs]
            row = dict(
                per_frame_ms=float(np.median(ms)), per_frame_ms_runs=ms, ate_rmse_m=metrics.ate(runs[0][0], gt)["rmse"],
                pose_ok_frac=float(runs[0][1].mean()),
            )
            if feed_s is not None:
                p, ok, ms_s = plain_run(feed_s, args.sustained_frames, cfg, dev)
                row.update(sustained_per_frame_ms=ms_s, sustained_ate_rmse_m=metrics.ate(p, gt_s)["rmse"],
                           sustained_pose_ok_frac=float(ok.mean()))
        step[side] = row
        poses32 = runs[0][0] if side == "float32" else poses32
        print(f"# plain step, {side}: {row}", flush=True)
    res = run_sequence(feed, cfg, n_frames=n, device=dev)

    print(json.dumps(dict(
        frames=n,
        images=len(per_image),
        flicker_share=float(1.0 - np.concatenate(per_image).mean()),
        flicker_share_max_image=float(max(flicker)),
        keypoints_per_image_float32=float(np.mean([len(a) for a in found["float32"]])),
        keypoints_per_image_tf32=float(np.mean([len(b) for b in found["tf32"]])),
        xy_tol_px=XY_TOL_PX,
        step=step,
        run_sequence_ate_rmse_m=metrics.ate(res.poses, gt)["rmse"],
        bare_loop_vs_run_sequence_max_abs_m=float(np.abs(res.poses - poses32).max()),
        device_kind=torch.cuda.get_device_name(dev),
        power_limit_w=bench.power_limit_w(dev),
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
