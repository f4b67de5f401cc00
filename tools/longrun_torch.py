"""Long-sequence accuracy of the four configurations on the port (counterpart of tools/longrun.py).

Runs plain VO (``vo``), VO + loop closure (``vo_lc``), VO + window BA (``vo_ba``) and
VO + BA + closure (``vo_ba_lc``) through ``vo_tpu_torch.odometry.runner.run_sequence``
at the default ``PipelineConfig`` over an OUT-AND-BACK trajectory (KITTI-00 GT poses
0..h-1 then h-1..0 from the committed ``tests/data/kitti/poses/00.txt``: drift accrues
and the closure configurations get a real revisit), rendered through
``vo_tpu_torch.bench.preload_cached`` (the reference's cache file) and staged on the
card. Prints each configuration's line and one JSON payload with the reference's keys
(per configuration: fps, ms/frame, ATE rmse/max, xz mean/max, pose_ok_frac and the whole
``refine_stats``), plus ``device_kind`` and ``power_limit_w``.

    python tools/longrun_torch.py [--frames 600] [--landmarks 9000] [--noise 0.02] [--out F.json]
                                  [--cpu] [--host-frames] [--eager]

The current CUDA card unless ``--cpu``; ``--host-frames`` feeds host frames per frame
instead of staging them on the card first. On the card every run goes through CUDA
graphs (the step, and on the refined configurations the refiner's and keyframe
programs: odometry.runner); ``--eager`` runs them with ``graph=False``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

CONFIGS = {
    "vo": dict(use_ba=False, use_loop_closure=False),
    "vo_lc": dict(use_ba=False, use_loop_closure=True),
    "vo_ba": dict(use_ba=True, use_loop_closure=False),
    "vo_ba_lc": dict(use_ba=True, use_loop_closure=True),
}


def out_and_back_poses(n_frames: int, poses_path: str | None = None) -> np.ndarray:
    """[n_frames, 4, 4] out-and-back trajectory from the KITTI-00 GT poses."""
    from vo_tpu_torch.io import kitti, synthetic

    gt = kitti.read_poses(poses_path or os.path.join(synthetic.DEFAULT_KITTI_ROOT, "poses", "00.txt"))
    half = (n_frames + 1) // 2
    fwd = gt[:half]
    back = fwd[::-1]  # the turn's pose appears twice: one zero-motion frame at the apex
    return np.concatenate([fwd, back])[:n_frames]


def load_or_render(
    calib, poses: np.ndarray, n_frames: int, n_landmarks: int, seed: int = 0, image_size=None,
    noise: float = 0.0, extra_noise: float = 0.0, cache_dir: str | None = None, workers: int = 1,
):
    """The pose-validated rendered-frame cache (vo_tpu_torch.bench.preload_cached)."""
    from vo_tpu_torch.bench import preload_cached

    return preload_cached(
        calib, poses, n_frames, n_landmarks, seed, image_size=image_size, noise=noise, extra_noise=extra_noise,
        cache_dir=cache_dir, workers=workers,
    )


def run_matrix(pre, poses: np.ndarray, cfg, device, noise: float = 0.0, graph=None) -> dict:
    """The four configurations over the first len(poses) frames of ``pre`` -> the reference's payload
    (``graph`` as run_sequence's)."""
    import torch

    from vo_tpu_torch.bench import power_limit_w
    from vo_tpu_torch.eval import metrics
    from vo_tpu_torch.odometry import runner
    from vo_tpu_torch.utils.device import resolve

    device = resolve(device)
    n = len(poses)
    results = {}
    for name, kw in CONFIGS.items():
        res = runner.run_sequence(pre, cfg, n_frames=n, device=device, graph=graph, **kw)
        a = metrics.ate(res.poses, poses)
        xz = metrics.xz_error(res.poses, poses)
        results[name] = dict(
            frames_per_sec=res.frames_per_sec,
            per_frame_ms=res.per_frame_ms,
            ate_rmse_m=a["rmse"],
            ate_max_m=a["max"],
            xz_mean_m=float(xz.mean()),
            xz_max_m=float(xz.max()),
            pose_ok_frac=float(res.pose_ok.mean()),
            **res.refine_stats,
        )
        print(name, json.dumps(results[name]), flush=True)
    return dict(
        n_frames=n,
        noise=noise,
        trajectory="out-and-back over KITTI 00 GT poses",
        device=device.type,
        device_kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        power_limit_w=power_limit_w(device),
        graphed=graph is not False and device.type == "cuda",
        configs=results,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--landmarks", type=int, default=9000)
    ap.add_argument("--noise", type=float, default=0.0, help="sensor noise stddev ([0,1] units)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    ap.add_argument(
        "--host-frames", action="store_true", help="feed frames from the host per frame instead of staging them on the card"
    )
    ap.add_argument("--eager", action="store_true", help="run with graph=False (default: CUDA graphs on the card)")
    args = ap.parse_args(argv)

    from vo_tpu_torch.bench import stage_frames
    from vo_tpu_torch.config import PipelineConfig
    from vo_tpu_torch.io import kitti, synthetic
    from vo_tpu_torch.utils.device import resolve

    device = resolve("cpu" if args.cpu else None)  # the card unless --cpu; never the CPU unasked
    calib = kitti.load_stereo_calib(os.path.join(synthetic.DEFAULT_KITTI_ROOT, "00"))
    poses = out_and_back_poses(args.frames)
    # Host rasterization dominates set-up: the rendered uint8 frames are cached, and rendered in parallel.
    pre = load_or_render(calib, poses, args.frames, args.landmarks, noise=args.noise, workers=min(8, os.cpu_count() or 1))
    if not args.host_frames and not args.cpu:
        t0 = time.perf_counter()
        pre = stage_frames(pre, device)
        print(f"# staged {args.frames} frame pairs on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    payload = run_matrix(pre, poses, PipelineConfig(), device, noise=args.noise, graph=False if args.eager else None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
