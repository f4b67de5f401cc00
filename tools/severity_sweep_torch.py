"""Feed-severity sweep on the port (counterpart of tools/severity_sweep.py).

Runs configurations over a PREFIX of an already-rendered frame cache
(``tools/render_cache_torch.py``; by default the 4,500-frame, 54,000-landmark, noise-0.02
render in the temporary directory) at several levels of load-time ``extra_noise``, and reports
each run's drift next to the digitised reference curve (``REFERENCE_ERROR_CURVE.csv``) at the
prefix's last frame. ``load_prefix`` adds the noise as ``vo_tpu_torch.bench.preload_cached``
does (``bench.add_noise``: ``np.random.default_rng((seed, i, 2|3))``), so a level here
reproduces ``tools/bigrun_torch.py --extra-noise`` at that level byte for byte.
``--seeds`` repeats every run at several ``run_sequence`` seeds (the RANSAC draws), which
measures the spread of one configuration. Runs go through ``bigrun_torch.run_configs``.

    python tools/severity_sweep_torch.py [--frames 1500] [--levels 0.0,0.05,0.1,0.15]
        [--cache PATH] [--base-noise 0.02] [--configs vo] [--seeds 0] [--out F.json] [--cpu]

The current CUDA card unless ``--cpu``; the frames are staged on the device once per level. On
the card the runs step through CUDA graphs (each row's ``graphed``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def load_prefix(cache: str, n: int, extra_noise: float, seed: int = 0):
    """``vo_tpu_torch.bench.Preloaded`` over the first ``n`` frames of a rendered cache, with
    deterministic load-time sensor noise (``bench.add_noise``, as ``preload_cached`` adds it;
    ``calib`` is the caller's to set)."""
    from vo_tpu_torch.bench import Preloaded, add_noise

    z = np.load(cache)
    L, R = z["l"][:n], z["r"][:n]
    pre = Preloaded.__new__(Preloaded)
    pre.gt_poses = z["poses"][:n]
    pre.frames = add_noise([(L[i], R[i]) for i in range(n)], extra_noise, seed)
    return pre


def reference_error_at(t: float, csv_path: str) -> float:
    ref = np.loadtxt(csv_path, delimiter=",", comments="#")
    return float(np.interp(t, ref[:, 0], ref[:, 1]))


def main(argv=None) -> int:
    from vo_tpu_torch.bench import cache_path

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--levels", default="0.0,0.05,0.1,0.15")
    ap.add_argument(
        "--cache", default=cache_path(4500, 54000, seed=0, noise=0.02),
        help="a rendered cache (default: the 4,500-frame, 54,000-landmark, noise-0.02 render)",
    )
    ap.add_argument("--base-noise", type=float, default=0.02)
    ap.add_argument("--configs", default="vo")
    ap.add_argument("--seeds", default="0", help="run_sequence seeds, comma-separated")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bigrun_torch

    from vo_tpu_torch.bench import stage_frames
    from vo_tpu_torch.config import PipelineConfig
    from vo_tpu_torch.io import kitti, synthetic
    from vo_tpu_torch.odometry import runner
    from vo_tpu_torch.utils.device import resolve

    device = resolve("cpu" if args.cpu else None)  # the card unless --cpu; never the CPU unasked
    configs = [c.strip() for c in args.configs.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    times = np.arange(args.frames) * runner.KITTI_DT  # times.txt is not in the repo
    t_end = float(times[-1])
    ref_now = reference_error_at(t_end, bigrun_torch.REFERENCE_CSV)
    calib = kitti.load_stereo_calib(os.path.join(synthetic.DEFAULT_KITTI_ROOT, "00"))
    cfg = PipelineConfig()
    print(f"# prefix {args.frames} frames (t={t_end:.0f}s); digitized reference xz error there: {ref_now:.1f} m", flush=True)

    rows = []
    for lvl in (float(x) for x in args.levels.split(",")):
        pre = load_prefix(args.cache, args.frames, lvl)
        shape = pre.frames[0][0].shape
        # A cache rendered at a reduced size (tests) has its intrinsics rescaled, as the renderer did.
        pre.calib = calib if tuple(shape) == tuple(calib.image_size) else synthetic.scale_calib(calib, shape)
        pre.times = times
        gt = pre.gt_poses
        staged = stage_frames(pre, device)
        del pre
        for seed in seeds:
            out = bigrun_torch.run_configs(staged, gt, times, cfg, configs, device, seed=seed)
            for name, r in out["configs"].items():
                row = dict(
                    config=name,
                    extra_noise=lvl,
                    seed=seed,
                    effective_sigma=(args.base_noise**2 + lvl**2) ** 0.5,
                    frames=len(gt),
                    fps=r["frames_per_sec"],
                    xz_mean_m=r["xz_mean_m"],
                    xz_max_m=r["xz_max_m"],
                    xz_final_m=r["xz_final_m"],
                    ate_rmse_m=r["ate_rmse_m"],
                    pose_ok_frac=r["pose_ok_frac"],
                    tracks_mean=r["tracks_mean"],
                    inliers_mean=r["inliers_mean"],
                    ref_xz_at_t=ref_now,
                    **{k: r[k] for k in ("loops_closed", "lc_verified", "n_keyframes", "main_wait_s") if k in r},
                    graphed=r["graphed"],
                    device_kind=out["device_kind"],
                    power_limit_w=out["power_limit_w"],
                )
                rows.append(row)
                print(json.dumps(row), flush=True)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(rows, f, indent=2)
                        f.write("\n")
        del staged
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
