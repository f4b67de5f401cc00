"""Reference-scale evaluation on the port: the FULL KITTI-00 trajectory (counterpart of tools/bigrun.py).

Runs the synthetic KITTI-00-geometry feed over the complete committed seq-00 GT trajectory
(``tests/data/kitti/poses/00.txt``: 4,500 poses, all loops) through
``vo_tpu_torch.odometry.runner.run_sequence`` at the default ``PipelineConfig``, in the
configurations ``vo`` (plain), ``vo_lc`` (loop closure), ``vo_ba`` (window BA) and ``vo_ba_lc``.
At this length the loop closer's keyframes outgrow ``LoopConfig.max_keyframes`` (899 keyframes
at ``keyframe_every`` 5 against 512), so its graph is decimated, and the feed holds the
reference's landmark count (12 per pose by default). The frames come from
``vo_tpu_torch.bench.preload_cached``'s cache (render it first with
``tools/render_cache_torch.py --workers N``, or give ``--workers`` here), get ``--extra-noise``
at load time, and are staged on the card once (``stage_s``), outside every timed run.
Frame times are ``i * runner.KITTI_DT``.

    python tools/bigrun_torch.py [--frames 4500] [--landmarks N] [--noise 0.02] [--extra-noise 0.08]
        [--configs vo,vo_lc,vo_ba_lc] [--out BIGRUN_torch_full.json] [--fig-dir figs_torch]
        [--save-traj] [--full-figures] [--workers 8] [--cpu] [--host-frames]
        [--eager | --compare] [--image-size H,W] [--cache-dir DIR]

On the card every run steps through CUDA graphs (``run_sequence(graph=None)``); ``--eager`` runs
with ``graph=False``; ``--compare`` runs each configuration graphed, then eager, in one process,
and records whether the two are equal bit for bit (``first_difference``: the first frame and the
fields that differ, and the refiner's counts). Per configuration the payload holds the
reference's keys (fps, ms/frame, ATE rmse/max, xz mean/max, pose_ok_frac, mean tracks and
inliers, the whole ``refine_stats``), plus ``xz_final_m``, ``peak_memory_bytes``
(``torch.cuda.max_memory_allocated`` over that run, the staged frames included), ``pool_bytes``
(the run's CUDA graph pools; both null on the CPU), ``graphed``, ``n_keyframes`` and
``decimations``; with ``--compare`` also ``bit_equal_to_eager`` and the eager run's figures
(``eager``). At the top: ``device_kind``, ``power_limit_w``, ``stage_s`` and ``graphed``.
``--out`` is rewritten after every configuration. Figures (``error_<config>.png``,
``map_<config>.png`` and, for ``vo``, ``error_parity.png`` against
``REFERENCE_ERROR_CURVE.csv``) go to ``--fig-dir`` through ``vo_tpu_torch.viz.figures``; where
matplotlib is missing the payload says ``"figures": "skipped: no matplotlib"``. ``--save-traj``
writes ``traj_<config>.npz`` (``poses``, ``gt``) there, which ``tools/diag_axes.py --fig-dir
figs_torch`` reads. The current CUDA card unless ``--cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

ALL_CONFIGS = {
    "vo": dict(use_ba=False, use_loop_closure=False),
    "vo_lc": dict(use_ba=False, use_loop_closure=True),
    "vo_ba": dict(use_ba=True, use_loop_closure=False),
    "vo_ba_lc": dict(use_ba=True, use_loop_closure=True),
}
REFERENCE_CSV = os.path.join(REPO, "REFERENCE_ERROR_CURVE.csv")
REFERENCE_ANCHOR = "4500/error.png: ~41 m max xz error, mean ~13-15 m at frame 4500"


def _figures(name: str, res, xz: np.ndarray, gt: np.ndarray, times: np.ndarray, fig_dir: str) -> None:
    """The reference-comparable figures of one configuration (needs matplotlib)."""
    from vo_tpu_torch.viz import figures

    t = times[1 : 1 + xz.shape[0]]
    figures.error_curve(xz, t, path=os.path.join(fig_dir, f"error_{name}.png"))
    figures.trajectory_map(res.poses, gt, path=os.path.join(fig_dir, f"map_{name}.png"))
    if name == "vo" and os.path.exists(REFERENCE_CSV):
        # Drift overlay against the digitised published curve.
        figures.error_parity(xz, t, REFERENCE_CSV, path=os.path.join(fig_dir, "error_parity.png"))


# What ``--compare`` holds equal between the graphed and the eager run (chip_smoke.py's
# ``require_bit_equal``), and the refiner's counts beside them.
COMPARED = ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")
COMPARED_STATS = ("n_keyframes", "decimations", "lc_verified", "loops_closed", "ba_solves")
# The eager run's figures kept beside the graphed run's in a ``--compare`` row.
EAGER_KEYS = ("frames_per_sec", "per_frame_ms", "peak_memory_bytes", "main_wait_s", "worker_lc_dispatch_s",
              "worker_ba_dispatch_s", "ate_rmse_m", "graphed")


def first_difference(a, b) -> dict | None:
    """Where two RunResults first differ, bit for bit, over ``COMPARED`` and the ``COMPARED_STATS`` of
    their ``refine_stats``; None where they are equal. Per-frame fields name the earliest frame that
    differs (history row r is frame r + 1) and every field that differs there; ``landmarks`` names
    its first differing row."""
    per_frame: dict = {}
    other: dict = {}
    for k in COMPARED:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        if x.shape != y.shape:
            other[k] = f"shape {x.shape} against {y.shape}"
            continue
        if x.size == 0:
            continue
        rows = np.flatnonzero(~(x == y).reshape(x.shape[0], -1).all(axis=1))
        if rows.size and k == "landmarks":
            other[k] = f"row {int(rows[0])} of {x.shape[0]}"
        elif rows.size:
            per_frame[k] = int(rows[0]) + 1
    stats = {k: (a.refine_stats.get(k), b.refine_stats.get(k)) for k in COMPARED_STATS
             if a.refine_stats.get(k) != b.refine_stats.get(k)}
    if not (per_frame or other or stats):
        return None
    out: dict = {}
    if per_frame:
        frame = min(per_frame.values())
        out["frame"] = frame
        out["fields"] = [k for k, f in per_frame.items() if f == frame]
    if a.poses.shape == b.poses.shape and a.poses.size:
        out["max_abs_pose_diff"] = float(np.abs(a.poses.astype(np.float64) - b.poses.astype(np.float64)).max())
    if other:
        out["other"] = other
    if stats:
        out["refine_stats"] = stats
    return out


@contextlib.contextmanager
def _watch_pools(cuda: bool, seen: list):
    """While open, ``seen[0]`` is the most the graph pools held after any capture, less what they held
    when it opened (the captures of earlier runs, not yet released)."""
    from vo_tpu_torch.utils import graphs

    if not cuda:
        yield
        return
    base = graphs.pools_bytes()
    capture = graphs.capture

    def watched(*a, **k):
        out = capture(*a, **k)
        seen[0] = max(seen[0], graphs.pools_bytes() - base)
        return out

    graphs.capture = watched
    try:
        yield
    finally:
        graphs.capture = capture


def run_one(pre, gt, cfg, name: str, device, seed: int = 0, graph=None, **viz_kw):
    """One configuration of ``ALL_CONFIGS`` over the first len(gt) frames of ``pre`` -> (RunResult,
    row, per-frame xz error). The row holds the reference's keys, the whole ``refine_stats`` and the port's: ``xz_final_m``,
    ``peak_memory_bytes`` (``torch.cuda.max_memory_allocated`` over the run, the staged frames
    included), ``pool_bytes`` (what its CUDA graphs' pools hold; both null on the CPU), ``graphed``,
    and ``n_keyframes`` / ``decimations`` (0 where the configuration has no refiner / loop closer)."""
    import torch

    from vo_tpu_torch.eval import metrics
    from vo_tpu_torch.odometry import runner

    cuda = device.type == "cuda"
    if cuda:
        # The graphs of an earlier run are unreachable once it returned: release their pools.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    pools = [0]
    with _watch_pools(cuda, pools):
        res = runner.run_sequence(pre, cfg, n_frames=len(gt), seed=seed, device=device, graph=graph,
                                  **ALL_CONFIGS[name], **viz_kw)
    a = metrics.ate(res.poses, gt)
    xz = metrics.xz_error(res.poses, gt)
    row = dict(
        frames_per_sec=res.frames_per_sec,
        per_frame_ms=res.per_frame_ms,
        ate_rmse_m=a["rmse"],
        ate_max_m=a["max"],
        xz_mean_m=float(xz.mean()),
        xz_max_m=float(xz.max()),
        pose_ok_frac=float(res.pose_ok.mean()),
        tracks_mean=float(res.n_tracks.mean()),
        inliers_mean=float(res.n_inliers.mean()),
        **res.refine_stats,
        xz_final_m=float(xz[-1]),
        peak_memory_bytes=torch.cuda.max_memory_allocated(device) if cuda else None,
        pool_bytes=pools[0] if cuda else None,
        graphed=cuda and graph is not False,
    )
    row.setdefault("n_keyframes", 0)
    row.setdefault("decimations", 0)
    return res, row, xz


def run_configs(pre, gt, times, cfg, configs, device, seed: int = 0, fig_dir: str | None = None,
                save_traj: bool = False, full_figures: bool = False, graph=None, compare: bool = False,
                keep: dict | None = None) -> dict:
    """Each of ``configs`` (names of ``ALL_CONFIGS``) over the first len(gt) frames of ``pre`` on
    ``device``, with ``run_sequence(seed=seed, graph=graph)`` -> {n_frames, seed, device, device_kind,
    power_limit_w, graphed, figures, configs: {name: row}} (``run_one``'s rows). ``compare`` runs each
    configuration again with ``graph=False`` right after and adds ``bit_equal_to_eager``, the eager
    run's figures (``eager``) and, where the two differ, ``first_difference``. ``fig_dir`` writes the
    figures (and with ``save_traj`` the trajectories) there; ``full_figures`` also dumps the
    reference's four views at the last frame of ``vo``. ``keep``, where given, receives each
    configuration's RunResult under its name."""
    import torch

    from vo_tpu_torch.bench import power_limit_w
    from vo_tpu_torch.utils.device import resolve

    device = resolve(device)
    cuda = device.type == "cuda"
    n = len(gt)
    draw = fig_dir is not None and importlib.util.find_spec("matplotlib") is not None
    if fig_dir is not None:
        os.makedirs(fig_dir, exist_ok=True)
    results = {}
    for name in configs:
        viz_kw = {}
        if draw and full_figures and name == "vo":
            viz_kw = dict(viz_every=n - 1, viz_dir=os.path.join(fig_dir, "_frames"))
        res, row, xz = run_one(pre, gt, cfg, name, device, seed=seed, graph=graph, **viz_kw)
        if compare:
            eager, eager_row, _ = run_one(pre, gt, cfg, name, device, seed=seed, graph=False)
            diff = first_difference(res, eager)
            row["bit_equal_to_eager"] = diff is None
            if diff is not None:
                row["first_difference"] = diff
            row["eager"] = {k: eager_row.get(k) for k in EAGER_KEYS}
            del eager
        results[name] = row
        print(name, json.dumps(row), flush=True)
        if save_traj and fig_dir is not None:
            np.savez_compressed(os.path.join(fig_dir, f"traj_{name}.npz"), poses=res.poses, gt=gt)
        if draw:
            _figures(name, res, xz, gt, times, fig_dir)
            src = os.path.join(fig_dir, "_frames", str(n - 1))
            for fig_name in ("view", "3d_map") if viz_kw else ():
                if os.path.exists(os.path.join(src, f"{fig_name}.png")):
                    shutil.copy(os.path.join(src, f"{fig_name}.png"), os.path.join(fig_dir, f"{fig_name}_{n}.png"))
        if keep is not None:
            keep[name] = res
        del res
    if fig_dir is None:
        figs = None
    else:
        figs = f"written to {fig_dir}" if draw else "skipped: no matplotlib"
    return dict(
        n_frames=n,
        seed=seed,
        device=device.type,
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        power_limit_w=power_limit_w(device),
        graphed=cuda and graph is not False,
        figures=figs,
        configs=results,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4500)
    ap.add_argument("--landmarks", type=int, default=None, help="default 12 per GT pose")
    ap.add_argument("--noise", type=float, default=0.02, help="sensor noise stddev ([0,1] units)")
    ap.add_argument("--extra-noise", type=float, default=0.0, help="additional load-time sensor noise on the cached frames")
    ap.add_argument("--save-traj", action="store_true", help="save each config's poses npz under fig-dir")
    ap.add_argument("--full-figures", action="store_true", help="also dump the reference's view/3d_map figures at the last frame")
    ap.add_argument("--out", default=None)
    ap.add_argument("--configs", default="vo,vo_lc,vo_ba_lc")
    ap.add_argument("--fig-dir", default="figs_torch")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    ap.add_argument("--host-frames", action="store_true", help="feed frames from the host per frame instead of staging them on the card")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1, help="render processes where the cache is missing")
    ap.add_argument("--image-size", default=None, help="H,W of the rendered frames (default: the calibration's)")
    ap.add_argument("--cache-dir", default=None, help="where the frame cache is read or written (default: the temporary directory)")
    ap.add_argument("--eager", action="store_true", help="run with graph=False (default: CUDA graphs on the card)")
    ap.add_argument("--compare", action="store_true",
                    help="run each configuration graphed, then eager, and record whether they are equal bit for bit")
    args = ap.parse_args(argv)
    configs = [c.strip() for c in args.configs.split(",")]
    unknown = sorted(set(configs) - set(ALL_CONFIGS))
    if unknown:
        ap.error(f"unknown configs {unknown}; choose from {sorted(ALL_CONFIGS)}")
    if args.eager and args.compare:
        ap.error("--compare runs each configuration graphed and eager: drop --eager")
    image_size = tuple(int(x) for x in args.image_size.split(",")) if args.image_size else None

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from longrun_torch import load_or_render

    from vo_tpu_torch.bench import stage_frames
    from vo_tpu_torch.config import PipelineConfig
    from vo_tpu_torch.io import kitti, synthetic
    from vo_tpu_torch.odometry import runner
    from vo_tpu_torch.utils.device import resolve

    device = resolve("cpu" if args.cpu else None)  # the card unless --cpu; never the CPU unasked
    root = synthetic.DEFAULT_KITTI_ROOT
    calib = kitti.load_stereo_calib(os.path.join(root, "00"))
    gt = kitti.read_poses(os.path.join(root, "poses", "00.txt"))[: args.frames]
    n = gt.shape[0]
    times = np.arange(n) * runner.KITTI_DT  # times.txt is not in the repo
    # ~12 per pose keeps the per-frame splat count near the 600-frame long run's (the 100 m
    # visibility horizon bounds the rest).
    n_lm = args.landmarks if args.landmarks else 12 * n
    pre = load_or_render(calib, gt, n, n_lm, image_size=image_size, noise=args.noise, extra_noise=args.extra_noise,
                         cache_dir=args.cache_dir, workers=args.workers)
    pre.times = times
    calib = pre.calib  # rescaled where --image-size differs from the calibration's
    stage_s = None
    if not args.host_frames and not args.cpu:
        t0 = time.perf_counter()
        pre = stage_frames(pre, device)  # the host frames are dropped: only the card holds them now
        stage_s = time.perf_counter() - t0
        print(f"# staged {n} frame pairs on the card in {stage_s:.1f}s", flush=True)

    payload = dict(
        n_frames=n,
        n_landmarks=n_lm,
        feed_severity=dict(
            noise=args.noise, extra_noise=args.extra_noise,
            effective_sigma=(args.noise**2 + args.extra_noise**2) ** 0.5, n_landmarks=n_lm,
        ),
        noise=args.noise,
        trajectory=f"full KITTI 00 GT trajectory (all loops): the committed poses, {n} frames",
        reference_anchor=REFERENCE_ANCHOR,
        stage_s=stage_s,
        image_size=list(calib.image_size),
        compare=args.compare,
        configs={},
    )
    for name in configs:
        part = run_configs(pre, gt, times, PipelineConfig(), [name], device, fig_dir=args.fig_dir,
                           save_traj=args.save_traj, full_figures=args.full_figures,
                           graph=False if args.eager else None, compare=args.compare)
        payload.update({k: v for k, v in part.items() if k not in ("configs", "n_frames")})
        payload["configs"].update(part["configs"])
        if args.out:
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=2)
                f.write("\n")
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
