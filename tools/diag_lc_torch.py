"""Ground-truth diagnosis of loop closure at reference scale on the port (counterpart of
tools/diag_lc.py).

Wraps ``LoopCloser._solve_graph`` during a ``vo_lc`` run over the cached synthetic KITTI-00 feed
and records, for every accepted closure:

  - the keyframe set's translation error against GT BEFORE and AFTER the graph solve (does the
    solve move the archive toward or away from the truth?);
  - the newest loop edge's measurement error: Z against the GT relative pose between its two
    keyframes (is the verification accurate?).

That separates "the loop measurement is wrong" from "the graph distributes the correction
wrongly". The graph solve is float64 numpy on the refiner's thread, so the hook reads host
values only.

    python tools/diag_lc_torch.py [--frames 4500] [--landmarks 54000] [--noise 0.02]
        [--extra-noise 0.0] [--workers N] [--eager] [--cpu] [--out F.json]

The frames come from ``tools/longrun_torch.load_or_render`` (``vo_tpu_torch.bench.preload_cached``'s
cache in the temporary directory: ``tools/render_cache_torch.py`` or ``tools/bigrun_torch.py``
writes the same file), with ``--extra-noise`` added at load time as ``bigrun_torch.py`` adds it,
and are staged on the card. At ``--extra-noise 0.08`` the run is ``bigrun_torch.py
--extra-noise 0.08``'s ``vo_lc``. The current CUDA card unless ``--cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


class ClosureLog:
    """While ``installed``, one event per accepted closure (a graph solve that returned poses):
    the keyframes' frame indices, their poses before and after, and the newest loop edge."""

    def __init__(self):
        self.events: list = []

    @contextlib.contextmanager
    def installed(self):
        from vo_tpu_torch.slam.loop_closure import LoopCloser

        solve = LoopCloser._solve_graph
        log = self

        def logged_solve(lc):
            idxs = np.array([k.frame_idx for k in lc.keyframes])
            before = np.stack([k.pose_c2w.copy() for k in lc.keyframes])
            out = solve(lc)
            if out is not None:
                after = np.stack([k.pose_c2w.copy() for k in lc.keyframes])
                a, b, Z = lc.loop_edges[-1]
                log.events.append((idxs, before, after, (lc.keyframes[a].frame_idx, lc.keyframes[b].frame_idx, np.array(Z))))
            return out

        LoopCloser._solve_graph = logged_solve
        try:
            yield self
        finally:
            LoopCloser._solve_graph = solve

    def rows(self, gt: np.ndarray) -> list[dict]:
        """The reference's row per event, against GT poses indexed by frame."""
        out = []
        for idxs, before, after, (fa, fb, Z) in self.events:
            g = gt[np.clip(idxs, 0, gt.shape[0] - 1)]
            eb = np.linalg.norm(before[:, :3, 3] - g[:, :3, 3], axis=1)
            ea = np.linalg.norm(after[:, :3, 3] - g[:, :3, 3], axis=1)
            Z_gt = np.linalg.inv(gt[fa]) @ gt[fb]
            dz = np.linalg.norm(np.asarray(Z)[:3, 3] - Z_gt[:3, 3])
            out.append(
                dict(
                    loop=(int(fa), int(fb)),
                    z_err_m=round(float(dz), 3),
                    kf_rms_before=round(float(np.sqrt((eb**2).mean())), 3),
                    kf_rms_after=round(float(np.sqrt((ea**2).mean())), 3),
                    kf_max_before=round(float(eb.max()), 3),
                    kf_max_after=round(float(ea.max()), 3),
                )
            )
        return out


def run(pre, cfg, device, n_frames: int | None = None, graph=None):
    """``run_sequence(use_loop_closure=True)`` over ``pre`` with a ``ClosureLog`` installed ->
    (RunResult, ClosureLog)."""
    from vo_tpu_torch.odometry import runner

    log = ClosureLog()
    with log.installed():
        res = runner.run_sequence(pre, cfg, n_frames=n_frames, use_loop_closure=True, device=device, graph=graph)
    return res, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4500)
    ap.add_argument("--landmarks", type=int, default=54000)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--extra-noise", type=float, default=0.0, help="additional load-time sensor noise on the cached frames")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1, help="render processes where the cache is missing")
    ap.add_argument("--eager", action="store_true", help="run with graph=False (default: CUDA graphs on the card)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    ap.add_argument("--out", default=None, help="also write the rows and the summary there (JSON)")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from longrun_torch import load_or_render

    from vo_tpu_torch.bench import stage_frames
    from vo_tpu_torch.config import PipelineConfig
    from vo_tpu_torch.eval import metrics
    from vo_tpu_torch.io import kitti, synthetic
    from vo_tpu_torch.utils.device import resolve

    device = resolve("cpu" if args.cpu else None)  # the card unless --cpu; never the CPU unasked
    root = synthetic.DEFAULT_KITTI_ROOT
    calib = kitti.load_stereo_calib(os.path.join(root, "00"))
    gt = kitti.read_poses(os.path.join(root, "poses", "00.txt"))[: args.frames]
    n = gt.shape[0]
    pre = load_or_render(calib, gt, n, args.landmarks, noise=args.noise, extra_noise=args.extra_noise,
                         workers=args.workers)
    if device.type == "cuda":
        pre = stage_frames(pre, device)
    res, log = run(pre, PipelineConfig(), device, n, graph=False if args.eager else None)
    a = metrics.ate(res.poses, gt)
    summary = dict(ate=round(a["rmse"], 4), ate_max=round(a["max"], 4), **res.refine_stats,
                   graphed=device.type == "cuda" and not args.eager)
    print(json.dumps(summary))
    rows = log.rows(gt)
    for row in rows:
        print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, rows=rows), f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
