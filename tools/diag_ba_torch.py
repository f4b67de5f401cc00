"""Per-solve ground-truth diagnosis of window BA on the port (counterpart of tools/diag_ba.py).

For every window solve of a ``use_ba=True`` run over the synthetic out-and-back feed this logs,
against the known GT poses:

  - the window-relative error of each keyframe (its pose relative to the window's first
    keyframe, against the GT relative pose) BEFORE and AFTER the solve: whether the solver
    itself improves or degrades the window, apart from inherited absolute drift;
  - the absolute error of the last keyframe before and after;
  - the solve's cost0 -> cost and n_obs (``WindowedBA.last_result``).

The reference's tool wraps ``WindowedBA.optimize``, which its refiner never calls (the refiner
calls ``dispatch`` and ``collect``), so it logs no solve. This one wraps ``WindowedBA.prepare``,
where a window's poses enter a solve, and ``WindowedBA.collect``, where every solve the runner
uses is gated: one row per solve that passes the cost gate, "before" being the window's poses
as they entered the solve and "after" the solve's poses (``T_new``). ``solved`` says whether
the solve also passed the correction gate and was handed to the trajectory; the counts of
improving and degrading windows are over those. On the card the solve is a graph replay on the
refiner's thread: the hooks read host values only (the keyframes' poses, ``last_result``) and
never wait on the device.

    python tools/diag_ba_torch.py [--frames 200] [--landmarks 9000] [--half] [--eager] [--cpu]
        [--out F.json]

The feed renders from the committed KITTI-00 geometry (``tools/longrun_torch.load_or_render``,
cached in the temporary directory). The current CUDA card unless ``--cpu``.
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


def rel_err(Ta: np.ndarray, Tb: np.ndarray) -> tuple[float, float]:
    """(translation m, rotation deg) of Ta vs Tb."""
    D = np.linalg.inv(Tb) @ Ta
    dt = float(np.linalg.norm(D[:3, 3]))
    c = np.clip((np.trace(D[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return dt, float(np.degrees(np.arccos(c)))


class SolveLog:
    """While ``installed``, one row per window solve that passes the cost gate (module docstring).
    ``gt_runner``: the GT poses in the runner's frame (the estimate starts at identity)."""

    def __init__(self, gt_runner: np.ndarray):
        self.gt = gt_runner
        self.rows: list[dict] = []
        self.last_n_obs = None  # n_obs of the last logged solve's ``last_result``
        self._entered: dict = {}  # window frame indices -> the window's poses as the solve got them

    @contextlib.contextmanager
    def installed(self):
        from vo_tpu_torch.odometry.ba_runner import WindowedBA

        prepare, collect = WindowedBA.prepare, WindowedBA.collect
        log = self

        def logged_prepare(wba):
            out = prepare(wba)
            if out is not None:
                log._entered[tuple(out[1])] = np.stack([kf.pose_c2w for kf in wba.window]).astype(np.float64)
            return out

        def logged_collect(wba, drain=False):
            # One ripe solve at a time through the unchanged gates, so that each one's
            # last_result is read; the gates of a solve read nothing of the others.
            ripe = len(wba._pending) if drain else len(wba._pending) - wba.PIPELINE_DEPTH + 1
            got = []
            for _ in range(max(ripe, 0)):
                head = wba._pending.popleft()
                rest = list(wba._pending)
                wba._pending.clear()
                wba._pending.append(head)
                before = wba.last_result
                out = collect(wba, drain=True)
                wba._pending.extend(rest)
                entered = log._entered.pop(tuple(head[1]), None)
                if wba.last_result is not before and entered is not None:
                    log._row(head[1], entered, wba.last_result, solved=bool(out))
                got += out
            return got

        WindowedBA.prepare, WindowedBA.collect = logged_prepare, logged_collect
        try:
            yield self
        finally:
            WindowedBA.prepare, WindowedBA.collect = prepare, collect

    def _row(self, kf_idxs: list, entered: np.ndarray, res, solved: bool) -> None:
        n = len(kf_idxs)
        after = np.asarray(res.T_c2w[:n], np.float64)
        row = dict(kf=int(kf_idxs[-1]), solved=solved, cost0=round(float(res.cost0), 1), cost=round(float(res.cost), 1),
                   n_obs=int(res.n_obs))
        self.last_n_obs = row["n_obs"]
        G0 = self.gt[kf_idxs[0]]
        for tag, poses in (("before", entered), ("after", after)):
            errs_t, errs_r = [], []
            for k in range(1, n):
                dt, dr = rel_err(np.linalg.inv(poses[0]) @ poses[k], np.linalg.inv(G0) @ self.gt[kf_idxs[k]])
                errs_t.append(dt)
                errs_r.append(dr)
            row[f"rel_t_{tag}"] = round(float(np.mean(errs_t)), 4)
            row[f"rel_r_{tag}"] = round(float(np.mean(errs_r)), 4)
            row[f"rel_t_last_{tag}"] = round(errs_t[-1], 4)
        gL = self.gt[kf_idxs[-1]]
        row["abs_t_before"] = round(rel_err(entered[-1], gL)[0], 4)
        row["abs_t_after"] = round(rel_err(after[-1], gL)[0], 4)
        self.rows.append(row)

    def counts(self) -> dict:
        solved = [r for r in self.rows if r["solved"]]
        improving = sum(r["rel_t_after"] < r["rel_t_before"] for r in solved)
        return dict(solves_improving_window=improving, solves_degrading_window=len(solved) - improving)


def run(pre, poses: np.ndarray, cfg, device, n_frames: int | None = None, graph=None):
    """``run_sequence(use_ba=True)`` over ``pre`` with a ``SolveLog`` installed -> (RunResult, SolveLog)."""
    from vo_tpu_torch.odometry import runner

    log = SolveLog(np.einsum("ij,tjk->tik", np.linalg.inv(poses[0]), poses))
    with log.installed():
        res = runner.run_sequence(pre, cfg, n_frames=n_frames, use_ba=True, device=device, graph=graph)
    return res, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--landmarks", type=int, default=9000)
    ap.add_argument("--half", action="store_true", help="half-resolution frames (fast CPU diagnosis)")
    ap.add_argument("--eager", action="store_true", help="run with graph=False (default: CUDA graphs on the card)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    ap.add_argument("--out", default=None, help="also write the rows and the summary there (JSON)")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from longrun_torch import load_or_render, out_and_back_poses

    from vo_tpu_torch.bench import stage_frames
    from vo_tpu_torch.config import PipelineConfig
    from vo_tpu_torch.eval import metrics
    from vo_tpu_torch.io import kitti, synthetic
    from vo_tpu_torch.utils.device import resolve

    device = resolve("cpu" if args.cpu else None)  # the card unless --cpu; never the CPU unasked
    calib = kitti.load_stereo_calib(os.path.join(synthetic.DEFAULT_KITTI_ROOT, "00"))
    poses = out_and_back_poses(args.frames)
    pre = load_or_render(calib, poses, args.frames, args.landmarks, image_size=(188, 620) if args.half else None)
    if device.type == "cuda":
        pre = stage_frames(pre, device)
    res, log = run(pre, poses, PipelineConfig(), device, args.frames, graph=False if args.eager else None)
    for row in log.rows:
        print(json.dumps(row), flush=True)
    a = metrics.ate(res.poses, poses)
    summary = dict(ate_rmse=round(a["rmse"], 4), ate_max=round(a["max"], 4), **log.counts(), **res.refine_stats,
                   graphed=device.type == "cuda" and not args.eager)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(rows=log.rows, summary=summary), f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
