"""Offline figure generation replicating the reference's four views (copy of vo_tpu.viz.figures:
numpy + matplotlib; imported only by the runner's live_viz and the command line, so the package
imports without matplotlib).

Reference counterparts:
- ``feed_view``      — ShowFeaturesOnFeed.m:1-16: left image, green 'x' at
  current stereo features, red old->current track segments, green text with
  each feature's 3D displacement (meters, ShowFeaturesOnFeed.m:11-12).
- ``trajectory_map`` — PlotOnMap.m:13-15: GT (black) vs estimate (dashed)
  in the xz plane.
- ``error_curve``    — VO.m:182-187: xz error vs time.
- ``map_3d``         — ShowPoseAndLandmarks.m:1-17: red landmark cloud +
  blue trajectory segments, equal axes.

All figures are written headlessly (Agg) to PNG, mirroring the reference's
every-100-frames dump layout img/<frame>/{view,map,error,3d_map}.png
(VO.m:168-204).
"""
from __future__ import annotations

import os

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt


def feed_view(
    image: np.ndarray,
    cur_px: np.ndarray,
    old_px: np.ndarray,
    disp_3d: np.ndarray,
    mask: np.ndarray,
    stereo_px: np.ndarray | None = None,
    stereo_mask: np.ndarray | None = None,
    max_labels: int = 60,
    path: str | None = None,
):
    """Feature overlay on the left frame (ShowFeaturesOnFeed.m)."""
    fig, ax = plt.subplots(figsize=(12.5, 4.2), dpi=100)
    ax.imshow(image, cmap="gray", vmin=0.0, vmax=1.0)
    m = np.asarray(mask, bool)
    cur, old, disp = np.asarray(cur_px)[m], np.asarray(old_px)[m], np.asarray(disp_3d)[m]
    if stereo_px is not None:
        sm = np.asarray(stereo_mask, bool)
        sp = np.asarray(stereo_px)[sm]
        ax.plot(sp[:, 0], sp[:, 1], "gx", ms=4, mew=1)  # green x (ShowFeaturesOnFeed.m:7)
    for i in range(cur.shape[0]):
        ax.plot([old[i, 0], cur[i, 0]], [old[i, 1], cur[i, 1]], "r-", lw=1)
    for i in range(min(cur.shape[0], max_labels)):
        ax.text(cur[i, 0], cur[i, 1], f"{disp[i]:.1f}", color="lime", fontsize=5)
    ax.set_xlim(0, image.shape[1])
    ax.set_ylim(image.shape[0], 0)
    ax.set_title("tracked features (red: motion, label: 3D displacement m)")
    return _finish(fig, path)


def trajectory_map(est_poses: np.ndarray, gt_poses: np.ndarray | None = None, path: str | None = None):
    """xz-plane trajectory: GT black solid, estimate dashed (PlotOnMap.m:13-15)."""
    fig, ax = plt.subplots(figsize=(6, 6), dpi=100)
    if gt_poses is not None and len(gt_poses):
        g = np.asarray(gt_poses)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], "k-", lw=1.5, label="ground truth")
    e = np.asarray(est_poses)[:, :3, 3]
    ax.plot(e[:, 0], e[:, 2], "b--", lw=1.2, label="estimate")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title("trajectory (xz plane)")
    return _finish(fig, path)


def error_curve(errors: np.ndarray, times: np.ndarray | None = None, path: str | None = None):
    """Per-frame xz error vs time (VO.m:182-187)."""
    fig, ax = plt.subplots(figsize=(7, 3.5), dpi=100)
    errors = np.asarray(errors)
    x = np.asarray(times)[: len(errors)] if times is not None else np.arange(len(errors))
    ax.plot(x, errors, "b-", lw=1)
    ax.set_xlabel("time [s]" if times is not None else "frame")
    ax.set_ylabel("xz error [m]")
    ax.set_title("translation error vs ground truth")
    ax.grid(alpha=0.3)
    return _finish(fig, path)


def map_3d(
    landmarks: np.ndarray,
    est_poses: np.ndarray,
    path: str | None = None,
    max_points: int = 200_000,
):
    """Landmark cloud (red dots) + trajectory (blue) (ShowPoseAndLandmarks.m)."""
    fig = plt.figure(figsize=(7, 7), dpi=100)
    ax = fig.add_subplot(projection="3d")
    lm = np.asarray(landmarks)
    if lm.shape[0] > max_points:
        lm = lm[:: lm.shape[0] // max_points + 1]
    if lm.size:
        ax.scatter(lm[:, 0], lm[:, 2], -lm[:, 1], s=0.5, c="r", alpha=0.4)
    t = np.asarray(est_poses)[:, :3, 3]
    if t.size:
        ax.plot(t[:, 0], t[:, 2], -t[:, 1], "b-", lw=2)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    # axis equal (ShowPoseAndLandmarks.m:16)
    pts = np.concatenate([lm, t], axis=0) if lm.size else t
    if pts.size:
        c = pts.mean(0)
        r = max(np.abs(pts - c).max(), 1.0)
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[2] - r, c[2] + r)
        ax.set_zlim(-c[1] - r, -c[1] + r)
    return _finish(fig, path)


def error_parity(
    errors: np.ndarray,
    times: np.ndarray,
    reference_csv: str,
    path: str | None = None,
    label: str = "this engine (plain VO)",
):
    """Overlay this engine's xz-error curve on the DIGITIZED reference curve
    (tools/digitize_reference.py, from the reference's 4500/error.png): the
    apples-to-apples drift comparison at matched feed severity (VERDICT r5
    item 1)."""
    ref = np.loadtxt(reference_csv, delimiter=",", comments="#")
    fig, ax = plt.subplots(figsize=(7.5, 4), dpi=110)
    ax.plot(ref[:, 0], ref[:, 1], "-", color="0.45", lw=1.4,
            label="reference (digitized 4500/error.png)")
    errors = np.asarray(errors)
    ax.plot(np.asarray(times)[: len(errors)], errors, "b-", lw=1.1, label=label)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("xz error [m]  (PlotOnMap.m:20)")
    ax.set_title("drift vs the reference's published curve, KITTI 00")
    ax.legend()
    ax.grid(alpha=0.3)
    return _finish(fig, path)


def frame_report(out_dir: str, frame_idx: int, image, frame_out, result_so_far, gt_poses, times=None, landmarks=None):
    """Write the reference's img/<i>/ four-figure dump for one frame (VO.m:168-204)."""
    d = os.path.join(out_dir, str(frame_idx))
    os.makedirs(d, exist_ok=True)
    feed_view(
        image,
        frame_out["tracked_cur_px"],
        frame_out["tracked_old_px"],
        frame_out["tracked_disp_3d"],
        frame_out["tracked_mask"],
        path=os.path.join(d, "view.png"),
    )
    est = np.asarray(result_so_far)
    trajectory_map(est, gt_poses, path=os.path.join(d, "map.png"))
    from ..eval.metrics import xz_error

    if gt_poses is not None and len(est):
        err = xz_error(est, np.asarray(gt_poses))
        error_curve(err, times, path=os.path.join(d, "error.png"))
    if landmarks is not None:
        map_3d(landmarks, est, path=os.path.join(d, "3d_map.png"))


def _finish(fig, path):
    if path is not None:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
