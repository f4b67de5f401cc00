"""The plain reference of one frame of the VO step, worked out from the frames alone.

What the program's step (vo_tpu_torch/odometry/pipeline.py::_step_core and
odometry/landmarks.py::insert) computes for frame ``t`` depends on the stereo pairs of frames
``t - 1`` and ``t`` and on the RANSAC draw of frame ``t`` only: the previous frame's stereo set is
its own detection and stereo match, the temporal cascade reads nothing older, and the sample
stream is the job's seed advanced by one fixed-size draw per frame. So the reference recomputes
any frame by itself, with no state carried from the program, and nothing here imports the
program: every function below is a frozen copy in this folder, in plain PyTorch, with the
kernels' plain versions.

Detection is batched as the program batches it (a group of frames, or one frame's pair), since
a batch of four images and a batch of two round their last bits differently.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import config as rcfg
from . import se3
from .camera import StereoCalib, calib_from_projections
from .padding import gather_rows
from .ransac import estimate_world_pose
from .sift import Features, detect_and_describe
from .track import stereo_features_with_matches, track
from .triangulate import triangulate_rectified


def pipeline_config(d: dict) -> rcfg.PipelineConfig:
    """The frozen PipelineConfig from a configuration file's ``pipeline`` object."""
    sub = {f.name: f.type for f in dataclasses.fields(rcfg.PipelineConfig)}
    kw = {}
    for k, v in d.items():
        if isinstance(v, dict):
            cls = getattr(rcfg, sub[k]) if isinstance(sub[k], str) else sub[k]
            v = cls(**{kk: tuple(vv) if isinstance(vv, list) else vv for kk, vv in v.items()})
        kw[k] = v
    return rcfg.PipelineConfig(**kw)


def calib(P1: np.ndarray, P2: np.ndarray, image_size, device) -> StereoCalib:
    return calib_from_projections(P1, P2, image_size=image_size, device=device)


def detect(imgs: torch.Tensor, cfg: rcfg.PipelineConfig) -> Features:
    """uint8 [B, H, W] -> Features [B, K, ...] (the step's normalisation, then detection)."""
    return detect_and_describe(imgs.to(torch.float32) * (1.0 / 255.0), cfg.sift)


def image(feats: Features, i: int) -> Features:
    return Features(*(f[i] for f in feats))


class FrameRef(NamedTuple):
    rel: torch.Tensor  # [4, 4] the estimate (meaningful where ok)
    ok: bool
    n_tracks: int
    n_inliers: int
    new_landmarks: torch.Tensor  # [M, 3] the landmarks the frame inserts, in its camera's frame


def frame(prev_l: Features, prev_r: Features, cur_l: Features, cur_r: Features, calib: StereoCalib,
          cfg: rcfg.PipelineConfig, gen: torch.Generator) -> FrameRef:
    """Frame ``t`` from the single-image features of frames ``t - 1`` and ``t``; ``gen`` stands
    where the program's sample stream stands before frame ``t`` (one draw is taken)."""
    cap = cfg.max_tracks
    prev, _ = stereo_features_with_matches(prev_l, prev_r, cfg.matcher, cap)
    stereo, m_st = stereo_features_with_matches(cur_l, cur_r, cfg.matcher, cap)
    tr = track(prev, cur_l, cur_r, cfg.matcher, cap)
    cur_l_px = gather_rows(cur_l.xy, tr.cur_l_idx, tr.mask)
    old_l_px = gather_rows(prev.l_xy, tr.old_row, tr.mask)
    old_r_px = gather_rows(prev.r_xy, tr.old_row, tr.mask)
    X_prev = triangulate_rectified(old_l_px, old_r_px, calib)
    depth_ok = (X_prev[:, 2] > 0.1) & (X_prev[:, 2] < 400.0)
    pose_mask = tr.mask & depth_ok
    est = estimate_world_pose(cur_l_px, X_prev, pose_mask, calib, cfg.ransac, gen=gen)

    # The landmarks the frame inserts: stereo pairs whose left feature was not tracked, every
    # ``stride``-th row, depth-gated (landmarks.insert), in the camera's frame.
    eq = (m_st.a_idx[:, None] == tr.cur_l_idx[None, :]) & m_st.mask[:, None] & tr.mask[None, :]
    new_mask = m_st.mask & ~eq.any(dim=1)
    new_l_px = gather_rows(cur_l.xy, m_st.a_idx, new_mask)
    new_r_px = gather_rows(cur_r.xy, m_st.b_idx, new_mask)
    X = triangulate_rectified(new_l_px, new_r_px, calib)
    rows = torch.arange(X.shape[0], device=X.device)
    lc = cfg.landmarks
    keep = (
        new_mask & (rows % lc.stride == 0) & (X[:, 2] > lc.min_depth) & (X[:, 2] <= lc.max_depth)
        & torch.isfinite(X).all(dim=1)
    )
    return FrameRef(
        rel=est.pose_c2w, ok=bool(est.ok), n_tracks=int(pose_mask.sum()), n_inliers=int(est.n_inliers),
        new_landmarks=X[keep],
    )


def to_world(pose_c2w: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return se3.apply(pose_c2w, pts)

