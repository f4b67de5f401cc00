"""The per-frame VO step (port of vo_tpu.odometry.pipeline).

The reference's main-loop body (VO.m:64-232): detect, stereo match, 4-view
temporal cascade, triangulate, RANSAC-P3P, chain into the world frame, pick
the new stereo features for the landmark map, thread persistent track ids.
Static shapes and masks throughout; the first frame falls out of the mask
algebra (an empty previous set tracks nothing), and a failed pose falls back
to constant velocity. Frame-dependent choices are ``torch.where`` on device
tensors, so the step never waits on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..frontend.sift import Features, detect_and_describe
from ..frontend.track import StereoFeatures, TrackResult, stereo_features_with_matches, track
from ..geom import se3
from ..geom.camera import StereoCalib
from ..geom.triangulate import triangulate_rectified
from ..pose.ransac import estimate_world_pose
from ..utils.device import resolve
from ..utils.padding import gather_rows


class VOState(NamedTuple):
    prev: StereoFeatures  # stereo-matched features of the previous frame
    pose_c2w: torch.Tensor  # [4, 4] world pose (identity at start, VO.m:58)
    prev_rel: torch.Tensor  # [4, 4] last relative pose (constant-velocity fallback)
    frame_idx: torch.Tensor  # scalar int64
    next_id: torch.Tensor  # scalar int32, persistent track-id counter
    gen: torch.Generator  # RANSAC sample stream (the reference's PRNG key)


class FrameOutput(NamedTuple):
    pose_c2w: torch.Tensor  # [4, 4] world pose after this frame
    rel_pose: torch.Tensor  # [4, 4] estimated relative pose
    pose_ok: torch.Tensor  # bool: RANSAC succeeded (False on frame 1 / fallback)
    n_tracks: torch.Tensor  # tracked correspondences entering RANSAC
    n_inliers: torch.Tensor
    mean_reproj_err: torch.Tensor
    tracked_cur_px: torch.Tensor  # [C, 2] current left px of tracked features
    tracked_old_px: torch.Tensor  # [C, 2] previous left px
    tracked_disp_3d: torch.Tensor  # [C] 3D displacement magnitude
    tracked_mask: torch.Tensor  # [C]
    new_lm_l_px: torch.Tensor  # [C, 2] left px of NEW stereo features (VO.m:157-158)
    new_lm_r_px: torch.Tensor  # [C, 2]
    new_lm_mask: torch.Tensor  # [C]


def init_state(cfg: PipelineConfig, seed: int = 0, device=None) -> VOState:
    """The state before frame 0, on ``device`` (None: the current CUDA device)."""
    device = resolve(device)
    c = cfg.max_tracks
    z2 = torch.zeros((c, 2), dtype=torch.float32, device=device)
    zd = torch.zeros((c, 128), dtype=torch.float32, device=device)
    prev = StereoFeatures(
        l_xy=z2,
        r_xy=z2.clone(),
        l_desc=zd,
        r_desc=zd.clone(),
        mask=torch.zeros(c, dtype=torch.bool, device=device),
        ids=torch.full((c,), -1, dtype=torch.int32, device=device),
    )
    eye = torch.eye(4, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return VOState(
        prev=prev,
        pose_c2w=eye,
        prev_rel=eye.clone(),
        frame_idx=torch.zeros((), dtype=torch.int64, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        gen=gen,
    )


def _membership(query_idx, query_mask, ref_idx, ref_mask) -> torch.Tensor:
    """query_idx[i] in the ref_idx set? -> [Cq] bool (masked)."""
    eq = (query_idx[:, None] == ref_idx[None, :]) & query_mask[:, None] & ref_mask[None, :]
    return eq.any(dim=1)


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] float32 (the runner stages 1 byte/px)."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * (1.0 / 255.0)
    return img


def _step_core(
    state: VOState,
    feats_l: Features,
    feats_r: Features,
    calib: StereoCalib,
    cfg: PipelineConfig,
    triples: torch.Tensor | None = None,
) -> tuple[VOState, FrameOutput]:
    """Everything after detection: the serial, pose-dependent part of a frame.

    RANSAC draws from ``state.gen`` unless ``triples`` [H, 3] are given.
    """
    cap = cfg.max_tracks
    stereo, m_st = stereo_features_with_matches(feats_l, feats_r, cfg.matcher, cap)

    # --- temporal 4-view cascade (VO.m:106-107 / 280-334) ---
    tr: TrackResult = track(state.prev, feats_l, feats_r, cfg.matcher, cap)
    cur_l_px = gather_rows(feats_l.xy, tr.cur_l_idx, tr.mask)
    cur_r_px = gather_rows(feats_r.xy, tr.cur_r_idx, tr.mask)
    old_l_px = gather_rows(state.prev.l_xy, tr.old_row, tr.mask)
    old_r_px = gather_rows(state.prev.r_xy, tr.old_row, tr.mask)

    # --- triangulate both frames (VO.m:113-116) ---
    X_prev = triangulate_rectified(old_l_px, old_r_px, calib)
    X_cur = triangulate_rectified(cur_l_px, cur_r_px, calib)
    depth_ok = (X_prev[:, 2] > 0.1) & (X_prev[:, 2] < 400.0)
    pose_mask = tr.mask & depth_ok

    # --- RANSAC-P3P world pose (VO.m:123-127) ---
    est = estimate_world_pose(cur_l_px, X_prev, pose_mask, calib, cfg.ransac, gen=state.gen, triples=triples)

    # --- chain / fallback (VO.m:130): identity on frame 1, constant velocity on failure ---
    first = state.frame_idx == 0
    eye = torch.eye(4, dtype=state.prev_rel.dtype, device=state.prev_rel.device)
    rel = torch.where(est.ok, est.pose_c2w, torch.where(first, eye, state.prev_rel))
    pose = torch.where(first, state.pose_c2w, se3.compose(state.pose_c2w, rel))

    # --- new-landmark selection (VO.m:141-161): stereo pairs whose left feature was not tracked ---
    tracked_l = _membership(m_st.a_idx, m_st.mask, tr.cur_l_idx, tr.mask)
    new_mask = m_st.mask & ~tracked_l
    new_l_px = gather_rows(feats_l.xy, m_st.a_idx, new_mask)
    new_r_px = gather_rows(feats_r.xy, m_st.b_idx, new_mask)

    disp = torch.linalg.vector_norm(X_cur - X_prev, dim=-1)

    # --- persistent track ids: a stereo row inherits the id of the previous-frame
    # feature its left feature was tracked from; untracked rows get fresh ids ---
    eq = (m_st.a_idx[:, None] == tr.cur_l_idx[None, :]) & m_st.mask[:, None] & tr.mask[None, :]
    inherited_pos = torch.argmax(eq.to(torch.int32), dim=1)  # first match; CUDA has no bool argmax
    has_parent = eq.any(dim=1)
    parent_ids = state.prev.ids[tr.old_row[inherited_pos]]
    fresh_needed = m_st.mask & ~has_parent
    fresh_ids = state.next_id + torch.cumsum(fresh_needed.to(torch.int32), dim=0, dtype=torch.int32) - 1
    minus1 = torch.full_like(fresh_ids, -1)
    ids = torch.where(m_st.mask, torch.where(has_parent, parent_ids, fresh_ids), minus1).to(torch.int32)
    next_id = state.next_id + fresh_needed.sum(dtype=torch.int32)

    new_state = VOState(
        prev=stereo._replace(ids=ids),
        pose_c2w=pose,
        prev_rel=rel,
        frame_idx=state.frame_idx + 1,
        next_id=next_id,
        gen=state.gen,
    )
    out = FrameOutput(
        pose_c2w=pose,
        rel_pose=rel,
        pose_ok=est.ok & ~first,
        n_tracks=pose_mask.sum(),
        n_inliers=est.n_inliers,
        mean_reproj_err=est.mean_err,
        tracked_cur_px=cur_l_px,
        tracked_old_px=old_l_px,
        tracked_disp_3d=torch.where(tr.mask, disp, 0.0),
        tracked_mask=tr.mask,
        new_lm_l_px=new_l_px,
        new_lm_r_px=new_r_px,
        new_lm_mask=new_mask,
    )
    return new_state, out


def _image_features(feats: Features, i: int) -> Features:
    return Features(*(f[i] for f in feats))


def vo_step_multi(state: VOState, frames, calib: StereoCalib, cfg: PipelineConfig) -> tuple[VOState, list]:
    """N frames, detection batched across all 2N images; ``frames`` is (l0, r0, l1, r1, ...).

    Detection is pose-independent, so one batched detect_and_describe covers
    every image; the serial tracking / RANSAC / chaining then runs frame by
    frame. Returns (state, [FrameOutput x N]).
    """
    feats = detect_and_describe(torch.stack([_normalize(f) for f in frames]), cfg.sift)
    outs = []
    for k in range(len(frames) // 2):
        state, out = _step_core(state, _image_features(feats, 2 * k), _image_features(feats, 2 * k + 1), calib, cfg)
        outs.append(out)
    return state, outs


def vo_step(
    state: VOState,
    left: torch.Tensor,
    right: torch.Tensor,
    calib: StereoCalib,
    cfg: PipelineConfig,
    return_feats: bool = False,
):
    """One frame -> (state, FrameOutput).

    ``return_feats`` also returns the FULL left detection set (xy, desc,
    mask): loop-closure verification matches the query keyframe's complete
    detections, not just its stereo subset (slam.loop_closure).
    """
    feats = detect_and_describe(torch.stack([_normalize(left), _normalize(right)]), cfg.sift)
    feats_l = _image_features(feats, 0)
    state, out = _step_core(state, feats_l, _image_features(feats, 1), calib, cfg)
    if return_feats:
        return state, out, (feats_l.xy, feats_l.desc, feats_l.mask)
    return state, out
