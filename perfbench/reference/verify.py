"""The plain reference of one loop-verification round, worked out from the keyframes' frames.

A round verifies the query keyframe against each candidate keyframe (``LoopConfig``): the query's
whole left detection set is matched against the candidate's stereo-matched set with the
verification matcher (the step's matcher with ``verify_ratio`` and ``verify_mutual``, at most
``match_capacity`` pairs), the candidate's stereo pairs are triangulated, matches whose point lies
outside 0.5-150 m of depth are left out, and RANSAC-P3P with its consensus refinement estimates the
query camera's pose in the candidate's frame. A candidate is verified where the depth-gated matches
and the inliers both reach ``min_inliers`` and RANSAC succeeded.

The round is a fixed batch of ``candidate_budget`` candidates, the list padded with its first
candidate, and every one of them draws its hypotheses from one generator, in order, from the state
the program recorded before the round. RANSAC is the loop closer's: 256 hypotheses, the other
``RansacConfig`` fields at their defaults (the program builds its closer so).

Features are rebuilt from the keyframe's stereo pair with the frame reference (frame.py): on the
refined path the program detects one pair a call. Geometry runs in float32 with TF32 off, as the
program's does, so that the discrete outputs (inlier counts and verdicts) are comparable; the
solvers of the refiner are in float64 (window_ba.py, pose_graph.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import frame as ref
from .config import PipelineConfig, RansacConfig
from .match import match
from .padding import take
from .ransac import estimate_world_pose
from .track import stereo_features_with_matches
from .triangulate import triangulate_rectified

RANSAC = RansacConfig(n_hypotheses=256)
DEPTH = (0.5, 150.0)  # metres: the verification's depth gate on the candidate's points


class Keyframe(NamedTuple):
    xy: torch.Tensor  # [N, 2] the whole left detection set (the query side)
    desc: torch.Tensor  # [N, 128]
    mask: torch.Tensor  # [N]
    l_xy: torch.Tensor  # [C, 2] the stereo-matched set (the candidate side)
    r_xy: torch.Tensor  # [C, 2]
    l_desc: torch.Tensor  # [C, 128]
    s_mask: torch.Tensor  # [C]


class Verified(NamedTuple):
    ok: bool
    n_inliers: int
    n_matches: int
    verdict: bool


def keyframe(left: torch.Tensor, right: torch.Tensor, cfg: PipelineConfig) -> Keyframe:
    """A keyframe's two feature sets from its uint8 stereo pair (one detection call of two images)."""
    feats = ref.detect(torch.stack([left, right]), cfg)
    fl, fr = ref.image(feats, 0), ref.image(feats, 1)
    st, _ = stereo_features_with_matches(fl, fr, cfg.matcher, cfg.max_tracks)
    return Keyframe(fl.xy, fl.desc, fl.mask, st.l_xy, st.r_xy, st.l_desc, st.mask)


def round_(query: Keyframe, candidates: list, calib, cfg: PipelineConfig, gen_state: np.ndarray, device) -> list:
    """[Verified] for each of ``candidates`` (Keyframes), the round drawn from ``gen_state``."""
    lc = cfg.loop
    matcher = dataclasses.replace(cfg.matcher, max_ratio=lc.verify_ratio, mutual=lc.verify_mutual)
    gen = torch.Generator(device=device)
    gen.set_state(torch.as_tensor(np.asarray(gen_state, np.uint8)))
    padded = list(candidates) + [candidates[0]] * (lc.candidate_budget - len(candidates))
    out = []
    for c in padded:
        m = match(query.desc, query.mask, c.l_desc, c.s_mask, matcher, lc.match_capacity)
        X = take(triangulate_rectified(c.l_xy, c.r_xy, calib), m.b_idx)
        px = take(query.xy, m.a_idx)
        msk = m.mask & (X[:, 2] > DEPTH[0]) & (X[:, 2] < DEPTH[1])
        est = estimate_world_pose(px, X, msk, calib, RANSAC, gen=gen)
        ok, n_in, n_m = bool(est.ok), int(est.n_inliers), int(msk.sum())
        out.append(Verified(ok, n_in, n_m, n_m >= lc.min_inliers and ok and n_in >= lc.min_inliers))
    return out[: len(candidates)]
