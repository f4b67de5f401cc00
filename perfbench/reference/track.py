"""Frozen copy of vo_tpu_torch/frontend/track.py for the benchmark's plain reference: imports repointed to this
folder, kernels replaced by their plain versions, the TF32 flags left to the caller.
The program may change; this copy stays as it was.

Temporal + stereo 4-view consistency tracking (port of vo_tpu.frontend.track).

The reference's ``find_remaining_points`` (VO.m:280-334) as index composition
over fixed-capacity buffers: each of the four match stages yields indices
into the ORIGINAL feature sets plus a mask; the data is gathered once at the end.

  1. cur-L vs old-L             -> old set filtered
  2. cur-R vs old-R'            -> old filtered again
  3. cur-L' vs cur-R'' (stereo) -> current aligned
  4. cur-L''' vs old-L'' re-align -> 1:1 rows
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import MatcherConfig
from .padding import gather_rows
from .match import Matches, match
from .sift import Features


class StereoFeatures(NamedTuple):
    """Row-aligned stereo-matched features carried across frames; ``ids`` are persistent track ids (-1 unassigned)."""

    l_xy: torch.Tensor  # [C, 2]
    r_xy: torch.Tensor  # [C, 2]
    l_desc: torch.Tensor  # [C, 128]
    r_desc: torch.Tensor  # [C, 128]
    mask: torch.Tensor  # [C] bool
    ids: torch.Tensor  # [C] int32


class TrackResult(NamedTuple):
    """1:1 correspondences between current and previous frames after the cascade."""

    cur_l_idx: torch.Tensor  # [C] into the current LEFT feature set
    cur_r_idx: torch.Tensor  # [C] into the current RIGHT feature set
    old_row: torch.Tensor  # [C] row into the previous StereoFeatures
    mask: torch.Tensor  # [C]


def stereo_features(feats_l: Features, feats_r: Features, cfg: MatcherConfig, capacity: int) -> StereoFeatures:
    """The frame's stereo-matched subset (the VO.m:87 + VO.m:141-144 contract)."""
    return stereo_features_with_matches(feats_l, feats_r, cfg, capacity)[0]


def stereo_features_with_matches(
    feats_l: Features, feats_r: Features, cfg: MatcherConfig, capacity: int
) -> tuple[StereoFeatures, Matches]:
    """The frame's stereo-matched subset (VO.m:87 + 141-144) and the raw Matches."""
    m = match(feats_l.desc, feats_l.mask, feats_r.desc, feats_r.mask, cfg, capacity)
    sf = StereoFeatures(
        l_xy=gather_rows(feats_l.xy, m.a_idx, m.mask),
        r_xy=gather_rows(feats_r.xy, m.b_idx, m.mask),
        l_desc=gather_rows(feats_l.desc, m.a_idx, m.mask),
        r_desc=gather_rows(feats_r.desc, m.b_idx, m.mask),
        mask=m.mask,
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=m.mask.device),
    )
    return sf, m


def track(old: StereoFeatures, cur_l: Features, cur_r: Features, cfg: MatcherConfig, capacity: int) -> TrackResult:
    """The 4-stage cascade. ``old`` is row-aligned; outputs index the inputs."""
    # Stage 1: current-left vs old-left. Rows of m1 define the "old'" ordering.
    m1 = match(cur_l.desc, cur_l.mask, old.l_desc, old.mask, cfg, capacity)
    a1, b1, k1 = m1.a_idx, m1.b_idx, m1.mask  # a1: cur-L idx, b1: old row

    # Stage 2: current-right vs old'-right.
    m2 = match(cur_r.desc, cur_r.mask, gather_rows(old.r_desc, b1, k1), k1, cfg, capacity)
    a2 = m2.a_idx  # cur-R idx
    b2 = b1[m2.b_idx]  # composed old row
    k2 = m2.mask

    # Stage 3: stereo match of cur-L' (m1 rows) vs cur-R'' (m2 rows).
    m3 = match(gather_rows(cur_l.desc, a1, k1), k1, gather_rows(cur_r.desc, a2, k2), k2, cfg, capacity)
    l3 = a1[m3.a_idx]  # cur-L orig idx, m3 rows
    r3 = a2[m3.b_idx]  # cur-R orig idx
    k3 = m3.mask

    # Stage 4: re-align cur-L''' against old''-left for 1:1 rows.
    m4 = match(gather_rows(cur_l.desc, l3, k3), k3, gather_rows(old.l_desc, b2, k2), k2, cfg, capacity)
    final_mask = m4.mask
    zero = torch.zeros_like(m4.a_idx)
    return TrackResult(
        cur_l_idx=torch.where(final_mask, l3[m4.a_idx], zero),
        cur_r_idx=torch.where(final_mask, r3[m4.a_idx], zero),
        old_row=torch.where(final_mask, b2[m4.b_idx], zero),
        mask=final_mask,
    )
