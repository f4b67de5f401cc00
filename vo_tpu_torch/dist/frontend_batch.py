"""Frame-parallel front-end: detect/describe/match over a sharded frame batch (port of vo_tpu.dist.frontend_batch).

The front-end is embarrassingly parallel across frames, so a [B, H, W] batch
is sharded on the mesh's "data" axis: a rank detects its B / n images (the
hand-written kernels launch here, on the rank's share) with no collective
inside detection, and ONE all-gather afterwards gives every rank the whole
batch's features.
"""
from __future__ import annotations

import torch

from ..config import MatcherConfig, SIFTConfig
from ..frontend.sift import Features, detect_and_describe
from ..frontend.track import StereoFeatures, stereo_features
from .mesh import all_gather_packed, axis_size, shard_rows


def _gather_batch(local, mesh, axis: str):
    """All-gather a NamedTuple of [b, ...] tensors over ``axis`` into [n * b, ...]."""
    stacks = all_gather_packed(list(local), mesh.get_group(axis))
    return type(local)(*(s.reshape((-1,) + tuple(s.shape[2:])) for s in stacks))


def _rows(B: int, mesh, axis: str) -> slice:
    n = axis_size(mesh, axis)
    if B % n != 0:
        raise ValueError(f"frame batch {B} not divisible by {n} shards")
    return shard_rows(B, mesh, axis)


def detect_batch(imgs: torch.Tensor, cfg: SIFTConfig, mesh, axis: str = "data") -> Features:
    """[B, H, W] frame batch -> batched Features [B, K, ...], detection sharded on ``axis``."""
    rows = _rows(imgs.shape[0], mesh, axis)
    return _gather_batch(detect_and_describe(imgs[rows], cfg), mesh, axis)


def stereo_batch(
    left: torch.Tensor,
    right: torch.Tensor,
    sift_cfg: SIFTConfig,
    match_cfg: MatcherConfig,
    capacity: int,
    mesh,
    axis: str = "data",
) -> StereoFeatures:
    """Batched detect + stereo-match (VO.m:79-87 over B frames at once), sharded on ``axis``."""
    rows = _rows(left.shape[0], mesh, axis)
    b = rows.stop - rows.start
    feats = detect_and_describe(torch.cat([left[rows], right[rows]]), sift_cfg)
    pairs = [
        stereo_features(Features(*(f[i] for f in feats)), Features(*(f[b + i] for f in feats)), match_cfg, capacity)
        for i in range(b)
    ]
    local = StereoFeatures(*(torch.stack(cols) for cols in zip(*pairs)))
    return _gather_batch(local, mesh, axis)
