"""Hypothesis-parallel RANSAC over a device mesh (port of vo_tpu.dist.ransac_sharded).

Correspondences are REPLICATED across the mesh's "model" axis, the hypothesis
batch is SHARDED, the winners are reduced with ONE all-gather + argmin, and
the refinement of the single winner is replicated (cheap, and it keeps every
rank's copy of the pose bit-identical).

Sampling differs from the reference on purpose. There each shard folds its
index into the PRNG key and owns a stream; a ``torch.Generator`` per rank
would make ``VOState.gen`` differ between ranks, and a checkpoint (written by
one rank) could not resume the others. Here every rank draws the FULL
``[S * per_shard, 3]`` triples from the replicated generator (a small
``rand`` + ``topk`` beside P3P and scoring) and takes its own rows. The
generator stays replicated, and where S divides ``cfg.n_hypotheses`` the
sharded estimate equals the single-device one exactly, first-minimum ties
included.
"""
from __future__ import annotations

import math

import torch

from ..config import RansacConfig
from ..geom.camera import StereoCalib
from ..pose.ransac import PoseEstimate, _sample_triples, best_hypothesis, finalize_pose
from ..utils.padding import take
from ..utils.precision import matmul_precision
from .mesh import all_gather_packed, axis_size


@matmul_precision("float32")
def estimate_world_pose_sharded(
    px2d: torch.Tensor,
    pts3d: torch.Tensor,
    mask: torch.Tensor,
    calib: StereoCalib,
    cfg: RansacConfig,
    gen: torch.Generator | None,
    mesh,
    axis: str = "model",
    triples: torch.Tensor | None = None,
) -> PoseEstimate:
    """Same contract as pose.ransac.estimate_world_pose, hypothesis-sharded over ``axis``.

    ``triples`` [S * per_shard, 3], where given, replace the draw from ``gen``
    (they must be the same on every rank).
    """
    S = axis_size(mesh, axis)
    per_shard = max(1, cfg.n_hypotheses // S)
    if triples is None:
        triples = _sample_triples(gen, mask, S * per_shard)
    s = mesh.get_local_rank(axis)
    R, t, score, any_valid = best_hypothesis(px2d, pts3d, mask, calib, cfg, triples[s * per_shard : (s + 1) * per_shard])
    # Reduce winners across the axis: gather each shard's champion.
    Rs, ts, scores, valids = all_gather_packed([R, t, score, any_valid], mesh.get_group(axis))
    best = torch.argmin(torch.where(valids, scores, math.inf)).reshape(1)  # first minimum: lowest shard wins a tie
    return finalize_pose(take(Rs, best)[0], take(ts, best)[0], valids.any(), px2d, pts3d, mask, calib, cfg)
