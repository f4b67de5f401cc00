"""Distributed sliding-window BA: landmark blocks sharded over the mesh (port of vo_tpu.dist.ba_sharded).

Keyframe poses are REPLICATED; the landmark axis M, and the [K, M] observation
grids with it, is SHARDED over the "model" axis. ``ba.window`` reduces every
cross-landmark contraction (U, g_p, the Schur correction and its right-hand
side, the costs) over a process group when given one, so the distributed
solver is ``solve_window`` on this rank's slice: the camera system's assembly
crosses the ranks, the landmark back-substitution stays local.
"""
from __future__ import annotations

import torch

from ..ba.window import BAProblem, BAResult, solve_window
from ..config import BAConfig
from ..geom.camera import StereoCalib
from ..utils.precision import matmul_precision
from .mesh import all_gather, axis_size, shard_rows


@matmul_precision("float32")
def solve_window_sharded(
    prob: BAProblem,
    calib: StereoCalib,
    cfg: BAConfig,
    mesh,
    axis: str = "model",
) -> BAResult:
    """Same contract as ba.window.solve_window; the landmark capacity M must divide by the axis size.

    ``prob`` is the full, replicated problem; the result carries the full ``X``
    (the shards all-gathered), so it has the single-device shapes.
    """
    M = prob.X.shape[0]
    n = axis_size(mesh, axis)
    if M % n != 0:
        raise ValueError(f"landmark capacity {M} not divisible by {n} shards")
    group = mesh.get_group(axis)
    rows = shard_rows(M, mesh, axis)
    local = BAProblem(
        T_c2w=prob.T_c2w,  # replicated poses
        X=prob.X[rows],  # sharded landmarks
        obs_uv=prob.obs_uv[:, rows],  # [K, M, 2] sharded on M
        obs_mask=prob.obs_mask[:, rows],
        obs_ur=prob.obs_ur[:, rows],
        obs_ur_mask=prob.obs_ur_mask[:, rows],
        X_mask=prob.X_mask[rows],
        kf_mask=prob.kf_mask,
    )
    res = solve_window(local, calib, cfg, group=group)
    return res._replace(X=all_gather(res.X, group).reshape(M, 3))
