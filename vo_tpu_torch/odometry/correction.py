"""Trajectory correction propagation: re-anchor non-keyframe poses (port of vo_tpu.odometry.correction).

When window BA or a loop closure refines KEYFRAME poses, every frame between
keyframes is moved RIGIDLY with its preceding keyframe:

    P'_i = T_k_fixed @ inv(P_k_asrun) @ P_i       for  k = last keyframe <= i

and relative poses are rebuilt from the corrected absolute trajectory.

The module is jax-free numpy, but it is copied verbatim rather than
re-exported: importing it from the reference runs ``vo_tpu.odometry``'s
package ``__init__``, which imports the jax pipeline and runner.
"""
from __future__ import annotations

import numpy as np


def reanchor_trajectory(
    poses: np.ndarray,
    kf_positions: np.ndarray,
    kf_poses: np.ndarray,
) -> np.ndarray:
    """Rigidly re-anchor each inter-keyframe segment onto corrected keyframes.

    Args:
      poses: [T, 4, 4] as-run world poses (row t = pose after frame t+1, the
        ``all_poses`` convention of VO.m:133).
      kf_positions: [K] int row indices into ``poses`` that are keyframes,
        strictly increasing.
      kf_poses: [K, 4, 4] corrected world poses for those rows.

    Returns:
      [T, 4, 4] corrected poses. Rows before the first keyframe are
      unchanged; row kf_positions[j] becomes exactly kf_poses[j].
    """
    poses = np.asarray(poses, np.float64)
    T = poses.shape[0]
    out = poses.copy()
    kf_positions = np.asarray(kf_positions, np.int64)
    if kf_positions.size == 0 or T == 0:
        return out.astype(np.float32)
    order = np.argsort(kf_positions)
    kf_positions = kf_positions[order]
    kf_poses = np.asarray(kf_poses, np.float64)[order]

    # Per-keyframe rigid delta D_k = T_fixed @ inv(P_asrun).
    deltas = np.einsum("kij,kjl->kil", kf_poses, np.linalg.inv(poses[kf_positions]))
    # Segment id for every row: index of the last keyframe at-or-before it
    # (-1 before the first keyframe -> identity delta).
    seg = np.searchsorted(kf_positions, np.arange(T), side="right") - 1
    D = np.concatenate([np.eye(4)[None], deltas], axis=0)[seg + 1]
    return np.einsum("tij,tjl->til", D, poses).astype(np.float32)


def rebuild_rel_poses(poses: np.ndarray) -> np.ndarray:
    """rel[t] = inv(P[t-1]) @ P[t]; rel[0] = P[0] (previous pose = identity,
    the VO.m:58 start state). Keeps ``poses[t] == poses[t-1] @ rel[t]`` exact."""
    poses = np.asarray(poses, np.float64)
    if poses.shape[0] == 0:
        return poses.astype(np.float32)
    rels = np.empty_like(poses)
    rels[0] = poses[0]
    rels[1:] = np.einsum("tij,tjl->til", np.linalg.inv(poses[:-1]), poses[1:])
    return rels.astype(np.float32)
