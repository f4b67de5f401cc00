"""Global landmark map: a fixed-capacity device store (port of vo_tpu.odometry.landmarks).

Triangulate the frame's new stereo pairs, keep every ``stride``-th
(CreateLandmarksFromFeatures.m:4), gate depth to (min, max]
(lines 9-15), move them to the world frame with the current pose (line 17)
and append (line 20). Only valid points land in the store; capacity overflow
drops the tail and counts it.

``insert`` updates the map IN PLACE (the reference donates the buffer): the
write cursor stays a device tensor, and the C-row window at
``min(count, capacity - C)`` is read, merged and written back with
``index_copy_``, so no value ever travels to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import LandmarkConfig
from ..geom import se3
from ..geom.camera import StereoCalib
from ..geom.triangulate import triangulate_rectified
from ..utils.padding import compact_indices


class LandmarkMap(NamedTuple):
    xyz: torch.Tensor  # [capacity, 3] world-frame points
    count: torch.Tensor  # scalar int64, valid prefix length
    dropped: torch.Tensor  # scalar int64, points lost to capacity overflow


def init_map(cfg: LandmarkConfig, device=None) -> LandmarkMap:
    z = torch.zeros((), dtype=torch.int64, device=device)
    return LandmarkMap(xyz=torch.zeros((cfg.capacity, 3), dtype=torch.float32, device=device), count=z, dropped=z.clone())


def insert(
    lmap: LandmarkMap,
    l_px: torch.Tensor,  # [C, 2] new stereo features, left
    r_px: torch.Tensor,  # [C, 2] right
    mask: torch.Tensor,  # [C]
    pose_c2w: torch.Tensor,  # [4, 4] current world pose
    calib: StereoCalib,
    cfg: LandmarkConfig,
) -> LandmarkMap:
    """Triangulate + gate + world-transform + append, writing into ``lmap``'s tensors."""
    C = l_px.shape[0]
    dev = l_px.device
    rows = torch.arange(C, device=dev)
    X = triangulate_rectified(l_px, r_px, calib)  # camera frame
    keep = (
        mask
        & (rows % cfg.stride == 0)
        & (X[:, 2] > cfg.min_depth)
        & (X[:, 2] <= cfg.max_depth)
        & torch.isfinite(X).all(dim=1)
    )
    Xw = se3.apply(pose_c2w, X)  # world frame (CLF.m:17)
    perm, out_mask = compact_indices(keep)
    Xw_c = torch.where(out_mask[:, None], Xw[perm], 0.0)
    n_new = keep.sum()
    cap = lmap.xyz.shape[0]
    # Clamp the write window inside capacity; the tail beyond capacity is dropped.
    start = torch.clamp(lmap.count, max=cap - C)
    window_idx = start + rows
    window = lmap.xyz.index_select(0, window_idx)
    # Overwrite only slots [count - start, count - start + n_new) of the window.
    local = rows - (lmap.count - start)
    write = (local >= 0) & (local < n_new)
    window = torch.where(write[:, None], Xw_c[local.clamp(0, C - 1)], window)
    lmap.xyz.index_copy_(0, window_idx, window)
    new_count = torch.clamp(lmap.count + n_new, max=cap)
    lmap.dropped.add_(lmap.count + n_new - new_count)
    lmap.count.copy_(new_count)
    return lmap
