"""Closed-form rectified-stereo triangulation (port of vo_tpu.geom.triangulate)."""
from __future__ import annotations

import math

import torch

from .camera import StereoCalib


def triangulate_rectified(px_l: torch.Tensor, px_r: torch.Tensor, calib: StereoCalib) -> torch.Tensor:
    """z = f*B/disparity; returns [..., 3] in the LEFT camera frame.

    Non-positive disparities give z = 0 (f*B/inf); callers gate on depth
    (the reference gates 0 < z <= 80, CreateLandmarksFromFeatures.m:9-15).
    """
    disparity = px_l[..., 0] - px_r[..., 0]
    z = calib.fu * calib.baseline / torch.where(disparity <= 0, math.inf, disparity)
    x = (px_l[..., 0] - calib.cu) / calib.fu * z
    y = (px_l[..., 1] - calib.cv) / calib.fv * z
    return torch.stack([x, y, z], dim=-1)
