"""Pinhole / rectified-stereo camera model (port of vo_tpu.geom.camera).

The projection matrices are float32 tensors; the scalar intrinsics are Python
floats (the float32 values the reference derives), so the per-frame math
multiplies by constants instead of reading device scalars.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve


class StereoCalib(NamedTuple):
    """Rectified stereo calibration derived from two 3x4 projection matrices."""

    P1: torch.Tensor  # [3, 4] left projection, float32
    P2: torch.Tensor  # [3, 4] right projection, float32
    fu: float
    fv: float
    cu: float
    cv: float
    baseline: float  # meters
    image_size: tuple  # (height, width)

    def to(self, device) -> "StereoCalib":
        return self._replace(P1=self.P1.to(device), P2=self.P2.to(device))


def calib_from_projections(P1, P2, image_size=(376, 1241), device=None) -> StereoCalib:
    """Derive scalar intrinsics + baseline like VO.m:35-48, in float32; the projection
    matrices go to ``device`` (None: the current CUDA device)."""
    device = resolve(device)
    p1 = torch.tensor(np.asarray(P1, dtype=np.float32))
    p2 = torch.tensor(np.asarray(P2, dtype=np.float32))
    P1 = p1.to(device)
    P2 = p2.to(device)
    fu1 = p1[0, 0]
    bx1 = -p1[0, 3] / fu1
    bx2 = -p2[0, 3] / p2[0, 0]
    return StereoCalib(
        P1=P1,
        P2=P2,
        fu=float(fu1),
        fv=float(p1[1, 1]),
        cu=float(p1[0, 2]),
        cv=float(p1[1, 2]),
        baseline=float(bx2 - bx1),
        image_size=tuple(int(s) for s in image_size),
    )


def scale_calib(calib: StereoCalib, image_size) -> StereoCalib:
    """Rescale a calibration to a new (H, W) image size (the metric baseline is invariant)."""
    H0, W0 = calib.image_size
    H1, W1 = (int(s) for s in image_size)
    sy, sx = H1 / H0, W1 / W0
    S = torch.tensor([[sx, 0.0, 0.0], [0.0, sy, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    P1 = S @ calib.P1.cpu()
    P2 = S @ calib.P2.cpu()
    return calib_from_projections(P1.numpy(), P2.numpy(), image_size=(H1, W1), device=calib.P1.device)
