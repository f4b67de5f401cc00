"""Frozen copy of vo_tpu_torch/geom/camera.py for the benchmark's plain reference: imports repointed to this
folder, kernels replaced by their plain versions, the TF32 flags left to the caller.
The program may change; this copy stays as it was.

Pinhole / rectified-stereo camera model (port of vo_tpu.geom.camera).

The projection matrices are float32 tensors; the scalar intrinsics are Python
floats (the float32 values the reference derives), so the per-frame math
multiplies by constants instead of reading device scalars.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve


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

    @property
    def K(self) -> torch.Tensor:
        """[3, 3] left intrinsics, with the projection matrices' dtype and device."""
        return torch.tensor(
            [[self.fu, 0.0, self.cu], [0.0, self.fv, self.cv], [0.0, 0.0, 1.0]],
            dtype=self.P1.dtype,
            device=self.P1.device,
        )

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


def project(P: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """Project [..., N, 3] camera-frame points through a [3, 4] matrix -> [..., N, 2] px."""
    Xh = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)
    uvw = torch.einsum("ij,...nj->...ni", P, Xh)
    return uvw[..., :2] / (uvw[..., 2:3] + 1e-32)


def project_pinhole(calib: StereoCalib, pts_cam: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points with the left intrinsics only (no baseline)."""
    z = pts_cam[..., 2:3]
    u = calib.fu * pts_cam[..., 0:1] / (z + 1e-32) + calib.cu
    v = calib.fv * pts_cam[..., 1:2] / (z + 1e-32) + calib.cv
    return torch.cat([u, v], dim=-1)


def unproject_pinhole(calib: StereoCalib, px: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Lift [..., N, 2] pixels at [..., N] depth to camera-frame 3D."""
    x = (px[..., 0] - calib.cu) / calib.fu * depth
    y = (px[..., 1] - calib.cv) / calib.fv * depth
    return torch.stack([x, y, depth], dim=-1)


def bearings(calib: StereoCalib, px: torch.Tensor) -> torch.Tensor:
    """Unit bearing vectors for [..., N, 2] pixels (left camera)."""
    x = (px[..., 0] - calib.cu) / calib.fu
    y = (px[..., 1] - calib.cv) / calib.fv
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
