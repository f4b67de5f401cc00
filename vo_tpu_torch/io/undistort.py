"""Lens undistortion stage (port of vo_tpu.io.undistort).

Replaces ``undistortImage`` (VO.m:75-76). On KITTI odometry it is an exact
no-op (the images are pre-rectified and the intrinsics carry no distortion
coefficients) and the remap is skipped entirely. For raw (unrectified) feeds
the plumb-bob model (radial k1, k2, k3 + tangential p1, p2) is an inverse-map
bilinear warp whose table is computed once per calibration on the host
(numpy, the reference's code) and kept on the device.

The warp keeps the reference's gather arithmetic (floor, clip to W-2 / H-2,
four takes, zero outside) rather than ``grid_sample``, whose pixel-centre and
border rules differ.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geom.camera import StereoCalib
from ..utils.device import resolve
from ..utils.host_copy import upload


class DistortionModel(NamedTuple):
    """Plumb-bob coefficients. All-zeros == identity (the KITTI case)."""

    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def is_identity(self) -> bool:
        return all(abs(c) < 1e-12 for c in self)


def distort_normalized(xn: np.ndarray, yn: np.ndarray, d: DistortionModel):
    """Apply the forward distortion model to normalized coords (numpy, host)."""
    r2 = xn * xn + yn * yn
    radial = 1.0 + d.k1 * r2 + d.k2 * r2 * r2 + d.k3 * r2 * r2 * r2
    xd = xn * radial + 2.0 * d.p1 * xn * yn + d.p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + d.p1 * (r2 + 2.0 * yn * yn) + 2.0 * d.p2 * xn * yn
    return xd, yd


def build_remap(calib: StereoCalib, d: DistortionModel) -> np.ndarray:
    """[H, W, 2] source-pixel map: for each undistorted pixel, where to sample.

    Computed once per calibration on the host (the classic inverse-map table);
    the per-frame work is only the bilinear gather in ``undistort_image``.
    """
    H, W = calib.image_size
    fu, fv = float(calib.fu), float(calib.fv)
    cu, cv = float(calib.cu), float(calib.cv)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    xn = (u - cu) / fu
    yn = (v - cv) / fv
    xd, yd = distort_normalized(xn, yn, d)
    src_u = xd * fu + cu
    src_v = yd * fv + cv
    return np.stack([src_v, src_u], axis=-1).astype(np.float32)  # (y, x) order


def undistort_image(img: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of a float [H, W] image by a [H, W, 2] (y, x) source map on the image's device."""
    H, W = img.shape
    ys = remap[..., 0]
    xs = remap[..., 1]
    x0 = torch.floor(xs).clamp(0, W - 2)
    y0 = torch.floor(ys).clamp(0, H - 2)
    fx = (xs - x0).clamp(0.0, 1.0)
    fy = (ys - y0).clamp(0.0, 1.0)
    flat = img.reshape(-1)
    base = (y0.long() * W + x0.long()).reshape(-1)

    def take(idx):
        return flat[idx.clamp(0, H * W - 1)].reshape(H, W)

    v00, v10, v01, v11 = take(base), take(base + 1), take(base + W), take(base + W + 1)
    out = v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy) + v01 * (1 - fx) * fy + v11 * fx * fy
    # Out-of-bounds source pixels -> 0 (undistortImage FillValues default).
    inb = (xs >= 0) & (xs <= W - 1) & (ys >= 0) & (ys <= H - 1)
    return torch.where(inb, out, 0.0)


class Undistorter:
    """Per-camera undistortion with identity fast path (the KITTI case); the remap table lives
    on ``device`` (None: the current CUDA device), where the images must be too."""

    def __init__(self, calib: StereoCalib, model: DistortionModel | None = None, device=None):
        self.device = resolve(device)
        self.model = model or DistortionModel()
        self.identity = self.model.is_identity
        self._remap = None if self.identity else upload(torch.from_numpy(build_remap(calib, self.model)), self.device)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return img
        return undistort_image(img, self._remap)
