"""Frozen copy of vo_tpu_torch/geom/triangulate.py for the benchmark's plain reference: imports repointed to this
folder, kernels replaced by their plain versions, the TF32 flags left to the caller.
The program may change; this copy stays as it was.

Batched two-view triangulation (port of vo_tpu.geom.triangulate): the general
two-projection DLT and the closed-form disparity inversion for a rectified pair."""
from __future__ import annotations

import math

import torch

from .camera import StereoCalib


def _dlt_rows(P: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per point: [N, 2, 4]. px: [N, 2], P: [3, 4]."""
    u = px[..., 0:1]
    v = px[..., 1:2]
    return torch.stack([u * P[2] - P[0], v * P[2] - P[1]], dim=-2)


def _normalizer(P: torch.Tensor) -> torch.Tensor:
    """Conditioning transform N ~ K^-1 (zero skew), so that the DLT rows are O(1) in float32."""
    fu, fv = P[0, 0], P[1, 1]
    cu, cv = P[0, 2], P[1, 2]
    z = torch.zeros_like(fu)
    o = torch.ones_like(fu)
    return torch.stack(
        [
            torch.stack([1.0 / fu, z, -cu / fu]),
            torch.stack([z, 1.0 / fv, -cv / fv]),
            torch.stack([z, z, o]),
        ]
    )


def triangulate_dlt(px1: torch.Tensor, px2: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """Triangulate [N, 2] pixel pairs through [3, 4] P1/P2 -> [N, 3].

    Intrinsic-normalized DLT: pixels and projections are premultiplied by
    ~K^-1, then the inhomogeneous 3-unknown least-squares system of every
    point is solved in one batched 3x3 solve (no status read: a degenerate
    point gives non-finite output).
    """
    rows = []
    for P, px in ((P1, px1), (P2, px2)):
        N = _normalizer(P)
        ph = torch.cat([px, torch.ones_like(px[..., :1])], dim=-1)
        pn = torch.einsum("ij,...j->...i", N, ph)
        rows.append(_dlt_rows(N @ P, pn[..., :2] / pn[..., 2:3]))
    A = torch.cat(rows, dim=-2)  # [N, 4, 4]
    M = A[..., :3]
    b = -A[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", M, M)
    Atb = torch.einsum("...ki,...k->...i", M, b)
    eye = torch.eye(3, dtype=AtA.dtype, device=AtA.device) * 1e-10
    return torch.linalg.solve_ex(AtA + eye, Atb[..., None], check_errors=False)[0][..., 0]


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
