"""Frozen copy of vo_tpu_torch/geom/se3.py for the benchmark's plain reference: imports repointed to this
folder, kernels replaced by their plain versions, the TF32 flags left to the caller.
The program may change; this copy stays as it was.

SE(3) rigid-transform algebra on tensors (port of vo_tpu.geom.se3).

4x4 homogeneous matrices ``T = [[R, t], [0, 1]]`` mapping local points to
parent points, ``x_parent = R @ x_local + t``. All functions broadcast over
leading batch dimensions. Every product here is at most 4x4 and runs in full
float32 (the runner turns TF32 off).
"""
from __future__ import annotations

import math

import torch

from .device import resolve


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """The 4x4 identity on ``device`` (None: the current CUDA device)."""
    return torch.eye(4, dtype=dtype, device=resolve(device))


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build [..., 4, 4] transform from [..., 3, 3] rotation and [..., 3] translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=top.dtype, device=top.device)
    # A [..., 1] slice is filled on the device; the 0-dim slice [..., 0, 3] of an
    # unbatched transform would be a copy from the host, which waits for the stream.
    bottom[..., 3:] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A then-apply B in A's frame: returns A @ B (VO.m:130 pose.A * rel_pose.A)."""
    return torch.matmul(A, B)


def inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse (orthonormal R; no linear solve)."""
    Rt = rotation(T).transpose(-1, -2)
    return from_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, translation(T)))


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform [..., N, 3] points by [..., 4, 4] (x_out = R x + t)."""
    return torch.einsum("...ij,...nj->...ni", rotation(T), pts) + translation(T)[..., None, :]


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation. Safe at theta=0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * torch.matmul(W, W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: [..., 3, 3] -> [..., 3]. Safe near theta=0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    # Antisymmetric part -> axis * 2 sin(theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    # atan2 form: differentiable at theta=0 (arccos' blows up there, which
    # poisons the forward-mode Jacobians of the pose-graph residuals with NaNs).
    sin_theta = 0.5 * torch.sqrt(torch.sum(v * v, dim=-1) + 1e-32)
    theta = torch.atan2(sin_theta, cos_theta)
    small = theta < 1e-4
    # Near pi the antisymmetric part vanishes; use the diagonal formula.
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_theta + 1e-32))
    w_generic = v * scale[..., None]
    # theta ~ pi branch: axis from the diagonal of (R + I)/2
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) / 2.0, 0.0, 1.0))
    # Fix signs using off-diagonal terms (largest-axis heuristic).
    sx = torch.sign(torch.where(v[..., 0] == 0, 1.0, v[..., 0]))
    sy = torch.sign(R[..., 0, 1]) * sx
    sz = torch.sign(R[..., 0, 2]) * sx
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-32)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential. xi = [..., 6] = (v, w) with translation part v first."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-8
    R = exp_so3(w)
    W = hat(w)
    W2 = torch.matmul(W, W)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))
    V = _eye3(W) + b[..., None, None] * W + c[..., None, None] * W2
    return from_rt(R, torch.einsum("...ij,...j->...i", V, v))


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm -> [..., 6] = (v, w)."""
    w = log_so3(rotation(T))
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-8
    W = hat(w)
    W2 = torch.matmul(W, W)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - theta sin/(2(1-cos))) W^2
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - theta * torch.sin(theta) / (2.0 * (1.0 - torch.cos(theta)) + 1e-32)) / (theta2 + 1e-32),
    )
    Vinv = _eye3(W) - 0.5 * W + coef[..., None, None] * W2
    v = torch.einsum("...ij,...j->...i", Vinv, translation(T))
    return torch.cat([v, w], dim=-1)


def _det_signs(det: torch.Tensor) -> torch.Tensor:
    """[..., 3] diagonal (1, 1, det): flips the last singular direction of a reflection."""
    return torch.cat([torch.ones(det.shape + (2,), dtype=det.dtype, device=det.device), det[..., None]], dim=-1)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] onto SO(3) via SVD (det +1 enforced)."""
    U, _, Vt = torch.linalg.svd(R)
    S = _det_signs(torch.linalg.det(torch.matmul(U, Vt)))
    return torch.einsum("...ik,...k,...kj->...ij", U, S, Vt)


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None):
    """Weighted rigid alignment: returns (R, t) with dst ~ R @ src + t.

    src, dst: [..., N, 3]; weights: [..., N] nonneg.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wn = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-32)
    mu_s = torch.einsum("...n,...ni->...i", wn, src)
    mu_d = torch.einsum("...n,...ni->...i", wn, dst)
    s = src - mu_s[..., None, :]
    d = dst - mu_d[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", wn, s, d)
    U, _, Vt = torch.linalg.svd(H)
    S = _det_signs(torch.linalg.det(torch.matmul(Vt.transpose(-1, -2), U.transpose(-1, -2))))
    R = torch.einsum("...ji,...j,...kj->...ik", Vt, S, U)  # V diag(S) U^T
    t = mu_d - torch.einsum("...ij,...j->...i", R, mu_s)
    return R, t
