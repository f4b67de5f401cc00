"""SE(3) rigid-transform algebra on tensors (port of vo_tpu.geom.se3).

4x4 homogeneous matrices ``T = [[R, t], [0, 1]]`` mapping local points to
parent points, ``x_parent = R @ x_local + t``. All functions broadcast over
leading batch dimensions. Every product here is at most 4x4 and runs in full
float32 (the runner turns TF32 off).
"""
from __future__ import annotations

import torch


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
