"""Frozen copy of vo_tpu_torch/pose/p3p.py for the benchmark's plain reference: imports repointed to this
folder, kernels replaced by their plain versions, the TF32 flags left to the caller.
The program may change; this copy stays as it was.

Batched P3P minimal solver (Grunert's quartic) + quartic root finder (port of vo_tpu.pose.p3p).

Roots come from Ferrari's closed form in float32 with a fixed number of Newton
polish steps and a validity mask per root; the pose of each root is the exact
orthonormal-triad alignment of the world triangle onto the recovered
camera-frame triangle. Everything broadcasts over the hypothesis axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_quartic(c4, c3, c2, c1, c0, polish_iters: int = 8):
    """Real roots of c4 x^4 + ... + c0 (batched) -> (roots [..., 4], valid [..., 4]).

    Ferrari resolvent-cubic factorization + Newton polish. Complex root pairs
    are masked invalid; a leading coefficient ~0 masks everything.
    """
    eps = 1e-12
    lead_ok = torch.abs(c4) > 1e-10
    c4s = torch.where(lead_ok, c4, 1.0)
    b, c, d, e = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    # Depressed quartic y^4 + p y^2 + q y + r with x = y - b/4.
    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0
    # Resolvent cubic z^3 - p z^2 - 4 r z + (4 p r - q^2); its largest real root.
    a2 = -p
    a1 = -4.0 * r
    a0 = 4.0 * p * r - q * q
    P = a1 - a2 * a2 / 3.0
    Q = 2.0 * a2**3 / 27.0 - a2 * a1 / 3.0 + a0
    disc = (Q / 2.0) ** 2 + (P / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_card = _cbrt(-Q / 2.0 + sq) + _cbrt(-Q / 2.0 - sq)
    m = torch.sqrt(torch.clamp(-P / 3.0, min=eps))
    acos_arg = torch.clamp(3.0 * Q / (2.0 * P * m + torch.where(torch.abs(P) < eps, eps, 0.0)), -1.0, 1.0)
    theta = torch.arccos(acos_arg) / 3.0
    t_trig = 2.0 * m * torch.cos(theta)  # largest of the three
    t0 = torch.where(disc > 0, t_card, t_trig)
    z0 = t0 - a2 / 3.0
    # Two quadratics y^2 +- s y + (z0/2 -+ q/(2 s)), s = sqrt(z0 - p).
    s2_ = z0 - p
    s_ok = s2_ > eps
    s = torch.sqrt(torch.clamp(s2_, min=eps))
    t1 = z0 / 2.0 - q / (2.0 * s)
    t2 = z0 / 2.0 + q / (2.0 * s)
    d1 = s * s - 4.0 * t1
    d2 = s * s - 4.0 * t2
    rt1 = torch.sqrt(torch.clamp(d1, min=0.0))
    rt2 = torch.sqrt(torch.clamp(d2, min=0.0))
    y_roots = torch.stack([(-s + rt1) / 2.0, (-s - rt1) / 2.0, (s + rt2) / 2.0, (s - rt2) / 2.0], dim=-1)
    valid = torch.stack([d1 >= 0, d1 >= 0, d2 >= 0, d2 >= 0], dim=-1)
    # Biquadratic fallback when s ~ 0: y^2 = (-p +- sqrt(p^2 - 4r)) / 2.
    bq_disc = p * p - 4.0 * r
    bq_sq = torch.sqrt(torch.clamp(bq_disc, min=0.0))
    y1 = torch.sqrt(torch.clamp((-p + bq_sq) / 2.0, min=0.0))
    y2 = torch.sqrt(torch.clamp((-p - bq_sq) / 2.0, min=0.0))
    bq_roots = torch.stack([y1, -y1, y2, -y2], dim=-1)
    y1sq_ok = (-p + bq_sq) / 2.0 >= 0
    y2sq_ok = (-p - bq_sq) / 2.0 >= 0
    bq_valid = torch.stack([y1sq_ok, y1sq_ok, y2sq_ok, y2sq_ok], dim=-1) & (bq_disc >= 0)[..., None]
    use_bq = ~s_ok
    y_roots = torch.where(use_bq[..., None], bq_roots, y_roots)
    valid = torch.where(use_bq[..., None], bq_valid, valid)
    roots = y_roots - (b / 4.0)[..., None]
    valid &= lead_ok[..., None]

    # Newton polish on the ORIGINAL quartic (recovers f32 accuracy).
    C4, C3, C2, C1, C0 = (t[..., None] for t in (c4, c3, c2, c1, c0))

    def poly(x):
        return (((C4 * x + C3) * x + C2) * x + C1) * x + C0

    for _ in range(polish_iters):
        f = poly(roots)
        df = ((4.0 * C4 * roots + 3.0 * C3) * roots + 2.0 * C2) * roots + C1
        roots = roots - f / torch.where(torch.abs(df) < eps, torch.where(df < 0, -eps, eps), df)
    # Reject roots that did not converge to the polynomial.
    scale = 1.0 + torch.abs(C0) + torch.abs(C4)
    valid &= torch.abs(poly(roots)) < 1e-3 * scale
    return roots, valid


def _align_triads(src: torch.Tensor, dst: torch.Tensor):
    """Exact rigid alignment of 3 corresponding points, dst = R @ src + t, for [..., 3, 3] (points, xyz).

    R = T_dst @ T_src^T from each triangle's orthonormal triad (edge, in-plane
    normal component, cross); ok is False for degenerate triangles.
    """

    def triad(pts):
        e1 = pts[..., 1, :] - pts[..., 0, :]
        e2 = pts[..., 2, :] - pts[..., 0, :]
        n1 = torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
        u1 = e1 / torch.clamp(n1, min=1e-12)
        e2p = e2 - torch.sum(e2 * u1, dim=-1, keepdim=True) * u1
        n2 = torch.linalg.vector_norm(e2p, dim=-1, keepdim=True)
        u2 = e2p / torch.clamp(n2, min=1e-12)
        u3 = torch.linalg.cross(u1, u2, dim=-1)
        ok = (n1[..., 0] > 1e-9) & (n2[..., 0] > 1e-9)
        return torch.stack([u1, u2, u3], dim=-1), ok  # columns = basis

    Ts, ok_s = triad(src)
    Td, ok_d = triad(dst)
    R = torch.einsum("...ij,...kj->...ik", Td, Ts)
    t = dst.mean(dim=-2) - torch.einsum("...ij,...j->...i", R, src.mean(dim=-2))
    return R, t, ok_s & ok_d


class P3PSolutions(NamedTuple):
    """Up to 4 poses per problem. T_w2c maps world -> camera."""

    R_w2c: torch.Tensor  # [..., 4, 3, 3]
    t_w2c: torch.Tensor  # [..., 4, 3]
    valid: torch.Tensor  # [..., 4]


def p3p_grunert(bearings: torch.Tensor, pts_world: torch.Tensor) -> P3PSolutions:
    """Solve P3P for [..., 3, 3] unit bearings and [..., 3, 3] world points."""
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    P1, P2, P3 = pts_world[..., 0, :], pts_world[..., 1, :], pts_world[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)  # side a opposite vertex 1
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    cos_a = torch.sum(f2 * f3, dim=-1)
    cos_b = torch.sum(f1 * f3, dim=-1)
    cos_g = torch.sum(f1 * f2, dim=-1)
    b2s = torch.where(b2 < 1e-12, 1.0, b2)
    deg = (b2 < 1e-12) | (a2 < 1e-12) | (c2 < 1e-12)
    acb = (a2 - c2) / b2s
    apb = (a2 + c2) / b2s
    # Grunert quartic coefficients in v (Haralick et al. 1994).
    A4 = (acb - 1.0) ** 2 - 4.0 * (c2 / b2s) * cos_a**2
    A3 = 4.0 * (acb * (1.0 - acb) * cos_b - (1.0 - apb) * cos_a * cos_g + 2.0 * (c2 / b2s) * cos_a**2 * cos_b)
    A2 = 2.0 * (
        acb**2
        - 1.0
        + 2.0 * acb**2 * cos_b**2
        + 2.0 * ((b2 - c2) / b2s) * cos_a**2
        - 4.0 * apb * cos_a * cos_b * cos_g
        + 2.0 * ((b2 - a2) / b2s) * cos_g**2
    )
    A1 = 4.0 * (-acb * (1.0 + acb) * cos_b + 2.0 * (a2 / b2s) * cos_g**2 * cos_b - (1.0 - apb) * cos_a * cos_g)
    A0 = (1.0 + acb) ** 2 - 4.0 * (a2 / b2s) * cos_g**2
    v, v_ok = solve_quartic(A4, A3, A2, A1, A0)  # [..., 4]
    v_ok &= v > 1e-6  # distances must be positive
    acb_, cos_a_, cos_b_, cos_g_ = acb[..., None], cos_a[..., None], cos_b[..., None], cos_g[..., None]
    denom = 2.0 * (cos_g_ - v * cos_a_)
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    u = ((-1.0 + acb_) * v * v - 2.0 * acb_ * cos_b_ * v + 1.0 + acb_) / denom
    u_ok = u > 1e-6
    s1 = torch.sqrt(b2s[..., None] / torch.clamp(1.0 + v * v - 2.0 * v * cos_b_, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    # Camera-frame points per root: [..., 4, 3, 3].
    cam_pts = torch.stack(
        [s1[..., None] * f1[..., None, :], s2[..., None] * f2[..., None, :], s3[..., None] * f3[..., None, :]],
        dim=-2,
    )
    world_pts = pts_world[..., None, :, :].expand(cam_pts.shape)
    R, t, tri_ok = _align_triads(world_pts, cam_pts)
    valid = v_ok & u_ok & ~deg[..., None] & tri_ok
    # The alignment must reproduce the bearings (kills wrong roots, reflections).
    pred = torch.einsum("...rij,...rnj->...rni", R, world_pts) + t[..., None, :]
    pred_n = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + 1e-12)
    align = torch.sum(pred_n * bearings[..., None, :, :], dim=-1)  # cos of the angular error
    valid &= torch.all(align > 0.9999, dim=-1)  # ~0.8 deg
    return P3PSolutions(R_w2c=R, t_w2c=t, valid=valid)
