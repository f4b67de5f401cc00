"""The plain reference of one sliding-window bundle adjustment, in float64.

Written from the mathematics, not copied from the program: Levenberg-Marquardt on the robust
stereo reprojection error (Triggs, McLauchlan, Hartley, Fitzgibbon, "Bundle Adjustment - A Modern
Synthesis", 2000: the reduced camera system by the Schur complement, section 6.1; Huber's M-estimator
as iteratively reweighted least squares, section 3.4), with the semantics of ``BAConfig``:
``iters`` damped steps, Marquardt's diagonal damping from ``damping``, a Huber kernel of
``huber_px``, a prior of weight ``prior_t_w`` / ``prior_r_w`` that holds each pose near the pose the
window was assembled with, and the gates the refiner applies to a solve (finite cost that did not
grow; a last-keyframe correction within ``max_corr_t`` and ``max_corr_deg``).

The problem is the one the program assembled (its record): K keyframe slots, ``kf_mask`` marking
the used ones, M landmark slots, observations on a dense [K, M] grid with their masks. Each
observation of landmark X in camera k contributes the residual (u_l, v_l, u_r) - observed, of the
rectified stereo pinhole: x = R_k X + t_k (world to camera), u_l = fu x/z + cu, v_l = fv y/z + cv,
u_r = fu (x - b)/z + cu. A pose is updated on the left, T_k <- exp(dxi_k) T_k with dxi = (v, w),
and a landmark additively. Where the program makes a choice the textbook leaves open, this file
makes the same one, noted at its line.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import se3
from .config import BAConfig

ANCHOR = 1e8  # the gauge: a penalty that holds pose 0 (and every unused slot) in place


class WindowSolveRef(NamedTuple):
    T_c2w: torch.Tensor  # [K, 4, 4] float64
    X: torch.Tensor  # [M, 3] float64
    cost0: float
    cost: float
    verdict: str  # "accepted", "rejected" (correction gate) or "cost" (the cost gate)


def _camera(T_w2c, X, fu, fv, cu, cv, b):
    """Predicted (u_l, v_l, u_r) [K, M, 3], camera points [K, M, 3], and the Jacobians in the pose
    twist A [K, M, 3, 6] and in the landmark B [K, M, 3, 3]."""
    R, t = T_w2c[:, :3, :3], T_w2c[:, :3, 3]
    xc = torch.einsum("kij,mj->kmi", R, X) + t[:, None, :]
    x, y, z = xc.unbind(-1)
    z_safe = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    pred = torch.stack([fu * x / z_safe + cu, fv * y / z_safe + cv, fu * (x - b) / z_safe + cu], dim=-1)
    zero = torch.zeros_like(x)
    z2 = z_safe * z_safe
    d_pi = torch.stack(
        [
            torch.stack([fu / z_safe, zero, -fu * x / z2], dim=-1),
            torch.stack([zero, fv / z_safe, -fv * y / z2], dim=-1),
            torch.stack([fu / z_safe, zero, -fu * (x - b) / z2], dim=-1),
        ],
        dim=-2,
    )
    # d(exp(dxi) T x)/d(dxi) at 0 = [I | -[x_c]x]
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(xc.shape[:-1] + (3, 3))
    A = d_pi @ torch.cat([eye, -se3.hat(xc)], dim=-1)
    B = d_pi @ R[:, None]
    return pred, xc, A, B


def _huber(r2, h):
    """Huber's rho of the squared norm, and the IRLS weight rho'(r) / r."""
    r = torch.sqrt(r2.clamp(min=1e-12))
    small = r2 <= h * h
    return torch.where(small, 0.5 * r2, h * (r - 0.5 * h)), torch.where(small, torch.ones_like(r), h / r)


def _terms(T_w2c, X, p, calib, cfg):
    """Residuals [K, M, 3], per-component weights [K, M, 3], robust cost, A, B at the estimate."""
    pred, xc, A, B = _camera(T_w2c, X, *calib)
    obs = torch.cat([p["obs_uv"], p["obs_ur"][..., None]], dim=-1)
    r = pred - obs
    # An observation counts where its landmark and keyframe are used and the point lies more than
    # 0.1 m in front of the camera at the current estimate (the program's cheirality gate).
    used = p["obs_mask"] & p["X_mask"][None, :] & p["kf_mask"][:, None] & (xc[..., 2] > 0.1)
    comp = torch.stack([used, used, used & p["obs_ur_mask"]], dim=-1).to(r.dtype)
    r2 = (r * r * comp).sum(-1)
    rho, w = _huber(r2, cfg.huber_px)
    cost = torch.where(used, rho, torch.zeros_like(rho)).sum()
    return r, comp * torch.where(used, w, torch.zeros_like(w))[..., None], cost, A, B


def _step(T_w2c, X, acc, lam, p, calib, cfg, w6, kf_w):
    """One damped Gauss-Newton step by the Schur complement -> (dxi [K, 6], dX [M, 3])."""
    r, wc, _, A, B = _terms(T_w2c, X, p, calib, cfg)
    K, M = A.shape[0], A.shape[1]
    Aw, Bw = A * wc[..., None], B * wc[..., None]
    U = torch.einsum("kmia,kmib->kab", Aw, A)
    V = torch.einsum("kmia,kmib->mab", Bw, B)
    W = torch.einsum("kmia,kmib->kmab", Aw, B)  # [K, M, 6, 3]
    g_p = -torch.einsum("kmia,kmi->ka", Aw, r)
    g_l = -torch.einsum("kmia,kmi->ma", Bw, r)
    # The prior: residual = the sum of the twists the accepted steps applied to the pose, with an
    # identity Jacobian (the program's form of "near the assembled pose"; the log of the pose's
    # change differs from it in second order).
    U = U + torch.diag(w6)[None] * kf_w[:, :, None]
    g_p = g_p - w6 * acc * kf_w
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    # Marquardt's damping: lam times the diagonal, plus lam * 1e-6 so that an empty block stays
    # invertible (the program's floor).
    V_inv = torch.linalg.inv(V + lam * (V * eye3 + 1e-6 * eye3))
    U_d = U + lam * (U * eye6 + 1e-6 * eye6)
    WV = torch.einsum("kmab,mbc->kmac", W, V_inv)
    S = -torch.einsum("kmac,lmbc->kalb", WV, W)
    anchor = torch.where(p["kf_mask"], 0.0, ANCHOR).to(X.dtype)
    anchor[0] += ANCHOR
    for k in range(K):
        S[k, :, k, :] += U_d[k] + anchor[k] * eye6
    rhs = g_p - torch.einsum("kmac,mc->ka", WV, g_l)
    dxi = torch.linalg.solve(S.reshape(6 * K, 6 * K), rhs.reshape(6 * K)).reshape(K, 6)
    dX = torch.einsum("mab,mb->ma", V_inv, g_l - torch.einsum("kmab,ka->mb", W, dxi))
    return dxi, dX


def solve(problem: dict, calib, cfg: BAConfig, device, n_kf: int) -> WindowSolveRef:
    """Solve a recorded problem ({BAProblem field: array}) in float64 on ``device``; ``calib`` is
    (fu, fv, cu, cv, baseline); ``n_kf`` the window's keyframes (the slots the gate reads)."""
    f64 = dict(dtype=torch.float64, device=device)
    p = {
        k: torch.as_tensor(np.asarray(v), device=device) if np.asarray(v).dtype == bool else torch.as_tensor(np.asarray(v), **f64)
        for k, v in problem.items()
    }
    T_w2c = se3.inv(p["T_c2w"])
    X = p["X"]
    w6 = torch.tensor([cfg.prior_t_w] * 3 + [cfg.prior_r_w] * 3, **f64)
    kf_w = p["kf_mask"].to(torch.float64)[:, None]
    acc = torch.zeros((T_w2c.shape[0], 6), **f64)
    cost0 = float(_terms(T_w2c, X, p, calib, cfg)[2])
    cost, lam = cost0, cfg.damping
    for _ in range(cfg.iters):
        dxi, dX = _step(T_w2c, X, acc, lam, p, calib, cfg, w6, kf_w)
        T_try = se3.exp(dxi) @ T_w2c
        X_try = X + dX
        acc_try = acc + dxi
        c = float(_terms(T_try, X_try, p, calib, cfg)[2] + 0.5 * (w6 * acc_try * acc_try * kf_w).sum())
        if c < cost:  # a step that does not lower the cost (or is not finite) is refused
            T_w2c, X, acc, cost = T_try, X_try, acc_try, c
            lam = max(lam * 0.3, 1e-9)
        else:
            lam = lam * 4.0
    T_c2w = se3.inv(T_w2c)
    verdict = gate(p["T_c2w"][n_kf - 1], T_c2w[n_kf - 1], cost0, cost, cfg)
    return WindowSolveRef(T_c2w=T_c2w, X=X, cost0=cost0, cost=cost, verdict=verdict)


def gate(T_before, T_after, cost0: float, cost: float, cfg: BAConfig) -> str:
    """The refiner's gates on a solve: "cost" where its cost is not finite or grew, "rejected" where
    the last keyframe's pose (``T_before`` -> ``T_after``, [4, 4] camera-to-world) moved more than
    ``max_corr_t`` or turned more than ``max_corr_deg``, else "accepted"."""
    if not np.isfinite(cost) or cost > cost0:
        return "cost"
    D = torch.as_tensor(T_after, dtype=torch.float64) @ torch.linalg.inv(torch.as_tensor(T_before, dtype=torch.float64))
    d_t = float(torch.linalg.vector_norm(D[:3, 3]))
    d_deg = float(np.degrees(np.arccos(np.clip((float(torch.trace(D[:3, :3])) - 1.0) / 2.0, -1.0, 1.0))))
    return "rejected" if d_t > cfg.max_corr_t or d_deg > cfg.max_corr_deg else "accepted"
