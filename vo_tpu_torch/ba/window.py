"""Sliding-window bundle adjustment via Schur complement (port of vo_tpu.ba.window).

Jointly refines a window of K keyframe poses and M landmarks by damped
Gauss-Newton (Levenberg-Marquardt) on the stereo reprojection error:

- observations live on a dense [K, M] grid with validity masks, and every
  Jacobian/Hessian block is an einsum over the landmark axis;
- the 3x3-block-diagonal landmark block is inverted in closed form;
- the reduced camera system (6K x 6K, K ~ 10) is solved densely with
  ``torch.linalg.solve_ex`` and no error check: ``torch.linalg.solve`` reads
  its status back to the host on every call, and a singular system must give
  non-finite output (as ``jnp.linalg.solve`` does), which the caller's
  ``isfinite(cost)`` gate rejects;
- the gauge is fixed by a strong prior on pose 0;
- the LM loop runs ``cfg.iters`` steps with accept/reject by ``torch.where``,
  so nothing reads the device mid-solve.

float32 throughout (the runner turns TF32 off).

Landmark-sharded solve (the reference's ``axis_name``): every function that
contracts over the landmark axis takes ``group``, a ``torch.distributed``
process group whose ranks each hold a slice of M (dist.ba_sharded). The
partial sums are then all-reduced, packed into one flat buffer per stage, so
a solve of ``cfg.iters`` steps makes 1 + 3 * iters collectives: the initial
cost with the observation count, and per step the camera blocks (cost, n_obs,
U, g_p), the Schur correction (S_corr, rhs_corr) and the candidate's cost.
Accept/reject compares reduced values only, which are the same bits on every
rank, so the ranks never part ways.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import BAConfig
from ..dist.mesh import all_reduce_sum_packed
from ..geom import se3
from ..geom.camera import StereoCalib
from ..utils.precision import matmul_precision


class BAProblem(NamedTuple):
    """Fixed-capacity window state.

    T_c2w:    [K, 4, 4] keyframe camera-to-world poses (initial estimates)
    X:        [M, 3]    world landmarks
    obs_uv:   [K, M, 2] observed left-camera pixels
    obs_mask: [K, M]    observation validity
    obs_ur:   [K, M]    observed right-camera u (rectified: v_r == v_l); the
                        stereo residual pins metric scale
    obs_ur_mask: [K, M] right-observation validity
    X_mask:   [M]       landmark validity
    kf_mask:  [K]       keyframe validity (unused slots frozen)
    """

    T_c2w: torch.Tensor
    X: torch.Tensor
    obs_uv: torch.Tensor
    obs_mask: torch.Tensor
    obs_ur: torch.Tensor
    obs_ur_mask: torch.Tensor
    X_mask: torch.Tensor
    kf_mask: torch.Tensor


class BAResult(NamedTuple):
    T_c2w: torch.Tensor  # [K, 4, 4] refined poses
    X: torch.Tensor  # [M, 3] refined landmarks
    cost0: torch.Tensor  # initial robust cost
    cost: torch.Tensor  # final robust cost
    n_obs: torch.Tensor  # active observation count


def _project_jacobians(T_w2c, X, calib: StereoCalib):
    """Residual ingredients for the full [K, M] grid, stereo observation model.

    Residual components per observation: (u_left, v_left, u_right). Returns
    (uvr_hat [K,M,3], x_cam [K,M,3], A [K,M,3,6], B [K,M,3,3]) with
    A = d(res)/d(pose twist), B = d(res)/dX.
    """
    R = T_w2c[:, :3, :3]  # [K, 3, 3]
    t = T_w2c[:, :3, 3]  # [K, 3]
    xc = torch.einsum("kij,mj->kmi", R, X) + t[:, None, :]  # [K, M, 3]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    zs = torch.where(torch.abs(z) > 1e-6, z, 1e-6)
    xr = x - calib.baseline  # right-camera x (pure-x rectified baseline)
    u = calib.fu * x / zs + calib.cu
    v = calib.fv * y / zs + calib.cv
    ur = calib.fu * xr / zs + calib.cu
    uv = torch.stack([u, v, ur], dim=-1)
    zero = torch.zeros_like(x)
    Jpi = torch.stack(  # dπ/dx_cam [K, M, 3, 3]
        [
            torch.stack([calib.fu / zs, zero, -calib.fu * x / zs**2], dim=-1),
            torch.stack([zero, calib.fv / zs, -calib.fv * y / zs**2], dim=-1),
            torch.stack([calib.fu / zs, zero, -calib.fu * xr / zs**2], dim=-1),
        ],
        dim=-2,
    )
    # dx_cam/dξ = [I | -[x_cam]×]  (ξ = (υ, ω), T' = exp(ξ) T)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(xc.shape[:-1] + (3, 3))
    Jxi = torch.cat([eye, -se3.hat(xc)], dim=-1)  # [K, M, 3, 6]
    A = torch.einsum("kmij,kmjl->kmil", Jpi, Jxi)
    B = torch.einsum("kmij,kjl->kmil", Jpi, R)
    return uv, xc, A, B


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A_ = e * i - f * h
    B_ = -(d * i - f * g)
    C_ = d * h - e * g
    det = a * A_ + b * B_ + c * C_
    det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    adj = torch.stack(
        [
            torch.stack([A_, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B_, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C_, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _robust_cost_and_weight(r2, huber2: float):
    """Huber: cost rho(r2), IRLS weight rho'(r)/r."""
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    h = huber2**0.5
    cost = torch.where(r2 <= huber2, 0.5 * r2, h * (r - 0.5 * h))
    w = torch.where(r2 <= huber2, 1.0, h / r)
    return cost, w


def _residuals(T_w2c, X, prob: BAProblem, calib, cfg: BAConfig):
    """Shared residual/weight block: (r [K,M,3], comp_w [K,M,3], cost, n_obs, A, B)."""
    uv, xc, A, B = _project_jacobians(T_w2c, X, calib)
    obs = torch.cat([prob.obs_uv, prob.obs_ur[..., None]], dim=-1)
    r = uv - obs  # [K, M, 3]
    behind = xc[..., 2] <= 0.1
    mask = prob.obs_mask & prob.X_mask[None, :] & prob.kf_mask[:, None] & ~behind
    mask_r = mask & prob.obs_ur_mask
    comp_m = torch.stack([mask, mask, mask_r], dim=-1).to(r.dtype)  # [K, M, 3]
    r2 = torch.sum(r * r * comp_m, dim=-1)
    cost_e, w_rob = _robust_cost_and_weight(r2, cfg.huber_px**2)
    comp_w = comp_m * torch.where(mask, w_rob, 0.0)[..., None]
    cost = torch.sum(torch.where(mask, cost_e, 0.0))
    n_obs = torch.sum(mask)
    return r, comp_w, cost, n_obs, A, B


def _assemble(T_w2c, X, prob: BAProblem, calib, cfg: BAConfig, group=None) -> dict:
    """Build the Schur-reduced camera system's ingredients; with ``group``, the sums over
    landmarks (cost, n_obs, U, g_p) are all-reduced over the ranks that shard M."""
    r, comp_w, cost, n_obs, A, B = _residuals(T_w2c, X, prob, calib, cfg)
    Aw = A * comp_w[..., None]
    U = torch.einsum("kmia,kmib->kab", Aw, A)  # [K, 6, 6] camera diagonal blocks
    g_p = -torch.einsum("kmia,kmi->ka", Aw, r)  # [K, 6]
    Bw = B * comp_w[..., None]
    V = torch.einsum("kmia,kmib->mab", Bw, B)  # [M, 3, 3] landmark blocks
    g_l = -torch.einsum("kmia,kmi->ma", Bw, r)  # [M, 3]
    Wkm = torch.einsum("kmia,kmib->kmab", Aw, B)  # [K, M, 6, 3]
    if group is not None:
        cost, n_obs, U, g_p = all_reduce_sum_packed([cost, n_obs, U, g_p], group)
    return dict(U=U, g_p=g_p, V=V, g_l=g_l, Wkm=Wkm, cost=cost, n_obs=n_obs)


def _block_diag_(S: torch.Tensor) -> torch.Tensor:
    """The [K, 6, 6] diagonal blocks S[k, :, k, :] of a [K, 6, K, 6] system, as an in-place view.

    The reference writes ``S.at[ar, :, ar, :]``: advanced indices split by a
    slice, whose indexed shape puts the broadcast K axis first. This view has
    that layout, so ``_block_diag_(S)[k]`` is the reference's ``S[k, :, k, :]``.
    """
    return torch.diagonal(S, dim1=0, dim2=2).permute(2, 0, 1)


def _solve_schur(sys: dict, lam, cfg: BAConfig, kf_mask, group=None):
    """Schur-complement solve for (dxi [K,6], dX [M,3]) at damping lam."""
    U, g_p, V, g_l, Wkm = sys["U"], sys["g_p"], sys["V"], sys["g_l"], sys["Wkm"]
    K = U.shape[0]
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vd = V + lam * (V * eye3 + 1e-6 * eye3)
    V_inv = _inv3x3(Vd)  # [M, 3, 3]

    WV = torch.einsum("kmab,mbc->kmac", Wkm, V_inv)  # [K, M, 6, 3]
    S_corr = torch.einsum("kmac,lmbc->kalb", WV, Wkm)  # [K, 6, K, 6]
    rhs_corr = torch.einsum("kmac,mc->ka", WV, g_l)  # [K, 6]
    if group is not None:
        S_corr, rhs_corr = all_reduce_sum_packed([S_corr, rhs_corr], group)

    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    Ud = U + lam * (U * eye6 + 1e-6 * eye6)
    # Gauge: anchor pose 0; freeze invalid keyframe slots.
    anchor = torch.where(kf_mask, 0.0, 1e8).to(U.dtype)
    anchor[0] += 1e8
    S = torch.zeros((K, 6, K, 6), dtype=U.dtype, device=U.device)
    _block_diag_(S).copy_(Ud)
    S = S - S_corr
    _block_diag_(S).add_(anchor[:, None, None] * eye6)
    rhs = g_p - rhs_corr
    dxi = torch.linalg.solve_ex(S.reshape(6 * K, 6 * K), rhs.reshape(6 * K, 1), check_errors=False)[0].reshape(K, 6)
    dX = torch.einsum("mab,mb->ma", V_inv, g_l - torch.einsum("kmab,ka->mb", Wkm, dxi))
    return dxi, dX


def _apply_update(T_w2c, X, dxi, dX):
    return torch.einsum("kij,kjl->kil", se3.exp(dxi), T_w2c), X + dX


def _cost_only(T_w2c, X, prob, calib, cfg, group=None):
    cost = _residuals(T_w2c, X, prob, calib, cfg)[2]
    return cost if group is None else all_reduce_sum_packed([cost], group)[0]


@matmul_precision("float32")
def solve_window(prob: BAProblem, calib: StereoCalib, cfg: BAConfig, group=None) -> BAResult:
    """LM-damped Gauss-Newton over the window; every value stays on the problem's device.

    With ``group``, ``prob`` holds this rank's slice of the landmark axis (poses
    replicated) and the result's ``X`` is that slice (module docstring).
    """
    T_w2c = se3.inv(prob.T_c2w)
    X = prob.X
    cost0 = _residuals(T_w2c, X, prob, calib, cfg)[2]
    n_obs = torch.sum(prob.obs_mask & prob.X_mask[None, :] & prob.kf_mask[:, None])
    if group is not None:
        cost0, n_obs = all_reduce_sum_packed([cost0, n_obs], group)

    # Trust-region prior toward the VO-chained initial poses (see BAConfig):
    # residual = accumulated twist from the initial poses, Jacobian = identity.
    # Added AFTER the reduced assembly, so that sharded and single-device
    # solves see the identical (replicated) system.
    dt, dev = prob.X.dtype, prob.X.device
    w6 = torch.cat([torch.full((3,), cfg.prior_t_w, dtype=dt, device=dev), torch.full((3,), cfg.prior_r_w, dtype=dt, device=dev)])
    kf_w = prob.kf_mask.to(dt)[:, None]  # [K, 1]: no prior on frozen slots
    prior_U = torch.diag(w6)[None] * kf_w[..., None]

    lam = torch.full((), cfg.damping, dtype=dt, device=dev)
    cost = cost0
    acc = torch.zeros((prob.T_c2w.shape[0], 6), dtype=dt, device=dev)
    for _ in range(cfg.iters):
        sys = _assemble(T_w2c, X, prob, calib, cfg, group)
        sys["U"] = sys["U"] + prior_U
        sys["g_p"] = sys["g_p"] - w6 * acc * kf_w
        dxi, dX = _solve_schur(sys, lam, cfg, prob.kf_mask, group)
        T_try, X_try = _apply_update(T_w2c, X, dxi, dX)
        acc_try = acc + dxi
        cost_try = _cost_only(T_try, X_try, prob, calib, cfg, group) + 0.5 * torch.sum(w6 * acc_try * acc_try * kf_w)
        accept = cost_try < cost  # NaN compares False: a non-finite step is rejected
        T_w2c = torch.where(accept, T_try, T_w2c)
        X = torch.where(accept, X_try, X)
        acc = torch.where(accept, acc_try, acc)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9), lam * 4.0)
        cost = torch.where(accept, cost_try, cost)
    return BAResult(T_c2w=se3.inv(T_w2c), X=X, cost0=cost0, cost=cost, n_obs=n_obs)
