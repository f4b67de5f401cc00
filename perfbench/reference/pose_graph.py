"""The plain reference of one loop-closure pose-graph solve, in float64.

Written from the mathematics (Kümmerle et al., "g2o: A General Framework for Graph Optimization",
ICRA 2011: Gauss-Newton / Levenberg-Marquardt over SE(3) edges with a left-multiplicative
perturbation and a fixed gauge), with the semantics of ``LoopConfig``: the nodes are the archived
keyframes' poses, every two consecutive keyframes are joined by an odometry edge of weight
``odometry_weight`` measuring their relative pose as the nodes hold it, every accepted loop (and
every verified loop kept as a constraint) is an edge of weight ``loop_weight`` measuring the
verified relative pose, and ``graph_iters`` steps run. The residual of edge (i, j) with
measurement Z is r = log(Z^-1 T_i^-1 T_j) in R^6 (translation part first), the cost is
sum_e w_e |r_e|^2, and the Jacobians are exact (forward-mode derivatives in the two twists).

What this file takes from the record: the nodes' poses before the solve and the loop edges
(their ends and measurements). It builds the edges and weights itself, from the configuration.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import se3
from .config import LoopConfig

ANCHOR = 1e9  # the gauge: a penalty that holds node 0 in place (the program's choice)


class GraphSolveRef(NamedTuple):
    T: Optional[torch.Tensor]  # [n, 4, 4] float64; None where the solve is rejected
    cost0: float
    cost: float


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm [..., 4, 4] -> [..., 6] = (V(w)^-1 t, w). The angle from the trace and the
    antisymmetric part (atan2), the axis from the antisymmetric part, and past 3.0 rad, where that
    part vanishes, from the symmetric part R + R^T = 2 cos(theta) I + 2 (1 - cos(theta)) n n^T (an
    out-and-back log has edges that turn by nearly pi about the vertical axis). The nodes' poses
    are float32 values, so a product's rotation is orthonormal to about 1e-7 only, and formulas that
    agree on a rotation differ there by as much: these are the program's (the 3.0-rad switch too)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = 0.5 * torch.sqrt((v * v).sum(-1) + 1e-300)
    theta = torch.atan2(sin_t, cos_t)
    w = v * torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0, theta / torch.clamp(2.0 * sin_t, min=1e-300))[..., None]
    near_pi = theta > 3.0
    if bool(near_pi.any()):
        eye3 = torch.eye(3, dtype=T.dtype, device=T.device).expand(R.shape)
        nnT = (0.5 * (R + R.transpose(-1, -2)) - cos_t[..., None, None] * eye3) / torch.clamp(1.0 - cos_t, min=1e-12)[..., None, None]
        k = torch.diagonal(nnT, dim1=-2, dim2=-1).clamp(min=0.0).argmax(dim=-1)
        ax = torch.gather(nnT, -1, k[..., None, None].expand(k.shape + (3, 1)))[..., 0]
        ax = ax / torch.clamp(torch.linalg.vector_norm(ax, dim=-1, keepdim=True), min=1e-12)
        sign = torch.where((ax * v).sum(-1) < 0.0, -1.0, 1.0).to(T.dtype)  # the sign that the antisymmetric part keeps
        w = torch.where(near_pi[..., None], theta[..., None] * ax * sign[..., None], w)
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-8
    safe = torch.where(small, torch.ones_like(th), th)
    # V^-1 = I - W/2 + c W^2, c = (1 - theta sin(theta) / (2 (1 - cos(theta)))) / theta^2
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - safe * torch.sin(safe) / torch.clamp(2.0 * (1.0 - torch.cos(safe)), min=1e-300)) / (safe * safe))
    W = se3.hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    return torch.cat([((eye - 0.5 * W + c[..., None, None] * (W @ W)) @ t[..., None])[..., 0], w], dim=-1)


def _residuals(T, ei, ej, Z_inv, xi_i=None, xi_j=None):
    Ti, Tj = T[ei], T[ej]
    if xi_i is not None:
        Ti = se3.exp(xi_i) @ Ti
        Tj = se3.exp(xi_j) @ Tj
    return log(Z_inv @ torch.linalg.inv(Ti) @ Tj)


def edges(T0: torch.Tensor, loops: list, cfg: LoopConfig):
    """(edge_i, edge_j, Z [E, 4, 4], weight [E]) of a graph over nodes ``T0`` with ``loops`` [(i, j, Z)]."""
    n = T0.shape[0]
    dev = T0.device
    ei = list(range(n - 1)) + [int(a) for a, _, _ in loops]
    ej = list(range(1, n)) + [int(b) for _, b, _ in loops]
    odo = torch.linalg.inv(T0[:-1]) @ T0[1:]
    Z = torch.cat([odo] + [torch.as_tensor(np.asarray(z), dtype=torch.float64, device=dev)[None] for _, _, z in loops])
    w = torch.tensor([cfg.odometry_weight] * (n - 1) + [cfg.loop_weight] * len(loops), dtype=torch.float64, device=dev)
    return torch.tensor(ei, device=dev), torch.tensor(ej, device=dev), Z, w


def solve(T0, ei, ej, Z, w, iters: int, damping: float = 1e-9) -> GraphSolveRef:
    """Levenberg-Marquardt from ``T0`` [n, 4, 4] float64 for ``iters`` steps."""
    n, E = T0.shape[0], ei.shape[0]
    Z_inv = torch.linalg.inv(Z)

    def cost_of(T):
        r = _residuals(T, ei, ej, Z_inv)
        c = float((w * (r * r).sum(-1)).sum())
        return c if np.isfinite(c) else float("inf")

    T = T0.clone()
    cost = cost0 = cost_of(T)
    lam = damping
    zero = torch.zeros((E, 6), dtype=T.dtype, device=T.device)
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        r = _residuals(T, ei, ej, Z_inv)
        # Column d of every edge's block in T_j at once: the derivative along the basis twist e_d.
        # With E = Z^-1 T_i^-1 T_j, exp(x) T_i gives E exp(-Ad(T_j^-1) x) and exp(x) T_j gives
        # E exp(Ad(T_j^-1) x), so the block in T_i is the negative of the block in T_j.
        def column(e):
            return torch.func.jvp(lambda b: _residuals(T, ei, ej, Z_inv, zero, b), (zero,), (e.expand(E, 6),))[1]

        Jj = torch.func.vmap(column)(eye6).permute(1, 2, 0)  # [E, 6 residuals, 6 twists]
        Ji = -Jj
        H = torch.zeros((n, n, 6, 6), dtype=T.dtype, device=T.device)  # block (a, b) at H[a, b]
        g = torch.zeros((n, 6), dtype=T.dtype, device=T.device)
        wJi, wJj = w[:, None, None] * Ji, w[:, None, None] * Jj
        tr = lambda J: J.transpose(-1, -2)
        H.index_put_((ei, ei), tr(wJi) @ Ji, accumulate=True)
        H.index_put_((ej, ej), tr(wJj) @ Jj, accumulate=True)
        H.index_put_((ei, ej), tr(wJi) @ Jj, accumulate=True)
        H.index_put_((ej, ei), tr(wJj) @ Ji, accumulate=True)
        g.index_add_(0, ei, -(tr(wJi) @ r[..., None])[..., 0])
        g.index_add_(0, ej, -(tr(wJj) @ r[..., None])[..., 0])
        # Damping lam * I (not Marquardt's diagonal), and the gauge on node 0 (the program's).
        diag = torch.full((n,), lam, dtype=T.dtype, device=T.device)
        diag[0] += ANCHOR
        nodes = torch.arange(n, device=T.device)
        H[nodes, nodes] += diag[:, None, None] * eye6
        H = H.permute(0, 2, 1, 3)
        dxi = torch.linalg.solve(H.reshape(6 * n, 6 * n), g.reshape(6 * n)).reshape(n, 6)
        T_try = se3.exp(dxi) @ T
        c = cost_of(T_try)
        if c < cost:
            T, cost = T_try, c
            lam = max(lam * 0.3, 1e-12)
            if cost0 > 0 and cost < 1e-10 * max(cost0, 1.0):  # converged to rounding: stop (the program's rule)
                break
        else:
            lam = max(lam * 10.0, 1e-9)
    rejected = not np.isfinite(cost) or cost > cost0
    return GraphSolveRef(T=None if rejected else T, cost0=cost0, cost=cost)
