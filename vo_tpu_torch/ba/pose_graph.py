"""Pose-graph optimization over keyframes (port of vo_tpu.ba.pose_graph).

Two solvers of the same problem. The residual of edge (i, j, Z_ij) is
log(Z_ij^{-1} T_i^{-1} T_j) in R^6.

``optimize`` is the float32 Gauss-Newton on the device: 6x6 Jacobian blocks
from forward-mode differentiation of the edge residual at zero twist
(``torch.func.vmap`` over ``torch.func.jvp``), assembled into a dense
6K x 6K system, fixed iteration count with accept/reject by ``torch.where``,
first pose anchored. The blocks are assembled by one-hot products over the
[E, K] incidence (``assemble``), not by scatter-adds: on CUDA
``index_add_`` / ``index_put_(accumulate=True)`` use atomics, whose float sum
order varies from run to run, and a matrix product has one order. The dense
solve is ``torch.linalg.solve_ex`` without its error check, so nothing reads
the device mid-solve. Only the sharded pose graph (dist.pose_graph_sharded)
and the tests call it.

``optimize_np`` is the host float64 solve for the global loop-closure graph.
Redistributing a loop correction along an n-node odometry chain rides
curvature modes with eigenvalues ~O(1/n^2); at a few hundred keyframes the
dense 6n x 6n system's condition number (~1e10 with the gauge anchor) exceeds
float32 resolution and a float32 solve silently under-corrects. The solve is
rare (one per accepted closure), runs on the refiner's worker thread and is
small, so it is an exact numpy solve on the host. Its functions are the
reference's numpy code, copied verbatim: the reference module imports jax at
its top.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..dist.mesh import all_reduce_sum_packed
from ..geom import se3


class PoseGraph(NamedTuple):
    T_c2w: torch.Tensor  # [K, 4, 4] keyframe poses (initial)
    edge_i: torch.Tensor  # [E] integer source keyframe index
    edge_j: torch.Tensor  # [E] integer target keyframe index
    edge_T: torch.Tensor  # [E, 4, 4] measured relative pose T_i^{-1} T_j
    edge_mask: torch.Tensor  # [E] validity
    edge_weight: torch.Tensor  # [E] scalar information weight


class PoseGraphResult(NamedTuple):
    T_c2w: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor


def _edge_residual(xi_i, xi_j, T_i, T_j, Z):
    """r = log(Z^{-1} (exp(xi_i) T_i)^{-1} (exp(xi_j) T_j)) -> [6]."""
    Ti = se3.compose(se3.exp(xi_i), T_i)
    Tj = se3.compose(se3.exp(xi_j), T_j)
    return se3.log(se3.compose(se3.inv(Z), se3.compose(se3.inv(Ti), Tj)))


def _residuals_and_jac(T, g: PoseGraph):
    """(r [E, 6], Ji [E, 6, 6], Jj [E, 6, 6]): residuals and their Jacobians in the two twists at 0.

    Forward mode, as the reference's ``vmap(jacfwd)``: an edge's residual
    depends on its own two twists only, so pushing the basis twist e_k of all
    edges at once through the batched residual gives column k of every edge's
    block. (The per-edge form, ``vmap(jacfwd)`` over unbatched twists, meets a
    0-dim dual tensor plus a Python scalar in ``se3.exp``, whose tangent
    PyTorch promotes to float64.)
    """
    E = g.edge_i.shape[0]
    Ti = T[g.edge_i.long()]
    Tj = T[g.edge_j.long()]
    z6 = torch.zeros((E, 6), dtype=T.dtype, device=T.device)
    r = _edge_residual(z6, z6, Ti, Tj, g.edge_T)

    def column(e):
        t = e.expand(E, 6)
        di = torch.func.jvp(lambda a: _edge_residual(a, z6, Ti, Tj, g.edge_T), (z6,), (t,))[1]
        dj = torch.func.jvp(lambda b: _edge_residual(z6, b, Ti, Tj, g.edge_T), (z6,), (t,))[1]
        return di, dj

    Di, Dj = torch.func.vmap(column)(torch.eye(6, dtype=T.dtype, device=T.device))  # [6 twists, E, 6]
    return r, Di.permute(1, 2, 0), Dj.permute(1, 2, 0)


def edge_cost(T, g: PoseGraph, w) -> torch.Tensor:
    """Weighted squared residual of the graph's edges at poses ``T`` (scalar)."""
    z6 = torch.zeros((g.edge_i.shape[0], 6), dtype=T.dtype, device=T.device)
    r = _edge_residual(z6, z6, T[g.edge_i.long()], T[g.edge_j.long()], g.edge_T)
    return torch.sum(w * torch.sum(r * r, dim=-1))


def assemble(T, g: PoseGraph, w):
    """The edges' normal equations: (H [K, 6, K, 6], b [K, 6], deg [K] valid edges per node).

    Each is a sum over the edges, so a shard of the edges gives a partial sum
    (``optimize`` all-reduces the three over its ``group``). The scatter onto nodes is
    a product with the one-hot [E, K] incidence matrices (module docstring).
    """
    K = T.shape[0]
    r, Ji, Jj = _residuals_and_jac(T, g)
    Jiw = Ji * w[:, None, None]
    Jjw = Jj * w[:, None, None]
    oi = torch.nn.functional.one_hot(g.edge_i.long(), K).to(T.dtype)  # [E, K]
    oj = torch.nn.functional.one_hot(g.edge_j.long(), K).to(T.dtype)
    Hij = torch.einsum("eab,eac->ebc", Jiw, Jj)
    H = (
        torch.einsum("ek,el,ebc->kblc", oi, oi, torch.einsum("eab,eac->ebc", Jiw, Ji))
        + torch.einsum("ek,el,ebc->kblc", oj, oj, torch.einsum("eab,eac->ebc", Jjw, Jj))
        + torch.einsum("ek,el,ebc->kblc", oi, oj, Hij)
        + torch.einsum("ek,el,ecb->kblc", oj, oi, Hij)
    )
    b = -torch.einsum("ek,eab,ea->kb", oi, Jiw, r) - torch.einsum("ek,eab,ea->kb", oj, Jjw, r)
    m = g.edge_mask.to(T.dtype)
    deg = m @ oi + m @ oj
    return H, b, deg


def gn_update(T, lam, H, b, deg) -> torch.Tensor:
    """Solve the damped, anchored system and apply the step: the candidate poses [K, 4, 4]."""
    K = T.shape[0]
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    # Anchor the gauge (node 0) AND every edge-less node: padded node slots
    # otherwise leave ~zero diagonal blocks that wreck the float32 LU solve.
    first = torch.arange(K, device=T.device) == 0
    anchor = torch.where(first | (deg == 0), 1e6, 0.0).to(T.dtype)
    Hd = H.clone()
    torch.diagonal(Hd, dim1=0, dim2=2).permute(2, 0, 1).add_((anchor + lam)[:, None, None] * eye6)
    dxi = torch.linalg.solve_ex(Hd.reshape(6 * K, 6 * K), b.reshape(6 * K, 1), check_errors=False)[0].reshape(K, 6)
    return torch.einsum("kij,kjl->kil", se3.exp(dxi), T)


def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-6, group=None) -> PoseGraphResult:
    """Fixed-iteration damped Gauss-Newton on the graph's device; first keyframe anchored (gauge).

    The damping starts AT the caller's value (no floor: a loop correction
    rides chain modes with eigenvalues ~O(1/n^2)), drops x0.3 on an accepted
    step and grows x10 on a rejected one. With ``group``, ``g`` holds this
    rank's slice of the edges (poses replicated) and the sums over edges are
    all-reduced: (H, b, deg) in one collective and the candidate's cost in
    another per iteration, plus the initial cost. Accept/reject compares
    reduced values, the same bits on every rank.
    """

    def reduced(*tensors):
        return list(tensors) if group is None else all_reduce_sum_packed(list(tensors), group)

    w = torch.where(g.edge_mask, g.edge_weight, 0.0)
    T = g.T_c2w
    lam = torch.full((), damping, dtype=T.dtype, device=T.device)
    (cost0,) = reduced(edge_cost(T, g, w))
    cost = cost0
    for _ in range(iters):
        T_try = gn_update(T, lam, *reduced(*assemble(T, g, w)))
        (cost_try,) = reduced(edge_cost(T_try, g, w))
        better = cost_try < cost  # NaN compares False: a non-finite step is rejected
        T = torch.where(better, T_try, T)
        cost = torch.where(better, cost_try, cost)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-8), lam * 10.0)
    return PoseGraphResult(T_c2w=T, cost0=cost0, cost=cost)


def odometry_edges(T_c2w: torch.Tensor, weight: float = 1.0):
    """Consecutive-keyframe edges from a pose chain: Z_i = T_i^{-1} T_{i+1}."""
    K = T_c2w.shape[0]
    dev = T_c2w.device
    i = torch.arange(K - 1, dtype=torch.int32, device=dev)
    Z = torch.matmul(se3.inv(T_c2w[:-1]), T_c2w[1:])
    return i, i + 1, Z, torch.ones(K - 1, dtype=torch.bool, device=dev), torch.full((K - 1,), weight, dtype=T_c2w.dtype, device=dev)


def _np_exp_so3(w):
    import numpy as np

    theta2 = (w * w).sum(-1)
    theta = np.sqrt(theta2 + 1e-300)
    a = np.where(theta2 < 1e-8, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
    b = np.where(theta2 < 1e-8, 0.5 - theta2 / 24.0, (1.0 - np.cos(theta)) / np.maximum(theta2, 1e-300))
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2] = -w[..., 2], w[..., 1]
    W[..., 1, 0], W[..., 1, 2] = w[..., 2], -w[..., 0]
    W[..., 2, 0], W[..., 2, 1] = -w[..., 1], w[..., 0]
    eye = np.broadcast_to(np.eye(3), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _np_exp_se3(xi):
    import numpy as np

    v, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = np.sqrt(theta2 + 1e-300)
    R = _np_exp_so3(w)
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2] = -w[..., 2], w[..., 1]
    W[..., 1, 0], W[..., 1, 2] = w[..., 2], -w[..., 0]
    W[..., 2, 0], W[..., 2, 1] = -w[..., 1], w[..., 0]
    b = np.where(theta2 < 1e-8, 0.5 - theta2 / 24.0, (1.0 - np.cos(theta)) / np.maximum(theta2, 1e-300))
    c = np.where(
        theta2 < 1e-8, 1.0 / 6.0 - theta2 / 120.0, (theta - np.sin(theta)) / np.maximum(theta2 * theta, 1e-300)
    )
    eye = np.broadcast_to(np.eye(3), W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    T = np.zeros(xi.shape[:-1] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, v)
    T[..., 3, 3] = 1.0
    return T


def _np_log_se3(T):
    import numpy as np

    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = np.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    vvec = np.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = 0.5 * np.sqrt((vvec * vvec).sum(-1) + 1e-300)
    theta = np.arctan2(sin_t, cos_t)
    scale = np.where(theta < 1e-4, 0.5 + theta * theta / 12.0, theta / np.maximum(2.0 * sin_t, 1e-300))
    w = vvec * scale[..., None]
    # Near theta = pi the antisymmetric part vanishes (vvec -> 0) and
    # theta/(2 sin) is ill-conditioned: an out-and-back revisit produces a
    # ~pi loop edge whose residuals/Jacobians would be garbage and the
    # closure silently lost (ADVICE r4). Recover the axis from the
    # SYMMETRIC part instead: (R + R^T)/2 = cos(t) I + (1-cos t) nn^T, so
    # the largest column of nn^T gives the axis up to sign; the (tiny but
    # sign-correct) antisymmetric vector disambiguates the sign. At exactly
    # pi both signs are valid logarithms.
    near_pi = theta > 3.0
    if np.any(near_pi):
        eye3 = np.broadcast_to(np.eye(3), R.shape)
        B = 0.5 * (R + np.swapaxes(R, -1, -2))
        nnT = (B - cos_t[..., None, None] * eye3) / np.maximum(
            (1.0 - cos_t)[..., None, None], 1e-12
        )
        diag = np.maximum(np.einsum("...ii->...i", nnT), 0.0)
        k = np.argmax(diag, axis=-1)
        ax = np.take_along_axis(nnT, k[..., None, None], axis=-1)[..., 0]
        ax = ax / np.maximum(np.linalg.norm(ax, axis=-1, keepdims=True), 1e-12)
        sign = np.where(np.einsum("...i,...i->...", ax, vvec) < 0.0, -1.0, 1.0)
        w = np.where(near_pi[..., None], theta[..., None] * ax * sign[..., None], w)
    theta2 = (w * w).sum(-1)
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2] = -w[..., 2], w[..., 1]
    W[..., 1, 0], W[..., 1, 2] = w[..., 2], -w[..., 0]
    W[..., 2, 0], W[..., 2, 1] = -w[..., 1], w[..., 0]
    coef = np.where(
        theta2 < 1e-8,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - np.sqrt(theta2) * np.sin(np.sqrt(theta2)) / np.maximum(2.0 * (1.0 - np.cos(np.sqrt(theta2))), 1e-300))
        / np.maximum(theta2, 1e-300),
    )
    eye = np.broadcast_to(np.eye(3), W.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    v = np.einsum("...ij,...j->...i", Vinv, t)
    return np.concatenate([v, w], axis=-1)


def optimize_np(T_c2w, edge_i, edge_j, edge_T, edge_weight, iters: int = 10, damping: float = 1e-9):
    """Exact-size float64 LM on the loop-closure graph (see block comment).

    Args are plain numpy: T_c2w [n,4,4]; edge_* [E] / [E,4,4] (all edges
    valid — callers drop padding). Returns (T [n,4,4] f64, cost0, cost).
    """
    import numpy as np

    T = np.asarray(T_c2w, np.float64).copy()
    ei = np.asarray(edge_i)
    ej = np.asarray(edge_j)
    Z = np.asarray(edge_T, np.float64)
    w = np.asarray(edge_weight, np.float64)
    n = T.shape[0]
    Zinv = np.linalg.inv(Z)

    def residuals(T):
        Ti = T[ei]
        Tj = T[ej]
        return _np_log_se3(Zinv @ np.linalg.inv(Ti) @ Tj)  # [E, 6]

    def cost_of(T):
        r = residuals(T)
        with np.errstate(over="ignore", invalid="ignore"):
            c = float((w * (r * r).sum(-1)).sum())
        return c if np.isfinite(c) else np.inf  # wild trial step -> reject

    eps = 1e-7
    lam = damping
    cost = cost_of(T)
    cost0 = cost
    for _ in range(iters):
        r = residuals(T)
        # Finite-difference Jacobians of the LEFT-multiplicative increments,
        # vectorized over edges: 12 perturbed residual sweeps.
        Ji = np.zeros((r.shape[0], 6, 6))
        Jj = np.zeros((r.shape[0], 6, 6))
        Ti = T[ei]
        Tj = T[ej]
        base = Zinv @ np.linalg.inv(Ti) @ Tj
        for d in range(6):
            xi = np.zeros(6)
            xi[d] = eps
            E = _np_exp_se3(xi)
            r_i = _np_log_se3(Zinv @ np.linalg.inv(E[None] @ Ti) @ Tj)
            r_j = _np_log_se3(base @ np.linalg.inv(Tj) @ (E[None] @ Tj))
            Ji[:, :, d] = (r_i - r) / eps
            Jj[:, :, d] = (r_j - r) / eps
        H = np.zeros((n, 6, n, 6))
        b = np.zeros((n, 6))
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        np.add.at(H, (ei, slice(None), ei, slice(None)), np.einsum("eab,eac->ebc", Jiw, Ji))
        np.add.at(H, (ej, slice(None), ej, slice(None)), np.einsum("eab,eac->ebc", Jjw, Jj))
        Hij = np.einsum("eab,eac->ebc", Jiw, Jj)
        np.add.at(H, (ei, slice(None), ej, slice(None)), Hij)
        np.add.at(H, (ej, slice(None), ei, slice(None)), np.swapaxes(Hij, -1, -2))
        np.add.at(b, ei, -np.einsum("eab,ea->eb", Jiw, r))
        np.add.at(b, ej, -np.einsum("eab,ea->eb", Jjw, r))
        Hm = H.reshape(6 * n, 6 * n)
        # Gauge: node 0 anchored by penalty (f64 makes the conditioning moot).
        diag = np.zeros(n)
        diag[0] = 1e9
        for k in range(n):
            Hm[6 * k : 6 * k + 6, 6 * k : 6 * k + 6] += (diag[k] + lam) * np.eye(6)
        try:
            dxi = np.linalg.solve(Hm, b.reshape(-1)).reshape(n, 6)
        except np.linalg.LinAlgError:
            lam = max(lam * 10.0, 1e-6)
            continue
        T_try = _np_exp_se3(dxi) @ T
        c_try = cost_of(T_try)
        if c_try < cost:
            T, cost = T_try, c_try
            lam = max(lam * 0.3, 1e-12)
            if cost0 > 0 and cost < 1e-10 * max(cost0, 1.0):
                break
        else:
            lam = max(lam * 10.0, 1e-9)
    return T, cost0, cost
