"""Host float64 pose-graph solve for the global loop-closure graph (port of vo_tpu.ba.pose_graph, host part).

Redistributing a loop correction along an n-node odometry chain rides
curvature modes with eigenvalues ~O(1/n^2); at a few hundred keyframes the
dense 6n x 6n system's condition number (~1e10 with the gauge anchor) exceeds
float32 resolution and a float32 solve silently under-corrects. The solve is
rare (one per accepted closure), runs on the refiner's worker thread and is
small, so it is an exact numpy float64 solve on the host.

The functions are the reference's numpy code, copied verbatim: the reference
module imports jax at its top. The jitted float32 ``optimize`` and
``odometry_edges`` serve only the sharded pose graph and are not ported.
"""
from __future__ import annotations


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
