"""Trajectory evaluation: the reference's xz-plane error plus proper ATE/RPE
(the port's own copy of the JAX package's metrics; numpy only).

``xz_error`` replicates PlotOnMap.m:20 — per-frame Euclidean error of the
(x, z) translation components against the GT file rows. Note the reference's
off-by-one: ``all_poses(1)`` is the FRAME-2 pose but is compared against GT
row 1 (PlotOnMap.m:9 with the first append at VO.m:133). Pass
``reference_offset=True`` to replicate that; default aligns frame i to GT i.
"""
from __future__ import annotations

import numpy as np


def _translations(poses: np.ndarray) -> np.ndarray:
    return poses[:, :3, 3]


def xz_error(
    est: np.ndarray, gt: np.ndarray, reference_offset: bool = False
) -> np.ndarray:
    """[T] per-frame xz-plane error (PlotOnMap.m:20).

    est: [T, 4, 4] world poses starting at frame 2 (like all_poses).
    gt:  [N, 4, 4] GT poses starting at frame 1.
    """
    T = est.shape[0]
    gt_rows = gt[:T] if reference_offset else gt[1 : T + 1]
    te = _translations(est)
    tg = _translations(gt_rows)
    d = te[:, [0, 2]] - tg[:, [0, 2]]
    return np.linalg.norm(d, axis=1)


def ate(est: np.ndarray, gt: np.ndarray, align: bool = False) -> dict:
    """Absolute trajectory error (full 3D). Optional SE(3) Umeyama alignment."""
    T = est.shape[0]
    te = _translations(est)
    tg = _translations(gt[1 : T + 1])
    if align and T >= 3:
        mu_e, mu_g = te.mean(0), tg.mean(0)
        E, G = te - mu_e, tg - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        S = np.eye(3)
        S[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ S @ U.T
        te = (te - mu_e) @ R.T + mu_g
    err = np.linalg.norm(te - tg, axis=1)
    return dict(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
    )


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> dict:
    """Relative pose error over ``delta``-frame steps (translation m, rotation deg)."""
    T = est.shape[0]
    gt_rows = gt[1 : T + 1]
    t_errs, r_errs = [], []
    for i in range(T - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt_rows[i]) @ gt_rows[i + delta]
        err = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(err[:3, 3]))
        ang = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.degrees(np.arccos(ang)))
    return dict(
        trans_rmse=float(np.sqrt(np.mean(np.square(t_errs)))) if t_errs else 0.0,
        rot_rmse_deg=float(np.sqrt(np.mean(np.square(r_errs)))) if r_errs else 0.0,
    )
