"""Hypothesis-parallel RANSAC-P3P world pose + IRLS Gauss-Newton refinement (port of vo_tpu.pose.ransac).

Replaces MATLAB ``estworldpose`` (VO.m:123-127): a fixed batch of
``n_hypotheses`` minimal samples, all P3P quartics solved at once, MSAC
scoring of every (hypothesis x point) reprojection as one reduction, then a
fixed ``refine_iters`` IRLS-GN on the consensus set. Returns the camera pose in
the 3D points' frame (camera-to-world), the convention chained at VO.m:130.

The consensus refinement (gate, IRLS-GN, re-gate, packaging) is one launch of the
hand-written kernel K3 ``pose_refine`` (csrc/pose_refine.cu) for CUDA tensors:
``_finalize_f32`` takes its plain version ``_finalize_plain`` only for CPU tensors.

The samples come from a ``torch.Generator`` and cannot match ``jax.random``;
``best_hypothesis`` and ``estimate_world_pose`` therefore also take the
sampled triples as an input, so tests can inject the reference's own draws.
All geometry runs in full float32 (both entry points pin it, utils.precision): world
coordinates of tens of meters lose centimeters in reduced-precision products.
Nothing here reads a value back to the host.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..config import RansacConfig
from ..geom import se3
from ..geom.camera import StereoCalib
from ..utils import cuda_lib
from ..utils.padding import take
from ..utils.precision import matmul_precision
from .p3p import p3p_grunert


class PoseEstimate(NamedTuple):
    pose_c2w: torch.Tensor  # [4, 4] camera pose in the 3D points' frame
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # scalar int
    ok: torch.Tensor  # scalar bool; False -> the caller falls back
    mean_err: torch.Tensor  # scalar, mean inlier reprojection error (px)


def _project_w2c(R, t, pts, calib: StereoCalib):
    """Project world points through [R|t] (world->cam) with the left intrinsics."""
    Xc = torch.einsum("...ij,nj->...ni", R, pts) + t[..., None, :]
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = calib.fu * Xc[..., 0] / zs + calib.cu
    v = calib.fv * Xc[..., 1] / zs + calib.cv
    return torch.stack([u, v], dim=-1), z


def _bearings(px: torch.Tensor, calib: StereoCalib) -> torch.Tensor:
    x = (px[..., 0] - calib.cu) / calib.fu
    y = (px[..., 1] - calib.cv) / calib.fv
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _sample_triples(gen: torch.Generator, mask: torch.Tensor, n_hyp: int) -> torch.Tensor:
    """Draw [H, 3] indices of valid correspondences: Gumbel top-3 per hypothesis,
    so the three indices of a hypothesis are distinct."""
    logits = torch.where(mask, 0.0, -math.inf)
    u = torch.rand((n_hyp, mask.shape[0]), generator=gen, device=mask.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.topk(logits[None, :] + g, 3, dim=1).indices


HUBER_PX = 2.0  # the refinement's Huber threshold (px)


def refine_pose(R0, t0, px2d, pts3d, weights, calib: StereoCalib, iters: int, huber_px: float = HUBER_PX):
    """Masked IRLS Gauss-Newton on the world->cam pose. Returns refined (R, t)."""
    R, t = R0, t0
    eye6 = 1e-6 * torch.eye(6, dtype=px2d.dtype, device=px2d.device)
    for _ in range(iters):
        pred, _ = _project_w2c(R, t, pts3d, calib)
        r = pred - px2d  # [N, 2]
        err = torch.linalg.vector_norm(r, dim=-1)
        w = weights * torch.where(err <= huber_px, 1.0, huber_px / torch.clamp(err, min=1e-9))
        Xc = pts3d @ R.T + t
        x, y = Xc[:, 0], Xc[:, 1]
        zc = torch.where(torch.abs(Xc[:, 2]) < 1e-6, 1e-6, Xc[:, 2])
        inv_z = 1.0 / zc
        zr = torch.zeros_like(x)
        # d(pred)/d(Xc): [N, 2, 3]
        Jp = torch.stack(
            [
                torch.stack([calib.fu * inv_z, zr, -calib.fu * x * inv_z * inv_z], dim=-1),
                torch.stack([zr, calib.fv * inv_z, -calib.fv * y * inv_z * inv_z], dim=-1),
            ],
            dim=-2,
        )
        # d(Xc)/d(xi) for the left-multiplicative update exp(xi): [I | -[Xc]x] -> [N, 3, 6]
        eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
        J = torch.einsum("nij,njk->nik", Jp, torch.cat([eye, -se3.hat(Xc)], dim=-1))  # [N, 2, 6]
        H = torch.einsum("n,nik,nil->kl", w, J, J) + eye6
        g = torch.einsum("n,nik,ni->k", w, J, r)
        delta = torch.linalg.solve_ex(H, g[:, None])[0][:, 0]  # no error check: no host sync
        T_new = se3.compose(se3.exp(-delta), se3.from_rt(R, t))
        R, t = se3.rotation(T_new), se3.translation(T_new)
    return R, t


def best_hypothesis(px2d, pts3d, mask, calib: StereoCalib, cfg: RansacConfig, triples: torch.Tensor):
    """P3P on every [H, 3] sampled triple + MSAC scoring; returns (R_w2c, t_w2c, msac_score, any_valid).

    The batch is whatever ``triples`` holds (the reference's ``n_hypotheses=``):
    dist.ransac_sharded hands each rank its rows of the replicated draw and
    reduces the local winners with one all-gather and an argmin.
    """
    bear = _bearings(px2d, calib)
    sols = p3p_grunert(take(bear, triples), take(pts3d, triples))  # [H, 4, ...]
    R_all = sols.R_w2c.reshape(-1, 3, 3)
    t_all = sols.t_w2c.reshape(-1, 3)
    valid_h = sols.valid.reshape(-1)
    # --- score: one [H*4, N] reprojection reduction (MSAC) ---
    pred, z = _project_w2c(R_all, t_all, pts3d, calib)
    err2 = torch.sum((pred - px2d) ** 2, dim=-1)
    thr2 = cfg.max_reproj_err_px**2
    point_ok = mask[None, :] & (z > 0.0)
    msac = torch.sum(torch.where(point_ok, torch.clamp(err2, max=thr2), thr2), dim=-1)
    msac = torch.where(valid_h, msac, math.inf)
    best = torch.argmin(msac).reshape(1)
    return take(R_all, best)[0], take(t_all, best)[0], take(msac, best)[0], valid_h.any()


@matmul_precision("float32")
def finalize_pose(R_best, t_best, any_valid, px2d, pts3d, mask, calib: StereoCalib, cfg: RansacConfig) -> PoseEstimate:
    """Refine the winning hypothesis on its consensus set and package the result (replicated
    on every rank of a mesh: dist.ransac_sharded)."""
    return _finalize_f32(R_best, t_best, any_valid, px2d, pts3d, mask, calib, cfg)


# K3 (csrc/pose_refine.cu): six inputs, n, fu, fv, cu, cv, thr2, huber, iters, min_points, five outputs.
_K3 = cuda_lib.Kernel("vo_pose_refine", "pose_refine",
                      [*[ctypes.c_void_p] * 6, ctypes.c_int, *[ctypes.c_float] * 6, *[ctypes.c_int] * 2, *[ctypes.c_void_p] * 5])


def _finalize_f32(R_best, t_best, any_valid, px2d, pts3d, mask, calib: StereoCalib, cfg: RansacConfig) -> PoseEstimate:
    """Refine the winning hypothesis on its consensus set and package the result: the plain
    version on the CPU, one launch of K3 on the current stream for CUDA tensors."""
    if px2d.device.type == "cpu":
        return _finalize_plain(R_best, t_best, any_valid, px2d, pts3d, mask, calib, cfg)
    n = px2d.shape[0]
    expected = (  # in the kernel's order
        (px2d, torch.float32, (n, 2)), (pts3d, torch.float32, (n, 3)), (mask, torch.bool, (n,)),
        (R_best, torch.float32, (3, 3)), (t_best, torch.float32, (3,)), (any_valid, torch.bool, ()),
    )
    for x, dtype, shape in expected:
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != px2d.device:
            raise ValueError(
                f"pose_refine: expected contiguous {dtype} {shape} on {px2d.device}, got {x.dtype} "
                f"{tuple(x.shape)} strides {x.stride()} on {x.device}"
            )
    if px2d.device.type != "cuda":
        raise ValueError(f"pose_refine: expected CPU or CUDA tensors, got device {px2d.device}")
    if n >= 2**24:
        raise ValueError(f"pose_refine: {n} points; the kernel counts inliers in float32, exact below 2**24")
    dev = px2d.device
    pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    n_in = torch.empty((), dtype=torch.int64, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    mean_err = torch.empty((), dtype=torch.float32, device=dev)
    _K3.launch(
        px2d, *(x.data_ptr() for x, _, _ in expected),
        n, calib.fu, calib.fv, calib.cu, calib.cv, cfg.max_reproj_err_px**2, HUBER_PX, cfg.refine_iters,
        cfg.min_points,
        *(x.data_ptr() for x in (pose, inliers, n_in, ok, mean_err)),
    )
    return PoseEstimate(pose_c2w=pose, inliers=inliers, n_inliers=n_in, ok=ok, mean_err=mean_err)


def _finalize_plain(R_best, t_best, any_valid, px2d, pts3d, mask, calib: StereoCalib, cfg: RansacConfig) -> PoseEstimate:
    """Refine the winning hypothesis on its consensus set and package the result: the plain
    PyTorch version of K3 (csrc/pose_refine.cu), taken for CPU tensors."""
    n_valid = mask.sum()
    thr2 = cfg.max_reproj_err_px**2
    pred0, z0 = _project_w2c(R_best, t_best, pts3d, calib)
    err2_0 = torch.sum((pred0 - px2d) ** 2, dim=-1)
    inliers0 = mask & (z0 > 0.0) & (err2_0 < thr2)
    R_ref, t_ref = refine_pose(R_best, t_best, px2d, pts3d, inliers0.to(px2d.dtype), calib, cfg.refine_iters)
    # Re-gate the inliers with the refined pose; keep it only if it kept the consensus.
    pred_r, z_r = _project_w2c(R_ref, t_ref, pts3d, calib)
    err2_r = torch.sum((pred_r - px2d) ** 2, dim=-1)
    inliers_r = mask & (z_r > 0) & (err2_r < thr2)
    better = inliers_r.sum() >= inliers0.sum()
    R_fin = torch.where(better, R_ref, R_best)
    t_fin = torch.where(better, t_ref, t_best)
    inliers = torch.where(better, inliers_r, inliers0)
    n_in = inliers.sum()
    ok = (n_valid >= cfg.min_points) & any_valid & (n_in >= 3)
    err_fin = torch.sqrt(torch.where(better, err2_r, err2_0))
    mean_err = torch.sum(torch.where(inliers, err_fin, 0.0)) / torch.clamp(n_in, min=1)
    # estworldpose convention: camera pose in the world (= prev-camera) frame.
    return PoseEstimate(
        pose_c2w=se3.inv(se3.from_rt(R_fin, t_fin)), inliers=inliers, n_inliers=n_in, ok=ok, mean_err=mean_err
    )


@matmul_precision("float32")
def estimate_world_pose(
    px2d: torch.Tensor,  # [N, 2] current-frame LEFT pixels (VO.m:124)
    pts3d: torch.Tensor,  # [N, 3] 3D points in the previous camera's frame (VO.m:125)
    mask: torch.Tensor,  # [N] validity
    calib: StereoCalib,
    cfg: RansacConfig,
    gen: torch.Generator | None = None,
    triples: torch.Tensor | None = None,
) -> PoseEstimate:
    """RANSAC-P3P (hypothesize/score + refine); draws ``cfg.n_hypotheses`` triples from
    ``gen`` unless ``triples`` [H, 3] are given."""
    if triples is None:
        triples = _sample_triples(gen, mask, cfg.n_hypotheses)
    R_best, t_best, _, any_valid = best_hypothesis(px2d, pts3d, mask, calib, cfg, triples)
    return _finalize_f32(R_best, t_best, any_valid, px2d, pts3d, mask, calib, cfg)
