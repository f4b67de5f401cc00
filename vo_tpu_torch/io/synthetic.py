"""Synthetic stereo feed through real KITTI geometry (copy of vo_tpu.io.synthetic).

The renderer and the exact-correspondence generator (``make_tracks``) are plain
numpy; they are copied rather than imported because the
reference module imports jax through its camera model. For the same seed the
frames are byte-identical to the reference's (tests/test_torch_io.py). See
the reference module's docstrings for why the splats look the way they do:
fixed-pixel-scale analytic Gaussian mixtures with a dominant center blob,
composited far-to-near, with a 100 m visibility horizon.
"""
from __future__ import annotations

import os

from typing import NamedTuple

import numpy as np

from ..geom.camera import StereoCalib, scale_calib
from . import kitti

# The committed KITTI-00 geometry: calib.txt (P0/P1) and the GT poses.
DEFAULT_KITTI_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "tests", "data", "kitti"
)


def _c2w_apply(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def _w2c_apply(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return (pts - T[:3, 3]) @ T[:3, :3]


def scatter_landmarks(
    rng: np.random.Generator,
    gt_poses: np.ndarray,
    n_landmarks: int,
    depth_range=(5.0, 60.0),
    lateral_range=(-25.0, 25.0),
    height_range=(-4.0, 3.0),
) -> np.ndarray:
    """Strew [N, 3] world-frame landmarks along the GT trajectory, each anchored to a random pose."""
    idx = rng.integers(0, gt_poses.shape[0], size=n_landmarks)
    z = rng.uniform(*depth_range, size=n_landmarks)
    x = rng.uniform(*lateral_range, size=n_landmarks)
    y = rng.uniform(*height_range, size=n_landmarks)
    cam_pts = np.stack([x, y, z], axis=-1)
    out = np.empty((n_landmarks, 3), dtype=np.float64)
    for i in range(n_landmarks):
        out[i] = _c2w_apply(gt_poses[idx[i]], cam_pts[i])
    return out


class Tracks(NamedTuple):
    """Exact correspondences for one frame pair (no images)."""

    px_prev_l: np.ndarray  # [N, 2] left pixels, frame i-1
    px_prev_r: np.ndarray  # [N, 2] right pixels, frame i-1
    px_cur_l: np.ndarray  # [N, 2] left pixels, frame i
    px_cur_r: np.ndarray  # [N, 2] right pixels, frame i
    pts_prev_cam: np.ndarray  # [N, 3] 3D in frame i-1 camera coords
    pts_cur_cam: np.ndarray  # [N, 3] 3D in frame i camera coords
    rel_pose: np.ndarray  # [4, 4] camera-i pose in frame i-1 coords (the estworldpose target)


def project_np(P: np.ndarray, pts_cam: np.ndarray) -> np.ndarray:
    Xh = np.concatenate([pts_cam, np.ones_like(pts_cam[:, :1])], axis=-1)
    uvw = Xh @ P.T
    return uvw[:, :2] / uvw[:, 2:3]


def make_tracks(
    rng: np.random.Generator,
    calib: StereoCalib,
    pose_prev_c2w: np.ndarray,
    pose_cur_c2w: np.ndarray,
    landmarks_world: np.ndarray,
    noise_px: float = 0.0,
    outlier_frac: float = 0.0,
    max_points: int | None = None,
) -> Tracks:
    """Correspondences between two stereo frames for landmarks visible in all 4 views."""
    H, W = calib.image_size
    P1 = calib.P1.cpu().numpy().astype(np.float64)
    P2 = calib.P2.cpu().numpy().astype(np.float64)

    prev_cam = _w2c_apply(pose_prev_c2w, landmarks_world)
    cur_cam = _w2c_apply(pose_cur_c2w, landmarks_world)
    pxs = [project_np(P, pts) for P, pts in ((P1, prev_cam), (P2, prev_cam), (P1, cur_cam), (P2, cur_cam))]
    vis = (prev_cam[:, 2] > 1.0) & (cur_cam[:, 2] > 1.0)
    for px in pxs:
        vis &= (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
    keep = np.flatnonzero(vis)
    if max_points is not None and keep.size > max_points:
        keep = rng.choice(keep, size=max_points, replace=False)
    pxs = [px[keep] for px in pxs]
    prev_cam, cur_cam = prev_cam[keep], cur_cam[keep]

    if noise_px > 0:
        pxs = [px + rng.normal(scale=noise_px, size=px.shape) for px in pxs]
    n = keep.size
    if outlier_frac > 0 and n > 0:
        n_out = int(outlier_frac * n)
        out_idx = rng.choice(n, size=n_out, replace=False)
        # Corrupt the current-left observation (the one RANSAC scores against).
        pxs[2][out_idx] = np.stack(
            [rng.uniform(0, W, n_out), rng.uniform(0, H, n_out)], axis=-1
        )

    rel = np.linalg.inv(pose_prev_c2w) @ pose_cur_c2w
    return Tracks(
        px_prev_l=pxs[0],
        px_prev_r=pxs[1],
        px_cur_l=pxs[2],
        px_cur_r=pxs[3],
        pts_prev_cam=prev_cam,
        pts_cur_cam=cur_cam,
        rel_pose=rel,
    )


class SyntheticSequence:
    """Rendered stereo feed: ``frame(i) -> (left, right)`` float32 [H, W] in [0, 1]."""

    def __init__(
        self,
        calib: StereoCalib,
        gt_poses: np.ndarray,
        times: np.ndarray | None = None,
        n_landmarks: int = 4000,
        patch: int = 9,
        seed: int = 0,
        image_size: tuple | None = None,
        noise: float = 0.0,
        z_far: float = 100.0,
    ):
        if image_size is not None and tuple(image_size) != tuple(calib.image_size):
            # Rescale intrinsics (not crop) so reduced test resolutions keep the field of view.
            calib = scale_calib(calib, image_size)
        self.calib = calib
        self.gt_poses = gt_poses
        self.times = times
        self.H, self.W = calib.image_size
        self._P1 = calib.P1.cpu().numpy().astype(np.float64)
        self._P2 = calib.P2.cpu().numpy().astype(np.float64)
        rng = np.random.default_rng(seed)
        self.landmarks = scatter_landmarks(rng, gt_poses, n_landmarks)
        self.patch = patch
        self.noise = float(noise)
        self._seed = seed
        self.z_far = float(z_far)
        self.sigma_aa = 0.6  # anti-alias filter stddev, output px
        # Per-landmark Gaussian-mixture fingerprint in texel units: bump 0 is
        # the dominant center blob, bumps 1+ are weaker random side bumps.
        K = 10
        half = patch * 0.5 - 1.0
        cy = rng.uniform(-half, half, size=(n_landmarks, K)).astype(np.float32)
        cx = rng.uniform(-half, half, size=(n_landmarks, K)).astype(np.float32)
        cy[:, 0] = 0.0
        cx[:, 0] = 0.0
        sig = rng.uniform(0.8, 1.6, size=(n_landmarks, K)).astype(np.float32)
        sig[:, 0] = rng.uniform(2.0, 3.0, size=n_landmarks)
        amp = (
            rng.uniform(0.22, 0.4, size=(n_landmarks, K))
            * rng.choice([-1.0, 1.0], size=(n_landmarks, K))
        ).astype(np.float32)
        amp[:, 0] = 0.62 * np.sign(amp[:, 0])
        self._bump_cy, self._bump_cx = cy, cx
        self._bump_sig, self._bump_amp = sig, amp

    def __len__(self) -> int:
        return self.gt_poses.shape[0]

    def _render(self, pts_cam: np.ndarray, P: np.ndarray) -> np.ndarray:
        H, W, p = self.H, self.W, self.patch
        pad = 40  # must exceed the largest half-splat
        img = np.full((H + 2 * pad, W + 2 * pad), 0.35, dtype=np.float32)
        vis = (pts_cam[:, 2] > 1.0) & (pts_cam[:, 2] < self.z_far)
        px = project_np(P, np.where(vis[:, None], pts_cam, np.array([0.0, 0.0, 10.0])))
        inb = vis & (px[:, 0] >= 1) & (px[:, 0] < W - 1) & (px[:, 1] >= 1) & (px[:, 1] < H - 1)
        s2aa = self.sigma_aa**2
        # Painter's algorithm: far-to-near so near splats occlude far ones.
        order = np.flatnonzero(inb)[np.argsort(-pts_cam[inb, 2])]
        for i in order:
            u, v = px[i]
            oy = self._bump_cy[i]
            ox = self._bump_cx[i]
            var = self._bump_sig[i] ** 2 + s2aa  # [K], AA filter folded in
            amp = self._bump_amp[i] * self._bump_sig[i] ** 2 / var
            h = float(0.5 * p + 3.0 * np.sqrt(var.max()))
            r0, r1 = int(np.ceil(v - h)), int(np.floor(v + h))
            c0, c1 = int(np.ceil(u - h)), int(np.floor(u + h))
            r0, r1 = max(r0, -pad), min(r1, H + pad - 1)
            c0, c1 = max(c0, -pad), min(c1, W + pad - 1)
            ry = np.arange(r0, r1 + 1) - v
            rx = np.arange(c0, c1 + 1) - u
            dy = ry[:, None] - oy[None, :]  # [By, K]
            dx = rx[:, None] - ox[None, :]  # [Bx, K]
            inv2v = 0.5 / var
            gy = np.exp(-dy * dy * inv2v) * amp  # amplitude folded into the y factor
            gx = np.exp(-dx * dx * inv2v)
            vals = gy @ gx.T  # separable isotropic mixture: [By, Bx]
            # Opaque composite under a wide Gaussian alpha (keeps each center single-layer).
            a_var = (0.55 * p) ** 2 + s2aa
            ay = np.exp(ry * ry * (-0.5 / a_var))
            ax = np.exp(rx * rx * (-0.5 / a_var))
            alpha = 0.98 * ay[:, None] * ax[None, :]
            box = img[r0 + pad : r1 + 1 + pad, c0 + pad : c1 + 1 + pad]
            box *= 1.0 - alpha
            box += alpha * (0.42 + vals)
        return np.clip(img[pad : pad + H, pad : pad + W], 0.0, 1.0)

    def frame(self, i: int):
        pose = self.gt_poses[i]
        pts_cam = _w2c_apply(pose, self.landmarks)
        left = self._render(pts_cam, self._P1)
        right = self._render(pts_cam, self._P2)
        if self.noise > 0.0:
            rl = np.random.default_rng((self._seed, i, 0))
            rr = np.random.default_rng((self._seed, i, 1))
            left = np.clip(left + rl.normal(0.0, self.noise, left.shape).astype(np.float32), 0.0, 1.0)
            right = np.clip(right + rr.normal(0.0, self.noise, right.shape).astype(np.float32), 0.0, 1.0)
        return left, right

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)


def kitti_synthetic_sequence(
    root: str = DEFAULT_KITTI_ROOT,
    seq: str = "00",
    n_frames: int = 50,
    n_landmarks: int = 4000,
    seed: int = 0,
    image_size: tuple | None = None,
) -> SyntheticSequence:
    """Synthetic feed from the KITTI calib + GT poses under ``root`` (``<root>/<seq>/calib.txt``,
    ``<root>/poses/<seq>.txt``)."""
    seq_dir = os.path.join(root, seq)
    calib = kitti.load_stereo_calib(seq_dir)
    poses = kitti.read_poses(os.path.join(root, "poses", f"{seq}.txt"))[:n_frames]
    times_path = os.path.join(seq_dir, "times.txt")
    times = kitti.read_times(times_path)[:n_frames] if os.path.exists(times_path) else None
    return SyntheticSequence(
        calib, poses, times=times, n_landmarks=n_landmarks, seed=seed, image_size=image_size
    )
