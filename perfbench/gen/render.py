"""The splat renderer of the benchmark's world (frozen copy of vo_tpu_torch/io/synthetic.py:
``scatter_landmarks``, ``project_np`` and ``SyntheticSequence``'s constructor, ``_render`` and
``frame``, numpy only). It takes the projection matrices as float32 numpy arrays where the
original takes a ``StereoCalib``; for the same matrices, landmarks and seed the frames are the
same bytes (perfbench/tests/test_perfbench_copies.py)."""
from __future__ import annotations

import numpy as np


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


def project_np(P: np.ndarray, pts_cam: np.ndarray) -> np.ndarray:
    Xh = np.concatenate([pts_cam, np.ones_like(pts_cam[:, :1])], axis=-1)
    uvw = Xh @ P.T
    return uvw[:, :2] / uvw[:, 2:3]



def quantize(img) -> np.ndarray:
    """A frame as uint8 (floats in [0, 1] quantized as vo_tpu_torch/bench.py::_q does)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return a


class Renderer:
    """Rendered stereo feed over ``gt_poses``: ``frame(i) -> (left, right)`` float32 [H, W] in [0, 1]."""

    def __init__(self, P1, P2, image_size, gt_poses: np.ndarray, n_landmarks: int, patch: int = 9, seed: int = 0,
                 noise: float = 0.0, z_far: float = 100.0):
        self.gt_poses = gt_poses
        self.H, self.W = (int(s) for s in image_size)
        self._P1 = np.asarray(P1, np.float32).astype(np.float64)
        self._P2 = np.asarray(P2, np.float32).astype(np.float64)
        rng = np.random.default_rng(seed)
        self.landmarks = scatter_landmarks(rng, gt_poses, n_landmarks)
        self.patch = patch
        self.perspective_splats = False
        self.noise = float(noise)
        self._seed = seed
        self.z_far = float(z_far)
        self.z_ref = 20.0
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
        pad = 40  # must exceed the largest half-splat (the perspective scale's clamp)
        img = np.full((H + 2 * pad, W + 2 * pad), 0.35, dtype=np.float32)
        vis = (pts_cam[:, 2] > 1.0) & (pts_cam[:, 2] < self.z_far)
        px = project_np(P, np.where(vis[:, None], pts_cam, np.array([0.0, 0.0, 10.0])))
        inb = vis & (px[:, 0] >= 1) & (px[:, 0] < W - 1) & (px[:, 1] >= 1) & (px[:, 1] < H - 1)
        s2aa = self.sigma_aa**2
        # Painter's algorithm: far-to-near so near splats occlude far ones.
        order = np.flatnonzero(inb)[np.argsort(-pts_cam[inb, 2])]
        for i in order:
            u, v = px[i]
            # Perspective magnification clamped to the padding; at s = 1 every product below is
            # exact, so the fixed-size render is the same bytes either way.
            s = min(self.z_ref / float(pts_cam[i, 2]), (pad - 4.0) / p) if self.perspective_splats else 1.0
            oy = self._bump_cy[i] * s
            ox = self._bump_cx[i] * s
            var = (self._bump_sig[i] * s) ** 2 + s2aa  # [K], AA filter folded in
            amp = self._bump_amp[i] * (self._bump_sig[i] * s) ** 2 / var
            h = float(s * (0.5 * p) + 3.0 * np.sqrt(var.max()))
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
            a_var = (0.55 * p * s) ** 2 + s2aa
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

