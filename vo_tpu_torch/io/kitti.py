"""KITTI odometry parsers (port of vo_tpu.io.kitti, the host-side numpy part)."""
from __future__ import annotations

import os

import numpy as np

from ..geom.camera import StereoCalib, calib_from_projections


def read_calib(path: str) -> dict:
    """Parse calib.txt -> {'P0': [3,4], 'P1': [3,4], ...} (kitti/00/calib.txt rows)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, _, rest = line.partition(":")
            vals = np.array(rest.split(), dtype=np.float64)
            if vals.size == 12:
                out[name.strip()] = vals.reshape(3, 4)
    return out


def load_stereo_calib(seq_dir: str, image_size=(376, 1241)) -> StereoCalib:
    """Left/right gray-pair calibration like VO.m:24-51 (P0 = left, P1 = right)."""
    c = read_calib(os.path.join(seq_dir, "calib.txt"))
    # A feed is host data: the runner moves its calibration to the device it runs on.
    return calib_from_projections(c["P0"], c["P1"], image_size=image_size, device="cpu")


def read_times(path: str) -> np.ndarray:
    """times.txt -> [N] float seconds (VO.m:13)."""
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def read_poses(path: str) -> np.ndarray:
    """GT pose file -> [N, 4, 4] camera-to-world; each row is a flattened 3x4 [R|t]."""
    raw = np.loadtxt(path, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw[None]
    n = raw.shape[0]
    T = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    T[:, :3, :4] = raw.reshape(n, 3, 4)
    return T
