"""KITTI calib and pose readers (frozen copies of vo_tpu_torch/io/kitti.py::read_calib and
::read_poses) and the scalar intrinsics that vo_tpu_torch/geom/camera.py::calib_from_projections
derives, in numpy. The benchmark reads the committed KITTI-00 files with these, never with the
program's readers."""
from __future__ import annotations

import numpy as np


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


def read_poses(path: str) -> np.ndarray:
    """GT pose file -> [N, 4, 4] camera-to-world; each row is a flattened 3x4 [R|t]."""
    raw = np.loadtxt(path, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw[None]
    n = raw.shape[0]
    T = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    T[:, :3, :4] = raw.reshape(n, 3, 4)
    return T


def projections(calib_path: str, image_size, full_size=(376, 1241)):
    """(P1, P2) float32 [3, 4] of the left (P0) and right (P1) gray cameras, rescaled from
    ``full_size`` to ``image_size`` as vo_tpu_torch/geom/camera.py::scale_calib does (in float32)."""
    c = read_calib(calib_path)
    P1, P2 = c["P0"].astype(np.float32), c["P1"].astype(np.float32)
    if tuple(image_size) != tuple(full_size):
        sy, sx = image_size[0] / full_size[0], image_size[1] / full_size[1]
        S = np.array([[sx, 0.0, 0.0], [0.0, sy, 0.0], [0.0, 0.0, 1.0]], np.float32)
        P1, P2 = S @ P1, S @ P2
    return P1, P2
