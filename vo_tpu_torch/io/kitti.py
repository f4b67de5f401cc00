"""KITTI odometry dataset parsers and image feed (port of vo_tpu.io.kitti).

All parsers are host-side numpy; the runner moves frames and calibration to
the device it runs on. Images are decoded by the native C++ loader where it
can be built (io.native_loader), else by PIL, in the reference's order;
``StereoSequence.decoder`` says which.
"""
from __future__ import annotations

import os
from typing import Iterator

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


def list_frames(seq_dir: str, cam: int = 0) -> list:
    """Sorted PNG paths for one camera feed (VO.m:16-17 imageDatastore)."""
    d = os.path.join(seq_dir, f"image_{cam}")
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".png"))


def decoder() -> str:
    """The image decoder ``read_image`` uses: "native" (io.native_loader) where it builds, else "PIL"."""
    from . import native_loader

    return "native" if native_loader.available() else "PIL"


def read_image(path: str) -> np.ndarray:
    """Decode one grayscale PNG -> [H, W] float32 in [0, 1] (native loader, else PIL)."""
    if decoder() == "native":
        from . import native_loader

        return native_loader.read_png_gray(path)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.float32) / 255.0


class StereoSequence:
    """Lazy stereo frame feed over a KITTI sequence directory: the reference's two
    imageDatastores + readimage (VO.m:16-17, 71-72), plus calib/times/GT in one handle.
    ``decoder`` names the image decoder in use ("native" or "PIL")."""

    def __init__(self, seq_dir: str, poses_path: str | None = None, prefetch: bool = True):
        self.seq_dir = seq_dir
        self.calib = load_stereo_calib(seq_dir)
        times_path = os.path.join(seq_dir, "times.txt")
        self.times = read_times(times_path) if os.path.exists(times_path) else None
        self.left_paths = list_frames(seq_dir, 0)
        self.right_paths = list_frames(seq_dir, 1)
        self.gt_poses = read_poses(poses_path) if poses_path and os.path.exists(poses_path) else None
        self.decoder = decoder()
        # Native decode-ahead pool (C++ threads): interleave L/R so both eyes
        # of frame i decode together.
        self._feed = None
        if prefetch and self.left_paths and self.decoder == "native":
            from . import native_loader

            inter = [p for lr in zip(self.left_paths, self.right_paths) for p in lr]
            self._feed = native_loader.PrefetchFeed(inter, ahead=8, threads=4)

    def __len__(self) -> int:
        return len(self.left_paths)

    def frame(self, i: int):
        if self._feed is not None:
            return self._feed[2 * i], self._feed[2 * i + 1]
        return read_image(self.left_paths[i]), read_image(self.right_paths[i])

    def close(self):
        if self._feed is not None:
            self._feed.close()
            self._feed = None

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self.frame(i)
