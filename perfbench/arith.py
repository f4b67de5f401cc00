"""The benchmark's own arithmetic, frozen here so that a change to the program cannot move it.

- ``ate_errors``: per-frame translation errors of an unaligned trajectory against its GT rows
  (frozen copy of vo_tpu_torch/eval/metrics.py::ate, which reduces them to its ``rmse``);
- ``k1_bytes`` / ``k2_bytes``: the bytes one detection call's K1 / K2 launch needs, inputs read
  once and outputs written once, from the shapes (frozen copy of chip_smoke.py's phase-3 count);
- ``roofline``: a kernel's share of its bound by bytes over the traced frame loop, in %.
"""
from __future__ import annotations

import numpy as np

from .trace import FRAME_LOOP

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, published peak (chip_smoke.py)
NB = 8  # orientation bins of K2's maps


def ate_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[T] |t_est - t_gt|: est rows are frames 1..T (row t - 1 is frame t), gt rows frames 0..T."""
    T = est.shape[0]
    te = np.asarray(est, np.float64)[:, :3, 3]
    tg = np.asarray(gt, np.float64)[1 : T + 1, :3, 3]
    return np.linalg.norm(te - tg, axis=1)


def octave_shapes(image_size, n_octaves: int) -> list:
    """(H, W) of every octave: the input, then each halved and rounded up (frontend/pyramid.py's
    decimation)."""
    H, W = (int(s) for s in image_size)
    out = []
    for _ in range(n_octaves):
        out.append((H, W))
        H, W = (H + 1) // 2, (W + 1) // 2
    return out


def k1_bytes(sift: dict, image_size, batch: int) -> int:
    """K1 over one detection call: DoG stacks [B, S+2, H, W] in, scores [B, S, H, W] out, float32."""
    L = sift["scales_per_octave"] + 2
    px = sum(h * w for h, w in octave_shapes(image_size, sift["n_octaves"]))
    return 4 * batch * (2 * L - 2) * px


def k2_bytes(sift: dict, image_size, batch: int) -> int:
    """K2 over one detection call: levels [B, S, H, W] in, pooled maps [B, S, 8, H/2, W/2] out, float32."""
    shapes = octave_shapes(image_size, sift["n_octaves"])
    n_lev = sift["scales_per_octave"]
    px = sum(h * w for h, w in shapes)
    pooled = sum((h // 2) * (w // 2) for h, w in shapes)
    return 4 * batch * n_lev * (px + NB * pooled)


def detection_calls(n_frames: int, group: int) -> list:
    """The image batch of each detection call of a frame loop over ``n_frames`` (runner.run_sequence:
    ``group`` frames a call from frame 0, one frame a call for a tail that does not fill a group)."""
    if group <= 1:
        return [2] * n_frames
    return [2 * group] * (n_frames // group) + [2] * (n_frames % group)


def roofline(run, kernel: str, bytes_fn) -> float | None:
    """``kernel``'s bound by bytes over its device time, in %, for the launches inside the traced
    job's frame loop; None without a trace, or where the launches are not one per detection call."""
    tr = run.trace
    if tr is None:
        return None
    ns = tr.kernel_ns(kernel, FRAME_LOOP)
    calls = detection_calls(run.jobs[0].n_frames, run.group)
    if len(ns) != len(calls) or ns.sum() <= 0:
        return None
    sift, size = run.config["pipeline"]["sift"], run.world.image_size
    need = sum(bytes_fn(sift, size, b) for b in calls)
    return 100.0 * (need / HBM_BYTES_PER_S) / (float(ns.sum()) / 1e9)
