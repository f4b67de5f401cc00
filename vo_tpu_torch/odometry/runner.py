"""Host-side sequence runner around the per-frame step (port of vo_tpu.odometry.runner, main path).

The reference's outer ``for i = 1:n_frames`` (VO.m:64) on its deferred fast
path: ``cfg.fused_group`` frames per step with detection batched across them,
a single-frame step for the tail, frames staged on the device as uint8, and
the per-frame history kept as device tensors and read back once at the end,
so the host never waits on the device inside the loop.

Not ported yet: window BA, loop closure, the device mesh, checkpoint/resume,
per-frame progress/metrics callbacks and the live figures. Each raises
``NotImplementedError`` when asked for.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from . import landmarks as lm_mod
from .pipeline import init_state, vo_step, vo_step_multi


@dataclasses.dataclass
class RunResult:
    poses: np.ndarray  # [T, 4, 4] world poses (frames 2..N like all_poses, VO.m:133)
    rel_poses: np.ndarray  # [T, 4, 4]
    n_inliers: np.ndarray  # [T]
    n_tracks: np.ndarray  # [T]
    pose_ok: np.ndarray  # [T] bool
    landmarks: np.ndarray  # [M, 3]
    frames_per_sec: float
    per_frame_ms: float


def _unsupported(**opts) -> None:
    for name, value in opts.items():
        if value:
            raise NotImplementedError(f"vo_tpu_torch.odometry.runner.run_sequence: {name} is not ported yet")


def to_device(img, device) -> torch.Tensor:
    """A frame as a uint8 [H, W] tensor on ``device`` (floats in [0, 1] are quantized to 8 bits)."""
    if isinstance(img, torch.Tensor):
        return img.to(device)
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        # Pinned source: the copy is queued on the stream instead of waiting for it.
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class StagedSequence:
    """A feed rendered once and staged on ``device`` as uint8 (the frames never leave it):
    the timed loop then measures the pipeline, not host rendering or copies."""

    def __init__(self, seq, n: int, device):
        self.calib = seq.calib
        self.gt_poses = seq.gt_poses
        self.frames = [tuple(to_device(im, device) for im in seq.frame(i)) for i in range(n)]

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int):
        return self.frames[i]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_sequence(
    seq,
    cfg: PipelineConfig,
    n_frames: Optional[int] = None,
    seed: int = 0,
    insert_landmarks: Optional[bool] = None,
    progress: Optional[Callable[[int, dict], None]] = None,
    warmup: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    metrics_path: Optional[str] = None,
    use_ba: bool = False,
    use_loop_closure: bool = False,
    viz_every: int = 0,
    viz_dir: Optional[str] = None,
    mesh=None,
    device="cpu",
) -> RunResult:
    """Run plain VO over ``seq`` (``frame(i) -> (left, right)``, ``calib``, ``len``) on ``device``.

    ``insert_landmarks`` defaults to cfg.view_3d (the reference's single flag,
    VO.m:6/145). Frames may be numpy images or tensors already on the device.
    """
    _unsupported(
        progress=progress is not None,
        checkpoint=bool(checkpoint_path) or checkpoint_every > 0 or resume,
        metrics_path=metrics_path is not None,
        use_ba=use_ba,
        use_loop_closure=use_loop_closure,
        viz=viz_every > 0 or viz_dir is not None,
        mesh=mesh is not None,
    )
    device = torch.device(device)
    # Full float32 everywhere: the geometry needs it (ransac module docstring),
    # and reduced precision in the pyramid flickers detections.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    calib = seq.calib.to(device)
    if insert_landmarks is None:
        insert_landmarks = cfg.view_3d
    n = len(seq) if n_frames is None else min(n_frames, len(seq))
    group = cfg.fused_group

    def run_group(state, lmap, dev_frames):
        if len(dev_frames) == 2:
            state, out = vo_step(state, dev_frames[0], dev_frames[1], calib, cfg)
            outs = [out]
        else:
            state, outs = vo_step_multi(state, dev_frames, calib, cfg)
        if lmap is not None:
            for out in outs:
                lm_mod.insert(lmap, out.new_lm_l_px, out.new_lm_r_px, out.new_lm_mask, out.pose_c2w, calib, cfg.landmarks)
        return state, outs

    if warmup:
        # Throwaway state and map: first-use costs (kernel build, library
        # handles, allocator growth) land here, outside the timed loop.
        l0, r0 = (to_device(im, device) for im in seq.frame(0))
        w_map = lm_mod.init_map(cfg.landmarks, device) if insert_landmarks else None
        if group > 1:
            run_group(init_state(cfg, seed, device), w_map, [l0, r0] * group)
        if group == 1 or n % group != 0:
            run_group(init_state(cfg, seed, device), w_map, [l0, r0])
        _sync(device)
        del w_map

    state = init_state(cfg, seed, device)
    lmap = lm_mod.init_map(cfg.landmarks, device) if insert_landmarks else None
    hist = []  # FrameOutput per frame >= 1, on the device until the end
    t0 = time.perf_counter()
    i = 0
    while i < n:
        g = group if i + group <= n else 1  # single-frame tail
        dev_frames = []
        for k in range(g):
            dev_frames += [to_device(im, device) for im in seq.frame(i + k)]
        state, outs = run_group(state, lmap, dev_frames)
        hist += [out for k, out in enumerate(outs) if i + k > 0]  # all_poses starts at frame 2 (VO.m:133)
        i += g
    _sync(device)
    wall = time.perf_counter() - t0

    def stacked(field, empty_shape, dtype):
        if not hist:
            return np.zeros(empty_shape, dtype)
        return torch.stack([getattr(o, field) for o in hist]).cpu().numpy().astype(dtype)

    if lmap is not None:
        count = int(lmap.count)
        lms = lmap.xyz[:count].cpu().numpy()
    else:
        lms = np.zeros((0, 3), np.float32)
    return RunResult(
        poses=stacked("pose_c2w", (0, 4, 4), np.float32),
        rel_poses=stacked("rel_pose", (0, 4, 4), np.float32),
        n_inliers=stacked("n_inliers", (0,), np.int32),
        n_tracks=stacked("n_tracks", (0,), np.int32),
        pose_ok=stacked("pose_ok", (0,), bool),
        landmarks=lms,
        frames_per_sec=n / wall if wall > 0 else float("nan"),
        per_frame_ms=1000.0 * wall / max(n, 1),
    )
