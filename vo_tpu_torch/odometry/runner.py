"""Host-side sequence runner around the per-frame step (port of vo_tpu.odometry.runner).

The reference's outer ``for i = 1:n_frames`` (VO.m:64) on its deferred fast
path: ``cfg.fused_group`` frames per step with detection batched across them,
a single-frame step for the tail, frames staged on the device as uint8, and
the per-frame history kept as device tensors and read back once at the end,
so the host never waits on the device inside the loop.

The refined path (``use_ba`` / ``use_loop_closure``) steps one frame at a
time and hands every ``cfg.ba.keyframe_every``-th frame to the background
refiner (odometry.refiner); with BA, the new keyframe's descriptors are first
matched on the device against every keyframe of the window (the runner's
descriptor ring). The frame loop's only host waits are the refiner's
``throttle`` and the final synchronise. Corrections live in the worker's
frame, and the full trajectory is re-anchored onto the corrected keyframes
at the end (odometry.correction). The port's step is float32 end to end, so
unlike the reference on a TPU (which pins float32 only when BA is on), its
refined and plain paths see the same detection stream.

Not ported yet: the device mesh, checkpoint/resume, per-frame
progress/metrics callbacks and the live figures. Each raises
``NotImplementedError`` when asked for.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..frontend.match import match
from ..utils.device import resolve
from ..utils.host_copy import upload
from . import landmarks as lm_mod
from .correction import reanchor_trajectory, rebuild_rel_poses
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
    refine_stats: dict = dataclasses.field(default_factory=dict)


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
    return upload(torch.from_numpy(a), device)


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


class _Keyframes:
    """The refined path's side of the frame loop: throttle, window association, submit."""

    def __init__(self, refiner, cfg: PipelineConfig, device, use_ba: bool):
        self.refiner = refiner
        self.cfg = cfg
        self.every = cfg.ba.keyframe_every
        self.wait_s = 0.0  # main-thread time blocked on the refiner
        self.use_ba = use_ba
        if use_ba:
            # Descriptor ring of the keyframes in the BA window: each new
            # keyframe is matched against every slot (ba_runner.WindowAssociator
            # explains why frame-level track ids are not enough).
            Kw, Cw = cfg.ba.window, cfg.max_tracks
            self.ring_desc = torch.zeros((Kw, Cw, 128), dtype=torch.float32, device=device)
            self.ring_mask = torch.zeros((Kw, Cw), dtype=torch.bool, device=device)
            self.slot = 0

    def is_keyframe(self, i: int) -> bool:
        return i > 0 and i % self.every == 0

    def throttle(self) -> None:
        # Bounded lag: block only if the worker is > 2 keyframes behind.
        t = time.perf_counter()
        self.refiner.throttle(max_lag=2)
        self.wait_s += time.perf_counter() - t

    def _associate(self, desc: torch.Tensor, mask: torch.Tensor):
        """Match the new keyframe against every ring slot, then take a slot for it -> (slot, a, b, ok)."""
        Cw = self.cfg.max_tracks
        ms = [match(desc, mask, d, m, self.cfg.matcher, Cw) for d, m in zip(self.ring_desc, self.ring_mask)]
        slot = self.slot
        self.ring_desc[slot] = desc
        self.ring_mask[slot] = mask
        self.slot = (slot + 1) % self.ring_desc.shape[0]
        return slot, torch.stack([m.a_idx for m in ms]), torch.stack([m.b_idx for m in ms]), torch.stack([m.mask for m in ms])

    def submit(self, i: int, state, out, query) -> None:
        # state.prev now holds THIS frame's stereo features + track ids.
        assoc = self._associate(state.prev.l_desc, state.prev.mask) if self.use_ba else None
        self.refiner.submit(i, out.pose_c2w, state.prev, assoc=assoc, query=query)


def _frame_loop(seq, n: int, group: int, device, state, lmap, run_group, kfs: Optional[_Keyframes]):
    """Every frame through the step; returns (state, [FrameOutput for frames >= 1])."""
    hist = []
    i = 0
    while i < n:
        g = group if i + group <= n else 1  # single-frame tail
        dev_frames = []
        for k in range(g):
            dev_frames += [to_device(im, device) for im in seq.frame(i + k)]
        key = kfs is not None and kfs.is_keyframe(i)
        if key:
            kfs.throttle()
        state, outs, query = run_group(state, lmap, dev_frames)
        if key:
            kfs.submit(i, state, outs[0], query)
        hist += [out for k, out in enumerate(outs) if i + k > 0]  # all_poses starts at frame 2 (VO.m:133)
        i += g
    return state, hist


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
    verbose: bool = False,
    mesh=None,
    device=None,
) -> RunResult:
    """Run VO over ``seq`` (``frame(i) -> (left, right)``, ``calib``, ``len``) on ``device``
    (None: the current CUDA device; the CPU only when asked, ``device="cpu"``).

    ``insert_landmarks`` defaults to cfg.view_3d (the reference's single flag,
    VO.m:6/145). Frames may be numpy images or tensors already on the device.
    ``use_ba`` / ``use_loop_closure`` run the refined path (module docstring);
    ``verbose`` is accepted for the reference's call sites and unused, as there.
    """
    _unsupported(
        progress=progress is not None,
        checkpoint=bool(checkpoint_path) or checkpoint_every > 0 or resume,
        metrics_path=metrics_path is not None,
        viz=viz_every > 0 or viz_dir is not None,
        mesh=mesh is not None,
    )
    device = resolve(device)
    # Full float32 everywhere: the geometry needs it (ransac module docstring),
    # and reduced precision in the pyramid flickers detections.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    calib = seq.calib.to(device)
    if insert_landmarks is None:
        insert_landmarks = cfg.view_3d
    n = len(seq) if n_frames is None else min(n_frames, len(seq))
    refined = use_ba or use_loop_closure
    # The refined path steps frame by frame: keyframe submission needs
    # state.prev at exact keyframe boundaries.
    group = 1 if refined else cfg.fused_group

    def run_group(state, lmap, dev_frames):
        query = None
        if len(dev_frames) == 2:
            r = vo_step(state, dev_frames[0], dev_frames[1], calib, cfg, return_feats=use_loop_closure)
            state, outs = r[0], [r[1]]
            query = r[2] if use_loop_closure else None
        else:
            state, outs = vo_step_multi(state, dev_frames, calib, cfg)
        if lmap is not None:
            for out in outs:
                lm_mod.insert(lmap, out.new_lm_l_px, out.new_lm_r_px, out.new_lm_mask, out.pose_c2w, calib, cfg.landmarks)
        return state, outs, query

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

    refiner = kfs = None
    if refined:
        from .refiner import RefinerWorker

        # Constructed before the timed loop: its solver and verification
        # warm-ups run here.
        refiner = RefinerWorker(seq.calib, cfg, use_ba=use_ba, use_loop_closure=use_loop_closure, device=device)
        kfs = _Keyframes(refiner, cfg, device, use_ba)

    state = init_state(cfg, seed, device)
    lmap = lm_mod.init_map(cfg.landmarks, device) if insert_landmarks else None
    t0 = time.perf_counter()
    state, hist = _frame_loop(seq, n, group, device, state, lmap, run_group, kfs)
    _sync(device)
    wall = time.perf_counter() - t0

    def stacked(field, empty_shape, dtype):
        if not hist:
            return np.zeros(empty_shape, dtype)
        return torch.stack([getattr(o, field) for o in hist]).cpu().numpy().astype(dtype)

    poses = stacked("pose_c2w", (0, 4, 4), np.float32)
    rels = stacked("rel_pose", (0, 4, 4), np.float32)
    refine_stats: dict = {}
    if refiner is not None:
        refiner.close()
        refine_stats = dict(refiner.stats)
        refine_stats["main_wait_s"] = round(kfs.wait_s, 3)
        kf_idx, kf_poses = refiner.corrected_keyframes()
        # History row for frame i is i-1 (all_poses convention, VO.m:133).
        rows = kf_idx - 1
        keep = (rows >= 0) & (rows < poses.shape[0])
        if keep.any():
            poses = reanchor_trajectory(poses, rows[keep], kf_poses[keep])
            rels = rebuild_rel_poses(poses)
        refine_stats["n_keyframes"] = int(kf_idx.size)

    if lmap is not None:
        count = int(lmap.count)
        lms = lmap.xyz[:count].cpu().numpy()
    else:
        lms = np.zeros((0, 3), np.float32)
    return RunResult(
        poses=poses,
        rel_poses=rels,
        n_inliers=stacked("n_inliers", (0,), np.int32),
        n_tracks=stacked("n_tracks", (0,), np.int32),
        pose_ok=stacked("pose_ok", (0,), bool),
        landmarks=lms,
        frames_per_sec=n / wall if wall > 0 else float("nan"),
        per_frame_ms=1000.0 * wall / max(n, 1),
        refine_stats=refine_stats,
    )
