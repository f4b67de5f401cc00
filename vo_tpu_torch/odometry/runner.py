"""Host-side sequence runner around the per-frame step (port of vo_tpu.odometry.runner).

The reference's outer ``for i = 1:n_frames`` (VO.m:64) on its deferred fast
path: ``cfg.fused_group`` frames per step with detection batched across them,
a single-frame step for the tail, frames staged on the device as uint8, and
the per-frame history (five fields per frame, stacked on the device every
``HISTORY_CHUNK`` frames, as the reference's ``_DeviceHistory``) read back
once at the end, so the host never waits on the device inside the loop.

On a CUDA device every step goes through the factories of odometry.pipeline
as a captured CUDA graph (utils.graphs; ``graph=False`` runs the eager step):
``make_fused_multi_step`` for the groups, ``make_fused_loop_step`` for the
tail, the per-frame host path and the refined path. Both share one graph
memory pool and are captured in the warm-up, on a throwaway state and map,
before the refiner's thread starts; the run's state and map then live in the
steps' static buffers, and every row the runner keeps of a step's outputs is
a copy, because the next replay overwrites them.

The refined path (``use_ba`` / ``use_loop_closure``) steps one frame at a
time and hands every ``cfg.ba.keyframe_every``-th frame to the background
refiner (odometry.refiner); with BA, the new keyframe's descriptors are first
matched on the device against every keyframe of the window (the runner's
descriptor ring). On a CUDA device that association, and the refiner's window
solve, verification round and global descriptor, are CUDA graphs too, each
with a pool of its own (``graph=False`` runs them eagerly; the refiner
captures its programs in its warm-up, this module the association after it).
The frame loop's only host waits are the refiner's ``throttle``, under a
mesh its ``submit`` (which waits for a window problem the worker has not
handed over yet), and the final synchronise. Corrections live in the worker's
frame, and the full trajectory is re-anchored onto the corrected keyframes
at the end (odometry.correction).

Precision (utils.precision): every name ``cfg.matmul_precision`` may hold is
float32 on the card, and the whole run is pinned to it, as the reference pins
a ``use_ba`` run. A ``use_loop_closure`` run is pinned whole too, which the
reference does not do: the TF32 flags are global to the process, so the
worker's solvers could not pin themselves without flipping the flags under
the frame loop's step. The caller's flags are restored when the run returns
or raises.

Any per-frame host consumer (``progress``, ``metrics_path``, periodic
checkpoints) takes the run off the deferred path: one frame per step, and the
frame's scalars are read each frame through ONE host copy, which makes the
host wait for the device once per frame. That wait is the documented cost of
these options. ``checkpoint_every`` dumps the resumable state
(odometry.checkpoint, the refiner's included) and ``resume`` restarts from
it; ``viz_every`` writes the reference's every-Nth-frame figures.

With ``mesh`` (dist.mesh.make_mesh) the run is SPMD: every rank of the mesh
calls ``run_sequence`` with the same arguments, keeps the same replicated
state and returns the same ``RunResult``. Detection is sharded over "data",
RANSAC hypotheses over "model", and with ``use_ba`` the window solve's
landmarks over "model" too; the frame loop's thread launches those solves
between its steps, at fixed keyframes, so that every rank issues the step's
and the solve's collectives in one order (odometry.refiner). Each rank
captures and replays its own graphs, program by program
(utils.graphs.wanted): with a card per rank (NCCL) the
step and the sharded solve too, their collectives inside them; where ranks
share a card (gloo) those two step and solve eagerly and the programs without
a collective (association, round, descriptor) are still graphs. Only rank 0
writes files (checkpoints, metrics, figures); ``resume`` loads the one
checkpoint on every rank.

Tracing (utils.profiling). A call checks once, at its entry, whether the
tracer is on (``profiling.tracing()``, or ``torch.profiler`` recording). Off,
the call's only profiler range is ``FRAME_LOOP`` and its graphs hold no stamp
node. On, it opens the spans named below (``CAPTURE``, ``FRAME_LOOP`` and in
it, per step, ``FETCH``, ``STEP`` and on the non-deferred path ``HOST_READ``
around ``HOST_COPY``, then ``READBACK``), each carrying its frame index, and
its steps write stage stamps on the device (odometry.pipeline) into a ring
read once after the loop: ``RunResult.trace``. ``RunResult.capture_s`` and
``readback_s`` are host clocks of every call.

What a call returns (``RunResult``): the frame loop's own rows as
``step_poses`` / ``step_rel_poses``; ``poses`` / ``rel_poses``, which are the
same arrays on the plain path and, on the refined path, those rows
re-anchored onto the refiner's corrected keyframes; and on the refined path
the refiner's records (``refine_log``, odometry.refiner.RefineLog).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import PipelineConfig
from ..dist.mesh import collective_backends
from ..frontend.match import match
from ..frontend.track import StereoFeatures
from ..utils import graphs
from ..utils.device import resolve
from ..utils.host_copy import HostCopy, upload
from ..utils.precision import matmul_precision
from ..utils.profiling import MetricsLog, StageStamps, Trace, call_tracing, pretty_frame, span
from . import landmarks as lm_mod
from . import checkpoint as ckpt_mod
from .correction import reanchor_trajectory, rebuild_rel_poses
from .pipeline import init_state, make_fused_loop_step, make_fused_multi_step, stage_columns


KITTI_DT = 0.10374  # mean frame period of kitti/00/times.txt (~9.6 Hz)
# The tracer's spans of a run_sequence call (utils.profiling; module docstring). FRAME_LOOP is a
# torch.profiler range in every call; the others exist only while the tracer is on.
CAPTURE = "vo_tpu_torch.capture"  # entry to the loop: factories, the steps' warm-up and capture, the refiner
FRAME_LOOP = "vo_tpu_torch.frame_loop"  # the timed loop
FETCH = "vo_tpu_torch.fetch"  # per step: seq.frame and to_device (a live camera's wait)
STEP = "vo_tpu_torch.step"  # per step: the copy-in and the graph's launch
HOST_READ = "vo_tpu_torch.host_read"  # per frame, non-deferred path: the host copy and host_frame
HOST_COPY = "vo_tpu_torch.host_copy"  # inside HOST_READ: the wait for the frame's HostCopy
READBACK = "vo_tpu_torch.readback"  # the final synchronise, the reads, the refiner's close, re-anchoring


@dataclasses.dataclass
class RunResult:
    poses: np.ndarray  # [T, 4, 4] world poses (frames 2..N like all_poses, VO.m:133); refined: re-anchored
    rel_poses: np.ndarray  # [T, 4, 4]
    n_inliers: np.ndarray  # [T]
    n_tracks: np.ndarray  # [T]
    pose_ok: np.ndarray  # [T] bool
    landmarks: np.ndarray  # [M, 3]
    frames_per_sec: float
    per_frame_ms: float
    refine_stats: dict = dataclasses.field(default_factory=dict)
    capture_s: float = 0.0  # host seconds from the call's entry to its frame loop (CAPTURE)
    readback_s: float = 0.0  # host seconds from the loop's end to the return (READBACK)
    trace: Optional[Trace] = None  # the call's spans and stage stamps while the tracer was on
    # The frame loop's rows before re-anchoring (run_sequence always gives them). A default factory
    # leaves no class attribute, so a deleted field reads as missing, as on a program without it.
    step_poses: Optional[np.ndarray] = dataclasses.field(default_factory=lambda: None)
    step_rel_poses: Optional[np.ndarray] = dataclasses.field(default_factory=lambda: None)
    refine_log: Optional[object] = None  # refined path: odometry.refiner.RefineLog, host arrays only


def step_group(cfg: PipelineConfig, *, deferred: bool, refined: bool, meshed: bool) -> int:
    """Frames a step of ``run_sequence`` takes (and detects together): ``cfg.fused_group`` on the
    deferred path, one where a per-frame host consumer takes the run off it (not ``deferred``),
    on the refined path (keyframes are handed over at exact frame boundaries) and under a mesh
    (its data axis shards one stereo pair). A tail shorter than a group steps frame by frame."""
    return cfg.fused_group if deferred and not refined and not meshed else 1


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
        self.times = getattr(seq, "times", None)
        self.frames = [tuple(to_device(im, device) for im in seq.frame(i)) for i in range(n)]

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int):
        return self.frames[i]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Keyframes:
    """The refined path's side of the frame loop: throttle, window association, submit.

    With BA, each new keyframe's descriptors are matched against every slot of a ring of the
    window's keyframes (``ring_desc`` [window, max_tracks, 128], ``ring_mask``) and then written
    into the slot at ``_pos`` (a device index), so that one program serves every slot: on a
    CUDA card (``graph``) a CUDA graph over the ring, the reference's ``jax.jit(kf_assoc)`` with
    its traced ``pos``, captured here (the refiner's thread is idle by then). The ring is the
    program's state: a resume copies into it.
    """

    def __init__(self, refiner, cfg: PipelineConfig, device, use_ba: bool, graph=None):
        """``graph`` as ``run_sequence``'s (utils.graphs.wanted)."""
        self.refiner = refiner
        self.cfg = cfg
        self.every = cfg.ba.keyframe_every
        self.use_ba = use_ba
        if use_ba:
            # Descriptor ring of the keyframes in the BA window: each new
            # keyframe is matched against every slot (ba_runner.WindowAssociator
            # explains why frame-level track ids are not enough).
            Kw, Cw = cfg.ba.window, cfg.max_tracks
            self.ring_desc = torch.zeros((Kw, Cw, 128), dtype=torch.float32, device=device)
            self.ring_mask = torch.zeros((Kw, Cw), dtype=torch.bool, device=device)
            self._pos = torch.zeros(1, dtype=torch.long, device=device)  # the slot the program writes
            self.slot = 0  # the same slot, on the host
            self._assoc = (
                graphs.StaticCall(
                    self._associate, (self.ring_desc[0], self.ring_mask[0]), device, "keyframe_association"
                )
                if graphs.wanted(graph, device)
                else self._associate
            )

    def checkpoint_state(self) -> Optional[dict]:
        """RefinerWorker.checkpoint_state + the runner-side associator ring."""
        p = self.refiner.checkpoint_state()
        if self.use_ba:
            ring_desc, ring_mask = HostCopy(self.ring_desc, self.ring_mask).numpy()
            p["runner_ring_desc"] = np.array(ring_desc)
            p["runner_ring_mask"] = np.array(ring_mask)
            p["runner_assoc_slot"] = np.asarray(self.slot, np.int64)
        return p

    def restore_state(self, p: dict) -> None:
        self.refiner.restore_state(p)
        if self.use_ba and "runner_ring_desc" in p:
            # The descriptor ring feeding the window associator is part of the
            # resumable state: a zero ring would mis-associate the first resumed window.
            # Copied into the ring the association program reads, never rebound.
            dev = self.ring_desc.device
            self.ring_desc.copy_(upload(torch.from_numpy(np.array(p["runner_ring_desc"], np.float32)), dev))
            self.ring_mask.copy_(upload(torch.from_numpy(np.array(p["runner_ring_mask"], bool)), dev))
            self.slot = int(p["runner_assoc_slot"])

    def is_keyframe(self, i: int) -> bool:
        return i > 0 and i % self.every == 0

    def throttle(self) -> None:
        # Bounded lag: block only if the worker is > 2 keyframes behind.
        with span("vo_tpu_torch.refiner.throttle", total=self.refiner.main_wait_s):
            self.refiner.throttle(max_lag=2)

    @matmul_precision("float32")
    def _associate(self, desc: torch.Tensor, mask: torch.Tensor):
        """The association program: match the new keyframe against every ring slot, then write it
        into slot ``_pos`` -> (a, b, ok), each [window, max_tracks]."""
        Cw = self.cfg.max_tracks
        ms = [match(desc, mask, d, m, self.cfg.matcher, Cw) for d, m in zip(self.ring_desc, self.ring_mask)]
        self.ring_desc.index_copy_(0, self._pos, desc[None])
        self.ring_mask.index_copy_(0, self._pos, mask[None])
        return torch.stack([m.a_idx for m in ms]), torch.stack([m.b_idx for m in ms]), torch.stack([m.mask for m in ms])

    def associate(self, desc: torch.Tensor, mask: torch.Tensor):
        """The new keyframe against the window, then into the next slot -> (slot, a, b, ok)."""
        slot = self.slot
        self._pos.fill_(slot)
        a, b, ok = self._assoc(desc, mask)
        self.slot = (slot + 1) % self.ring_desc.shape[0]
        return slot, a, b, ok

    def submit(self, i: int, state, out, query) -> None:
        # state.prev now holds THIS frame's stereo features + track ids. The job keeps device
        # tensors that the worker reads later, on its own stream, and a captured step's next
        # replay overwrites its static buffers: the refiner gets copies, made on this stream.
        # (The pose and the association's outputs reach it only through host copies started
        # at submit, which hold their values as of now.)
        prev = StereoFeatures(*(t.clone() for t in state.prev))
        query = tuple(t.clone() for t in query) if query is not None else None
        assoc = self.associate(prev.l_desc, prev.mask) if self.use_ba else None
        self.refiner.submit(i, out.pose_c2w, prev, assoc=assoc, query=query)


def _dt_at(seq, i: int) -> float:
    times = getattr(seq, "times", None)
    if times is not None and i > 0 and i < len(times):
        return float(times[i] - times[i - 1])
    return KITTI_DT


def _host_image(img) -> np.ndarray:
    """A frame as float [H, W] in [0, 1] on the host (for the figures)."""
    a = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    return a.astype(np.float32) / 255.0 if a.dtype == np.uint8 else a


_HIST_FIELDS = ("pose_c2w", "rel_pose", "n_inliers", "n_tracks", "pose_ok")
HISTORY_CHUNK = 128  # device rows stacked into one chunk (the reference's _DeviceHistory chunk)


class _History:
    """Per-frame rows (frames >= 1) of a run: rows already on the host (from a checkpoint, or
    read frame by frame on the non-deferred path) followed by rows still on the device.

    A device row keeps copies of the five ``_HIST_FIELDS`` tensors of a frame (a captured step's
    next replay overwrites its outputs), never its whole FrameOutput (whose track arrays are most
    of its bytes), and every ``chunk`` rows are stacked on the device. Nothing here waits for the
    device until ``stacked``, which reads everything to the host at once and is safe to call
    mid-run (it closes a partial chunk).
    """

    def __init__(self, chunk: int = HISTORY_CHUNK):
        self.chunk = chunk
        self.host: dict = {f: [] for f in _HIST_FIELDS}
        self._pending: list = []  # rows not yet stacked: tuples of the five tensors
        self._chunks: list = []  # the five fields stacked on the device, one tuple per chunk

    def extend_host(self, **rows) -> None:
        for f, r in rows.items():
            self.host[f] += list(r)

    def append(self, out) -> None:
        """Keep copies of frame output ``out``'s five history fields (device tensors)."""
        self._pending.append(tuple(getattr(out, f).clone() for f in _HIST_FIELDS))
        if len(self._pending) >= self.chunk:
            self._flush()

    def _flush(self) -> None:
        if self._pending:
            self._chunks.append(tuple(torch.stack(col) for col in zip(*self._pending)))
            self._pending = []

    def stacked(self) -> dict:
        """{field: np.ndarray over all rows}; waits for the device where rows are still there."""
        dtypes = dict(pose_c2w=np.float32, rel_pose=np.float32, n_inliers=np.int32, n_tracks=np.int32, pose_ok=bool)
        empty = dict(pose_c2w=(0, 4, 4), rel_pose=(0, 4, 4), n_inliers=(0,), n_tracks=(0,), pose_ok=(0,))
        self._flush()
        out = {}
        for k, f in enumerate(_HIST_FIELDS):
            parts = []
            if self.host[f]:
                parts.append(np.asarray(self.host[f], dtypes[f]))
            if self._chunks:
                parts.append(torch.cat([c[k] for c in self._chunks]).cpu().numpy().astype(dtypes[f]))
            out[f] = np.concatenate(parts) if parts else np.zeros(empty[f], dtypes[f])
        return out


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
    graph: Optional[bool] = None,
) -> RunResult:
    """Run VO over ``seq`` (``frame(i) -> (left, right)``, ``calib``, ``len``) on ``device``
    (None: the current CUDA device; the CPU only when asked, ``device="cpu"``).

    ``insert_landmarks`` defaults to cfg.view_3d (the reference's single flag,
    VO.m:6/145). Frames may be numpy images or tensors already on the device.
    ``use_ba`` / ``use_loop_closure`` run the refined path (module docstring).
    With ``checkpoint_every > 0`` the resumable state is dumped to
    ``checkpoint_path`` periodically; ``resume=True`` restarts from it (on the
    kind of device that wrote it). ``progress(i, dict)`` and ``metrics_path``
    (one JSONL row per frame) read every frame's scalars on the host.
    ``viz_every > 0`` prints the reference's console block every N-th frame and,
    with ``viz_dir``, writes ``viz_dir``/<i>/{view,map,error,3d_map}.png
    (VO.m:168-204, 261-277; needs matplotlib). ``verbose`` is accepted for the
    reference's call sites and unused, as there. ``mesh`` routes the step through
    the dist layer (module docstring); every rank of the mesh makes this call.
    The run is in float32 whatever ``cfg.matmul_precision`` names (module
    docstring); an unknown name raises ``ValueError``. ``graph`` (utils.graphs):
    None steps (and, on the refined path, associates, solves and verifies)
    through CUDA graphs on a CUDA device and eagerly on the CPU, False runs all
    of it eagerly, True on the CPU raises; under a mesh each program is
    captured unless it issues a collective over gloo (module docstring; with
    ``graph=True`` such a program raises).
    """
    t_call = time.perf_counter()
    # ``phase`` holds the open one of the spans CAPTURE and READBACK.
    with matmul_precision(cfg.matmul_precision), call_tracing() as tracer, contextlib.ExitStack() as phase:
        first_span = len(tracer.rows) if tracer is not None else 0
        phase.enter_context(span(CAPTURE))
        device = resolve(device)
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh (dist.mesh.make_mesh), not {type(mesh).__name__}")
        # Under a mesh every rank computes everything and rank 0 alone writes files.
        writer = mesh is None or dist.get_rank() == 0
        calib = seq.calib.to(device)
        if insert_landmarks is None:
            insert_landmarks = cfg.view_3d
        n = len(seq) if n_frames is None else min(n_frames, len(seq))
        refined = use_ba or use_loop_closure
        checkpointing = bool(checkpoint_every and checkpoint_path)
        # Deferred path: no per-frame host consumer, so the history stays on the
        # device and the host never waits inside the loop. Refinement stays on it
        # (the worker owns its host copies); progress / metrics / checkpoints need
        # per-frame host values.
        deferred = not (progress is not None or metrics_path is not None or checkpointing)
        group = step_group(cfg, deferred=deferred, refined=refined, meshed=mesh is not None)

        # With the tracer on, the steps write stage stamps into a ring of a row per step (pipeline).
        stamps = StageStamps(n, len(stage_columns(group)), device) if tracer is not None else None
        # One graph memory pool for both steps: the groups replay first, the single-frame tail after.
        captured = graphs.wanted(graph, device, collective_backends(mesh))
        pool = graphs.Pool(device) if captured else None
        step1 = make_fused_loop_step(
            calib, cfg, with_landmarks=insert_landmarks, mesh=mesh, with_query_feats=use_loop_closure, graph=graph,
            pool=pool, stamps=stamps,
        )
        stepN = (
            make_fused_multi_step(
                calib, cfg, with_landmarks=insert_landmarks, group=group, graph=graph, pool=pool, stamps=stamps
            )
            if group > 1
            else None
        )

        def run_group(state, lmap, dev_frames):
            """One step over ``dev_frames`` (l0, r0, ...) -> (state, lmap, outs, query)."""
            if len(dev_frames) == 2:
                r = step1(state, lmap, *dev_frames)
                return r[0], r[1], [r[2]], r[3] if use_loop_closure else None
            state, lmap, *outs = stepN(state, lmap, *dev_frames)
            return state, lmap, outs, None

        state = init_state(cfg, seed, device)
        lmap = lm_mod.init_map(cfg.landmarks, device) if insert_landmarks else None
        hist = _History(HISTORY_CHUNK)
        start_frame = 0
        resumed_refiner_state = None
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            ck = ckpt_mod.load(checkpoint_path, device)
            state, start_frame = ck.state, ck.frame_idx
            if ck.lmap is not None:
                lmap = ck.lmap
            rows = len(ck.poses)
            # Real per-frame stats (v2 checkpoints); zero-fill only for v1.
            hist.extend_host(
                pose_c2w=ck.poses,
                rel_pose=ck.rel_poses,
                n_inliers=ck.n_inliers if ck.n_inliers is not None else [0] * rows,
                n_tracks=ck.n_tracks if ck.n_tracks is not None else [0] * rows,
                pose_ok=ck.pose_ok if ck.pose_ok is not None else [True] * rows,
            )
            resumed_refiner_state = ck.refiner

        if warmup or captured:
            # Throwaway state and map: first-use costs (kernel build, library
            # handles, allocator growth, under a mesh the first collectives of
            # every rank) and the steps' capture land here, outside the timed
            # loop and before the refiner's thread starts.
            l0, r0 = (to_device(im, device) for im in seq.frame(0))
            w_map = lm_mod.init_map(cfg.landmarks, device) if insert_landmarks else None
            if group > 1:
                run_group(init_state(cfg, seed, device), w_map, [l0, r0] * group)
            if group == 1 or (n - start_frame) % group != 0:
                run_group(init_state(cfg, seed, device), w_map, [l0, r0])
            _sync(device)
            del w_map

        refiner = kfs = None
        if refined:
            from .refiner import RefinerWorker

            # Constructed before the timed loop: its solver and verification
            # warm-ups run here.
            refiner = RefinerWorker(
                seq.calib, cfg, use_ba=use_ba, use_loop_closure=use_loop_closure, device=device, mesh=mesh, graph=graph
            )
            kfs = _Keyframes(refiner, cfg, device, use_ba, graph=graph)
            if resumed_refiner_state is not None:
                # Bit-exact resume of refined runs: ledgers, archive, loop edges,
                # in-flight rounds, associator rings.
                kfs.restore_state(resumed_refiner_state)

        mlog = MetricsLog(metrics_path) if metrics_path and writer else None
        gt_poses = getattr(seq, "gt_poses", None)
        if not writer:
            viz_every = 0
        if viz_every and viz_dir:
            os.makedirs(viz_dir, exist_ok=True)

        def live_viz(i, out, left):
            # The reference's live telemetry: every-Nth-frame figures and console
            # block (VO.m:168-204, 261-277). A deliberate wait for the device,
            # amortized over viz_every frames like the reference's mod(i,100).
            names = ("pose_c2w", "rel_pose", "tracked_cur_px", "tracked_old_px", "tracked_disp_3d", "tracked_mask")
            h = dict(zip(names, HostCopy(*(getattr(out, k) for k in names)).numpy()))
            print(pretty_frame(i, h["rel_pose"], h["pose_c2w"], _dt_at(seq, i)))
            if not viz_dir:
                return
            from ..viz import figures

            poses_so_far = hist.stacked()["pose_c2w"]
            if len(poses_so_far) == 0:
                poses_so_far = h["pose_c2w"][None]
            lms = lmap.xyz[: int(lmap.count)].cpu().numpy() if lmap is not None else None
            figures.frame_report(
                viz_dir, i, _host_image(left), h, poses_so_far,
                np.asarray(gt_poses) if gt_poses is not None else None,
                times=getattr(seq, "times", None), landmarks=lms,
            )

        def host_frame(i, out, state, t_frame):
            """The non-deferred path's per-frame work: one host copy of the frame's scalars, then
            whoever asked for them."""
            fields = _HIST_FIELDS + (("mean_reproj_err",) if mlog is not None else ())
            with span(HOST_COPY, frame=i):
                h = dict(zip(fields, HostCopy(*(getattr(out, f) for f in fields)).numpy()))
            n_tr, n_in, ok = int(h["n_tracks"]), int(h["n_inliers"]), bool(h["pose_ok"])
            if i > 0:  # all_poses starts at frame 2 (VO.m:133)
                hist.extend_host(
                    pose_c2w=[np.array(h["pose_c2w"])], rel_pose=[np.array(h["rel_pose"])],
                    n_inliers=[n_in], n_tracks=[n_tr], pose_ok=[ok],
                )
            if progress is not None:
                progress(i, dict(n_tracks=n_tr, n_inliers=n_in, pose_ok=ok))
            if mlog is not None:
                mlog.log(
                    i,
                    n_tracks=n_tr,
                    n_inliers=n_in,
                    inlier_ratio=round(n_in / max(n_tr, 1), 4),
                    pose_ok=ok,
                    mean_reproj_err=float(h["mean_reproj_err"]),
                    frame_ms=round(1000.0 * (time.perf_counter() - t_frame), 2),
                )
            if checkpointing and (i + 1) % checkpoint_every == 0:
                # Every rank drains its worker here (the drain runs the staged window solves,
                # whose collectives need every rank's worker); the writer alone saves.
                refiner_state = kfs.checkpoint_state() if kfs is not None else None
                if writer:
                    rows = hist.stacked()
                    ckpt_mod.save(
                        checkpoint_path, state, lmap, rows["pose_c2w"], rows["rel_pose"], i + 1,
                        stats=(rows["n_inliers"], rows["n_tracks"], rows["pose_ok"]),
                        refiner_state=refiner_state,
                    )

        if stamps is not None:
            stamps.start()  # the ring emptied, and the first clock anchor
        phase.close()
        t0 = time.perf_counter()
        i = start_frame
        # The span lets a profile read the frame loop apart from the warm-up and capture before it.
        with span(FRAME_LOOP) if tracer is not None else torch.profiler.record_function(FRAME_LOOP):
            while i < n:
                t_frame = time.perf_counter()
                g = group if i + group <= n else 1  # single-frame tail
                with span(FETCH, frame=i):
                    host_frames = [seq.frame(i + k) for k in range(g)]
                    dev_frames = [to_device(im, device) for lr in host_frames for im in lr]
                key = kfs is not None and kfs.is_keyframe(i)
                if key:
                    kfs.throttle()
                if stamps is not None:
                    stamps.replays.append((tuple(range(i, i + g)), stage_columns(g)))
                with span(STEP, frame=i):
                    state, lmap, outs, query = run_group(state, lmap, dev_frames)
                if key:
                    kfs.submit(i, state, outs[0], query)
                for k, out in enumerate(outs):
                    j = i + k
                    if not deferred:
                        with span(HOST_READ, frame=j):
                            host_frame(j, out, state, t_frame)
                    elif j > 0:  # all_poses starts at frame 2 (VO.m:133)
                        hist.append(out)
                    if viz_every and j > 0 and j % viz_every == 0:
                        live_viz(j, out, host_frames[k][0])
                i += g
        t_loop = time.perf_counter()
        phase.enter_context(span(READBACK))
        _sync(device)
        wall = time.perf_counter() - t0
        if mlog is not None:
            mlog.close()

        rows = hist.stacked()
        poses, rels = rows["pose_c2w"], rows["rel_pose"]
        refine_stats: dict = {}
        refine_log = None
        if refiner is not None:
            refiner.close()
            refine_stats = dict(refiner.stats)
            refine_stats["main_wait_s"] = round(sum(refiner.main_wait_s.values()), 3)
            kf_idx, kf_poses = refiner.corrected_keyframes()
            # History row for frame i is i-1 (all_poses convention, VO.m:133).
            kf_rows = kf_idx - 1
            keep = (kf_rows >= 0) & (kf_rows < poses.shape[0])
            if keep.any():
                poses = reanchor_trajectory(poses, kf_rows[keep], kf_poses[keep])
                rels = rebuild_rel_poses(poses)
            refine_stats["n_keyframes"] = int(kf_idx.size)
            refine_log = refiner.refine_log()

        if lmap is not None:
            lms = lmap.xyz[: int(lmap.count)].cpu().numpy()
        else:
            lms = np.zeros((0, 3), np.float32)
        n_run = n - start_frame
        result = RunResult(
            poses=poses,
            rel_poses=rels,
            n_inliers=rows["n_inliers"],
            n_tracks=rows["n_tracks"],
            pose_ok=rows["pose_ok"],
            landmarks=lms,
            frames_per_sec=n_run / wall if wall > 0 else float("nan"),
            per_frame_ms=1000.0 * wall / max(n_run, 1),
            refine_stats=refine_stats,
            step_poses=rows["pose_c2w"],
            step_rel_poses=rows["rel_pose"],
            refine_log=refine_log,
        )
        if stamps is not None:
            stamps.read()
        phase.close()
        result.capture_s, result.readback_s = t0 - t_call, time.perf_counter() - t_loop
        if tracer is not None:
            result.trace = tracer.collect(first_span, stamps)
        return result


def save_result(result: RunResult, out_dir: str) -> None:
    """npz persistence replacing poses.mat / error.mat / landmarks.mat (VO.m:247-253)."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, "trajectory.npz"),
        poses=result.poses,
        rel_poses=result.rel_poses,
        n_inliers=result.n_inliers,
        n_tracks=result.n_tracks,
        pose_ok=result.pose_ok,
    )
    np.savez_compressed(os.path.join(out_dir, "landmarks.npz"), landmarks=result.landmarks)
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(
            dict(
                frames_per_sec=result.frames_per_sec,
                per_frame_ms=result.per_frame_ms,
                n_frames=int(result.poses.shape[0]) + 1,
                **{f"refine_{k}": v for k, v in result.refine_stats.items()},
            ),
            f,
            indent=2,
        )
