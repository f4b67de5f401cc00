"""Background keyframe refiner: BA + loop closure OFF the frame critical path
(port of vo_tpu.odometry.refiner, without checkpoint/resume).

The frame loop only submits keyframes: ``submit`` starts the keyframe
payload's copies to pinned host memory (utils.host_copy), records a CUDA
event after them, and enqueues the job. One worker thread consumes the jobs
in FIFO order, two keyframes late (see ``_run``), and is the only thread
that waits on the device for refinement results.

CORRECTIONS NEVER TOUCH THE LIVE CHAIN. The worker keeps a cumulative
world-frame correction ``D`` and maps each incoming chain pose into its own
corrected frame (pose_corr = D @ pose_chain); the live loop stays pure VO,
while corrected keyframe poses drive loop-closure decisions and the
end-of-run re-anchoring of the full trajectory (odometry.correction). The
result is therefore the same whatever the threads' timing.

On a CUDA device the worker's own device work (window solves, loop
verification) runs on its own stream, which waits on the event recorded
at ``submit``; the frame loop's tensors it reads are marked with
``record_stream`` so that the caching allocator does not hand their memory
back to the frame loop early. A worker error reaches the main thread at
its next ``throttle``, ``wait_pending`` or ``close``.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..geom.camera import StereoCalib
from ..utils.host_copy import HostCopy


class _KeyframeJob:
    """Device tensors captured at a keyframe boundary, with their host copies in flight."""

    __slots__ = ("frame_idx", "l_xy", "r_xy", "l_desc", "mask", "slot", "query", "host")

    def __init__(self, frame_idx, l_xy, r_xy, l_desc, mask, slot=None, query=None, host=None):
        self.frame_idx = frame_idx
        self.l_xy = l_xy
        self.r_xy = r_xy
        self.l_desc = l_desc
        self.mask = mask
        # Ring slot of the runner's keyframe associator (None when BA is off);
        # its match payload travels in ``host``.
        self.slot = slot
        # (xy, desc, mask) device tensors of the keyframe's FULL detection set:
        # the loop-closure verification query side (never host-copied).
        self.query = query
        # (names, HostCopy): pose, global descriptor, and with BA the stereo
        # payload (l_xy, r_xy, mask, ids) and the associator's (a, b, ok).
        self.host = host


_WARMUP = object()  # queue sentinel: run the warm-up on the worker thread


def global_desc(desc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """On-device [128] global descriptor (mirror of slam.loop_closure._global_desc)."""
    mf = mask.to(torch.float32)[:, None]
    s = (desc * mf).sum(0) / torch.clamp(mf.sum(), min=1.0)
    n = torch.linalg.vector_norm(s)
    return torch.where(n > 1e-12, s / n, s)


def propagate_closure(
    kf_order: list[int],
    kf_corrected: dict[int, np.ndarray],
    kf_chain: dict[int, np.ndarray],
    surv: dict[int, np.ndarray],
) -> tuple[np.ndarray, dict[int, np.ndarray]]:
    """Apply a loop closure's corrected keyframe poses to the FULL ledger.

    ``surv`` maps frame_idx -> post-closure pose for keyframes still in the
    LoopCloser archive. Keyframes decimated out of the archive get the rigid
    delta of their nearest surviving neighbor (by frame index) so every
    anchor moves coherently; leaving them stale made reanchor_trajectory
    alternate between pre- and post-closure anchors, zigzagging segments by
    the full closure correction (ADVICE r3 high). Deltas are computed
    against the CHAIN ledger (loop-corrected, BA-free) and applied ON TOP
    of the corrected ledger for EVERY keyframe — survivors included — so a
    keyframe's window-BA offset rides through the closure instead of being
    wiped for survivors but kept for their decimated neighbors (which would
    leave adjacent anchors inconsistent by the BA-offset scale). The chain
    ledger itself adopts the survivor poses / deltas exactly. Returns
    (sorted survivor indices, delta dict)."""
    deltas = {
        fi: surv[fi].astype(np.float64) @ np.linalg.inv(kf_chain[fi].astype(np.float64))
        for fi in surv
        if fi in kf_chain
    }
    surv_sorted = np.array(sorted(deltas.keys()), np.int64)
    for fi in kf_order:
        if fi in surv:
            d = deltas[fi]
            kf_corrected[fi] = (d @ kf_corrected[fi].astype(np.float64)).astype(np.float32)
            kf_chain[fi] = surv[fi].astype(np.float32)
        elif surv_sorted.size:
            d = deltas[int(surv_sorted[np.argmin(np.abs(surv_sorted - fi))])]
            kf_corrected[fi] = (d @ kf_corrected[fi].astype(np.float64)).astype(np.float32)
            kf_chain[fi] = (d @ kf_chain[fi].astype(np.float64)).astype(np.float32)
    return surv_sorted, deltas


class RefinerWorker:
    """Owns BA + loop closure on a worker thread; the main thread never waits on the device
    for refinement."""

    def __init__(
        self,
        calib: StereoCalib,
        cfg: PipelineConfig,
        use_ba: bool,
        use_loop_closure: bool,
        device="cpu",
    ):
        self.calib = calib
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.wba = None
        self.lclo = None
        self.associator = None
        if use_ba:
            from .ba_runner import WindowAssociator, WindowedBA

            self.wba = WindowedBA(calib, cfg.ba, device=self.device)
            self.associator = WindowAssociator(cfg.ba.window)
        if use_loop_closure:
            from ..slam.loop_closure import LoopCloser

            self.lclo = LoopCloser(calib, cfg.loop, matcher=cfg.matcher, device=self.device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # frame_idx -> latest corrected [4,4] pose (worker-owned, lock-guarded)
        self._kf_corrected: dict[int, np.ndarray] = {}
        # frame_idx -> loop-corrected CHAIN pose (excludes window-BA deltas).
        # Closure deltas are computed against this ledger so keyframes the
        # LoopCloser has DECIMATED out of its archive still ride along with
        # their nearest surviving neighbor instead of keeping stale poses.
        self._kf_chain: dict[int, np.ndarray] = {}
        self._kf_order: list[int] = []
        # Cumulative rigid correction mapping live-chain poses into the
        # worker's corrected frame (worker-thread only; no lock needed).
        self._D = np.eye(4, dtype=np.float64)
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self._loops_closed = 0
        self._ba_solves = 0
        self._phase_s: defaultdict = defaultdict(float)  # worker-phase seconds
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        # The warm-up (solver and verification once on the production shapes)
        # runs as the worker's first job, so that its first-use costs, the
        # worker thread's own library handles included, land before the
        # caller's timed loop.
        self._q.put(_WARMUP)
        self.wait_pending()

    def _warmup(self) -> None:
        if self.wba is not None:
            self.wba.warmup()
        if self.lclo is not None:
            self.lclo.warmup(self.cfg.max_tracks, self.cfg.sift.max_keypoints)

    # -- main-thread API ------------------------------------------------------

    def submit(self, frame_idx: int, pose_dev, prev_feats, assoc=None, query=None) -> None:
        """Enqueue a keyframe. ``pose_dev``/``prev_feats`` are device tensors; their host
        copies start here, so the worker's read is a wait for copies already under way.
        ``assoc`` is the (slot, a_idx, b_idx, ok) window-match payload (device tensors);
        ``query`` the (xy, desc, mask) full-detection tensors for the loop-closure
        verification query side and the global descriptor."""
        names = ["pose"]
        arrs = [pose_dev]
        if self.lclo is not None:
            # Global descriptor over the FULL detection set when available
            # (a far larger revisit/unrelated margin than the stereo subset's).
            gd, gm = (query[1], query[2]) if query is not None else (prev_feats.l_desc, prev_feats.mask)
            names.append("gdesc")
            arrs.append(global_desc(gd, gm))
        if self.wba is not None:  # window assembly runs on the host
            names += ["l_xy", "r_xy", "mask", "ids"]
            arrs += [prev_feats.l_xy, prev_feats.r_xy, prev_feats.mask, prev_feats.ids]
            if assoc is not None:
                names += ["m_a", "m_b", "m_ok"]
                arrs += list(assoc[1:])
        job = _KeyframeJob(
            frame_idx,
            prev_feats.l_xy,
            prev_feats.r_xy,
            prev_feats.l_desc if self.lclo is not None else None,
            prev_feats.mask,
            slot=None if assoc is None else assoc[0],
            query=query if self.lclo is not None else None,
            host=(names, HostCopy(*arrs)),
        )
        self._q.put(job)

    def wait_pending(self) -> None:
        """Block until the worker has consumed every submitted job. NB: the
        newest job may still be STAGED (processed on the next submit or at
        close() — see _run); only close() guarantees full processing."""
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def throttle(self, max_lag: int = 2) -> None:
        """Block only while more than ``max_lag`` submitted jobs are pending.

        Corrections never feed back into the live chain (worker-frame
        design, module docstring), and the worker consumes its queue in FIFO
        order on one thread — so the final trajectory is bit-identical
        whatever the main thread's timing. The bound exists only to cap the
        lifetime of the queued device arrays and keep the worker from
        falling unboundedly behind; ``max_lag=0`` is the old lock-step,
        whose wait dominated the run whenever one keyframe's refinement
        (graph solve + verifies) exceeded the keyframe cadence
        (main_wait_s 35 s of a 43.5 s run, ADVICE r3 medium)."""
        while self._q.unfinished_tasks > max_lag:
            with self._q.all_tasks_done:
                if self._q.unfinished_tasks > max_lag:
                    self._q.all_tasks_done.wait(timeout=0.05)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def corrected_keyframes(self) -> tuple[np.ndarray, np.ndarray]:
        """(frame_idx [K], poses [K,4,4]) — final corrected keyframe poses."""
        with self._lock:
            idxs = np.asarray(self._kf_order, np.int64)
            poses = (
                np.stack([self._kf_corrected[i] for i in self._kf_order])
                if self._kf_order
                else np.zeros((0, 4, 4), np.float32)
            )
        return idxs, poses

    @property
    def stats(self) -> dict:
        s = dict(loops_closed=self._loops_closed, ba_solves=self._ba_solves)
        if self.wba is not None:
            s["ba_rejected"] = self.wba.n_rejected
            if self.wba.n_active:  # solver-capacity telemetry (VERDICT r5 item 3)
                act = sorted(self.wba.n_active)
                cand = sorted(self.wba.n_candidate)
                s["ba_active_p50"] = act[len(act) // 2]
                s["ba_active_max"] = act[-1]
                s["ba_candidate_max"] = cand[-1]
        if self.lclo is not None:
            s["loops_skipped_small"] = self.lclo.skipped_small
            s["decimations"] = self.lclo.decimations
            ev = self.lclo.disc_events  # bounded ring of the latest events
            s["lc_verified"] = self.lclo.n_verified
            if ev:  # gate-decision telemetry: what discrepancies were seen
                discs = sorted(e[1] for e in ev)
                s["lc_disc_max_m"] = discs[-1]
                s["lc_disc_p50_m"] = discs[len(discs) // 2]
            s.update({f"worker_lc_{k}_s": round(v, 3) for k, v in self.lclo.phase_s.items()})
        s.update({f"worker_{k}_s": round(v, 3) for k, v in self._phase_s.items()})
        return s

    def close(self) -> None:
        """Drain the queue and stop the thread."""
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=60.0)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- worker thread --------------------------------------------------------

    def _finalize(self) -> None:
        """Collect the final in-flight work (the pipelined dispatches at the
        last keyframe have no successor to collect them): the last window
        solve, then the LoopCloser's last verification round, folding an
        end-of-run closure into the ledger."""
        if self.wba is not None:
            for kf_idxs, T_new in self.wba.collect(drain=True):
                self._ba_solves += 1
                with self._lock:
                    for k, fi in enumerate(kf_idxs):
                        self._kf_corrected[fi] = T_new[k].copy()
        if self.lclo is None:
            return
        res = self.lclo.flush()
        if res is None:
            return
        self._loops_closed += 1
        surv = {akf.frame_idx: akf.pose_c2w.copy() for akf in self.lclo.keyframes}
        with self._lock:
            propagate_closure(self._kf_order, self._kf_corrected, self._kf_chain, surv)

    def _run(self) -> None:
        if self._stream is not None:
            torch.cuda.set_device(self.device)
            with torch.cuda.stream(self._stream):
                self._loop()
        else:
            self._loop()

    def _loop(self) -> None:
        # Jobs are processed TWO KEYFRAMES LATE: by the time job k+2 arrives
        # the device has advanced two keyframe periods and the host copies
        # started at job k's submit have landed, so the worker's reads do not
        # wait behind the frame loop's queued work. Deterministic: processing
        # order is unchanged, only shifted.
        staged: deque = deque()
        while True:
            job = self._q.get()
            if job is _WARMUP:
                try:
                    self._warmup()
                except BaseException as e:  # surfaced on the main thread
                    self._error = e
                self._q.task_done()
                continue
            if job is None:
                try:
                    while staged:
                        self._process(staged.popleft())
                    self._finalize()
                except BaseException as e:  # surfaced on the main thread
                    self._error = e
                self._q.task_done()
                return
            try:
                if len(staged) >= 2:
                    self._process(staged.popleft())
            except BaseException as e:  # surfaced on the main thread
                self._error = e
            finally:
                staged.append(job)
                self._q.task_done()

    def _process(self, job: _KeyframeJob) -> None:
        t0 = time.perf_counter()
        names, copy = job.host
        if self._stream is not None and copy.event is not None:
            # Device work below reads the frame loop's tensors: order this
            # stream after the work that produced them.
            self._stream.wait_event(copy.event)
        h = dict(zip(names, copy.numpy()))
        pose_chain = np.asarray(h["pose"], np.float64)
        pose = (self._D @ pose_chain).astype(np.float32)
        if self.wba is not None:  # host-side window assembly needs these
            l_xy = np.asarray(h["l_xy"], np.float32)
            r_xy = np.asarray(h["r_xy"], np.float32)
            mask = np.asarray(h["mask"], bool)
        else:
            l_xy = r_xy = mask = None
        snapshot = pose.copy()
        with self._lock:
            self._kf_corrected[job.frame_idx] = pose
            self._kf_chain[job.frame_idx] = pose
            self._kf_order.append(job.frame_idx)
        self._phase_s["copy"] += time.perf_counter() - t0

        if self.lclo is not None:
            from ..slam.loop_closure import ArchivedKeyframe

            t0 = time.perf_counter()
            res = self.lclo.add_keyframe(
                ArchivedKeyframe(
                    frame_idx=job.frame_idx,
                    pose_c2w=pose,
                    # The closer verifies from the device tensors and
                    # retrieves by the device-computed global descriptor.
                    l_px=l_xy,
                    r_px=r_xy,
                    l_desc=None,
                    mask=mask,
                    global_desc=np.asarray(h["gdesc"], np.float32),
                    dev=(job.l_xy, job.r_xy, job.l_desc, job.mask),
                ),
                query_dev=job.query,
            )
            self._phase_s["loop_closure"] += time.perf_counter() - t0
            if res is not None:
                self._loops_closed += 1
                surv = {akf.frame_idx: akf.pose_c2w.copy() for akf in self.lclo.keyframes}
                with self._lock:
                    surv_sorted, deltas = propagate_closure(
                        self._kf_order, self._kf_corrected, self._kf_chain, surv
                    )
                    final_lc = self._kf_corrected[job.frame_idx]
                # Only LOOP CLOSURES shift the worker frame: they observe
                # global drift. Window-BA refinements are local and must not
                # feed into D (see WindowedBA.collect on non-compounding).
                self._D = (
                    final_lc.astype(np.float64)
                    @ np.linalg.inv(snapshot.astype(np.float64))
                    @ self._D
                )
                pose = final_lc.copy()
                # Re-base the BA window onto the loop-corrected chain —
                # including window keyframes whose archive entry was
                # decimated (nearest-survivor delta), or the next window
                # solve initializes from pre-closure geometry (ADVICE r3).
                if self.wba is not None:
                    # An in-flight solve was computed from PRE-closure poses;
                    # collecting it would overwrite the closure correction
                    # with stale absolute poses. Closures are rare — drop it.
                    self.wba.drop_pending()
                    for kf in self.wba.window:
                        if kf.frame_idx in surv:
                            kf.pose_c2w = surv[kf.frame_idx].astype(np.float32)
                        elif surv_sorted.size:
                            d = deltas[
                                int(surv_sorted[np.argmin(np.abs(surv_sorted - kf.frame_idx))])
                            ]
                            kf.pose_c2w = (d @ kf.pose_c2w.astype(np.float64)).astype(
                                np.float32
                            )

        if self.wba is not None:
            from .ba_runner import Keyframe

            # Collect the solve dispatched at the PREVIOUS keyframe first
            # (its device result has had a full keyframe period to land —
            # reading at dispatch measured ~120 ms of queue wait per solve,
            # ba_runner.dispatch docstring).
            t0 = time.perf_counter()
            for kf_idxs, T_new in self.wba.collect():
                self._ba_solves += 1
                with self._lock:
                    for k, fi in enumerate(kf_idxs):
                        self._kf_corrected[fi] = T_new[k].copy()
            self._phase_s["ba_collect"] += time.perf_counter() - t0

            # BA inits from the (loop-corrected) chain pose, never from a
            # previous window solve (non-compounding local refinement).
            cur_pose = pose.copy()
            t0 = time.perf_counter()
            if "m_a" in h:
                tids = self.associator.add(int(job.slot), mask, h["m_a"], h["m_b"], np.asarray(h["m_ok"], bool))
            else:
                tids = np.asarray(h["ids"], np.int32)
            self._phase_s["associate"] += time.perf_counter() - t0
            self.wba.add_keyframe(
                Keyframe(
                    frame_idx=job.frame_idx,
                    pose_c2w=cur_pose,
                    # The associator keeps canonicalizing this array as later
                    # keyframes merge tracks — share it, don't copy.
                    ids=tids,
                    l_px=l_xy,
                    r_px=r_xy,
                    mask=mask,
                )
            )
            # NB deliberately NO queue-depth-based solve skipping: that would
            # make which windows get refined depend on thread timing,
            # breaking the worker's determinism guarantee (module docstring).
            # The dispatch is async and the result is collected one keyframe
            # later, so the solve costs the worker only the host-side
            # assemble (~ms), not the ~120 ms device round trip it used to.
            t0 = time.perf_counter()
            self.wba.dispatch()
            self._phase_s["ba_dispatch"] += time.perf_counter() - t0
