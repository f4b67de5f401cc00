"""Background keyframe refiner: BA + loop closure OFF the frame critical path
(port of vo_tpu.odometry.refiner).

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

On a CUDA card (``graph``, utils.graphs) the worker's device programs are
CUDA graphs: the window solve (odometry.ba_runner), the verification round
(slam.loop_closure) and the global descriptor that ``submit`` computes on the
main thread. All are captured in the warm-up, the worker's first job, while
the constructor blocks the main thread, so no capture runs while the other
thread launches; each has a memory pool of its own. Under a mesh each rank
captures its own: the round and the descriptor hold no collective, and the
landmark-sharded solve is captured over an NCCL group and eager over a gloo
one (utils.graphs.wanted decides each program by itself).

ONE ORDER OF COLLECTIVES. Under a mesh whose "model" axis is larger than
one, the window solve is landmark-sharded (dist.ba_sharded), and its
all-reduces go over the same ranks as the frame loop's RANSAC all-gathers.
NCCL kernels block until every peer has launched theirs, so every rank must
issue the two in one order, and the worker's host work takes a time that
differs from rank to rank. So the worker only PREPARES each solve (the
closer, ``collect``, the association and the window assembly, as
everywhere); the frame loop's thread LAUNCHES it, on its own stream, at a
fixed point: inside ``submit`` of the keyframe that comes three after the
one whose job prepared it, before that job is queued (``_launch_next``). The
frame loop blocks on the host until the worker has handed that problem
over, never on the device. A solve launched there is in the solver's
in-flight list before the worker's next ``collect``, exactly as when the
worker launched it, so the trajectory is the same. The drains (``close``,
``checkpoint_state``) launch the last problems from the waiting main thread
as the worker hands them over, and the worker processes the next job only
once the main thread has launched the previous one's solve. Every
collective of a rank then comes from one thread on one stream, in an order
fixed by frame index, over the mesh's own group. Without a mesh, or with a
"model" axis of one, the worker launches its solves itself.

RECORDS. ``refine_log()`` gathers what the solvers kept of their work, as host
arrays, in the order it was done (``RefineLog``): the window solves past the
cost gate (odometry.ba_runner), the pose-graph solves and the verification
rounds (slam.loop_closure), the final corrected keyframes, and the order in
which the worker applied them to its keyframe ledger (``RefineLog.order``:
each keyframe's entry, then the graph solves made and the window solves
collected at it); ``stats`` counts them. They are kept from what is on the
host already, and they do not go through a checkpoint: a resumed run records
from the resume on, while its counters carry on from the checkpoint.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..ba.window import BAResult
from ..config import PipelineConfig
from ..dist.mesh import axis_size
from ..geom.camera import StereoCalib
from ..utils import graphs
from ..utils.device import resolve
from ..utils.host_copy import HostCopy
from ..utils.profiling import span


@dataclasses.dataclass
class RefineLog:
    """The refiner's records of one run (``RefinerWorker.refine_log``), host arrays only."""

    window_solves: list  # [ba_runner.WindowSolve]: every window solve collected past the cost gate
    graph_solves: list  # [loop_closure.GraphSolve]: every pose-graph solve, accepted or rejected
    rounds: list  # [loop_closure.VerificationRound]: every verification round read
    kf_frame_idx: np.ndarray  # [K] int64, corrected_keyframes()
    kf_poses: np.ndarray  # [K, 4, 4] float32
    # The ledger's writes in the order the worker made them: ("keyframe", frame index) as a keyframe
    # enters it, ("window", i) as window_solves[i] is collected (whatever its verdict), ("graph", i)
    # as graph_solves[i] is made (accepted ones are propagated over the ledger there).
    order: list


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
# Queue sentinel: process the STAGED jobs now (checkpoint_state needs the worker
# fully caught up, not two keyframes behind).
_FLUSH = object()


def _stack(arrs: list, tail_shape: tuple, dtype=np.float32) -> np.ndarray:
    """np.stack with a typed empty for zero-length lists (npz needs shapes)."""
    if arrs:
        return np.stack([np.asarray(a, dtype) for a in arrs])
    return np.zeros((0,) + tail_shape, dtype)


def _landed(*arrays) -> HostCopy:
    """Copies of host arrays as a HostCopy that has already landed (restored in-flight results)."""
    return HostCopy(*(torch.from_numpy(np.array(a)) for a in arrays))


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
        device=None,
        mesh=None,
        graph=None,
    ):
        """``graph``: None runs the worker's programs as CUDA graphs on a CUDA device and eagerly
        on the CPU, False eagerly, True on the CPU raises; under a mesh, a sharded window solve
        whose group is a gloo group runs eagerly (``graph=True`` then raises; module docstring).

        ``mesh`` with a "model" axis > 1 shards the window solve over it, and the thread that
        calls ``submit`` launches every solve (module docstring: one order of collectives); its
        warm-up, and the capture where there is one, run here on the calling thread."""
        self.calib = calib
        self.cfg = cfg
        self.device = resolve(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.wba = None
        self.lclo = None
        self.associator = None
        if use_ba:
            from .ba_runner import WindowAssociator, WindowedBA

            self.wba = WindowedBA(calib, cfg.ba, device=self.device, mesh=mesh, graph=graph)
            self.associator = WindowAssociator(cfg.ba.window)
        # The sharded solve is launched by the main thread (module docstring): the worker hands
        # each job's prepared problem over in ``_prepared``, (problem or None, upload event); the
        # main thread owes a launch for every job in ``_owed`` and releases ``_launched`` after each.
        self._hand_over = use_ba and axis_size(mesh, "model") > 1
        self._prepared: queue.Queue = queue.Queue()
        self._launched = threading.Semaphore(0)
        self._owed = 0
        self._unlaunched = False  # worker: a problem it handed over may not be launched yet
        # Main-thread seconds blocked on the worker: in submit on a problem not yet handed over
        # ("launch_wait"), in the runner's throttle ("throttle"); spans vo_tpu_torch.refiner.<key>.
        self.main_wait_s: dict = {}
        if use_loop_closure:
            from ..slam.loop_closure import LoopCloser

            self.lclo = LoopCloser(calib, cfg.loop, matcher=cfg.matcher, device=self.device, graph=graph)
        # submit's global descriptor: captured per shape in the warm-up, or eager
        graphed = graphs.wanted(graph, self.device)
        self._gdesc = graphs.ByShape(global_desc, self.device, "global_descriptor") if graphed else global_desc
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # frame_idx -> latest corrected [4,4] pose (worker-owned, lock-guarded)
        self._kf_corrected: dict[int, np.ndarray] = {}
        # frame_idx -> loop-corrected CHAIN pose (excludes window-BA deltas).
        # Closure deltas are computed against this ledger so keyframes the
        # LoopCloser has DECIMATED out of its archive still ride along with
        # their nearest surviving neighbor instead of keeping stale poses.
        self._kf_chain: dict[int, np.ndarray] = {}
        self._kf_order: list[int] = []
        self._order: list[tuple[str, int]] = []  # RefineLog.order
        # Cumulative rigid correction mapping live-chain poses into the
        # worker's corrected frame (worker-thread only; no lock needed).
        self._D = np.eye(4, dtype=np.float64)
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self._loops_closed = 0
        self._ba_solves = 0
        self._phase_s: dict = {}  # worker-phase seconds; spans vo_tpu_torch.refiner.<phase>
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        # The warm-up (solver and verification once on the production shapes)
        # runs as the worker's first job, so that its first-use costs, the
        # worker thread's own library handles included, land before the
        # caller's timed loop.
        self._q.put(_WARMUP)
        self.wait_pending()
        if self._hand_over:
            self.wba.warmup()

    def _warmup(self) -> None:
        if self.wba is not None and not self._hand_over:
            self.wba.warmup()
        if self.lclo is None:
            return
        # Every shape submit can hand the closer: the full detection set as the query (the
        # runner's), or the stereo subset where a caller passes none.
        C, Q = self.cfg.max_tracks, self.cfg.sift.max_keypoints
        for n in dict.fromkeys((Q, C)):
            self.lclo.warmup(C, n)
            if isinstance(self._gdesc, graphs.ByShape):
                self._gdesc.capture(torch.zeros((n, 128), device=self.device), torch.zeros(n, dtype=torch.bool, device=self.device))

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
            arrs.append(self._gdesc(gd, gm))
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
        if self._hand_over:
            # The worker processes job k when job k + 2 arrives, so before job k + 3 goes in,
            # job k's solve is launched here: the worker's next collect finds it in flight.
            with span("vo_tpu_torch.refiner.launch_wait", total=self.main_wait_s):
                while self._owed > 2:
                    self._launch_next()
            self._owed += 1
        self._q.put(job)

    def _launch_next(self) -> None:
        """Main thread: launch the solve the worker prepared from the oldest job still owed, on
        the current stream, once the worker has handed it over (a worker error is raised here)."""
        while True:
            try:
                prepared, uploaded = self._prepared.get(timeout=0.05)
                break
            except queue.Empty:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
        self._owed -= 1
        if prepared is not None and uploaded is not None:
            # The problem was uploaded on the worker's stream: order this stream after the
            # upload, and keep the allocator from handing its memory back to the worker early.
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(uploaded)
            for t in prepared[0]:
                t.record_stream(stream)
        self.wba.launch(prepared)
        self._launched.release()

    def _drain(self, sentinel) -> None:
        """Queue ``sentinel`` (_FLUSH or None), launch the solves the worker prepares from the staged
        jobs as it hands them over (none owed where the worker launches its own), and wait for it."""
        self._q.put(sentinel)
        while self._owed > 0:
            self._launch_next()
        self.wait_pending()

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

    def refine_log(self) -> RefineLog:
        """The records of the run so far (module docstring); call after ``close``."""
        kf_idx, kf_poses = self.corrected_keyframes()
        return RefineLog(
            window_solves=list(self.wba.records) if self.wba is not None else [],
            graph_solves=list(self.lclo.graph_solves) if self.lclo is not None else [],
            rounds=list(self.lclo.rounds) if self.lclo is not None else [],
            kf_frame_idx=kf_idx,
            kf_poses=kf_poses,
            order=list(self._order),
        )

    def _collected(self, drain: bool = False) -> list:
        """``wba.collect``'s accepted solves; the solves it recorded go into ``_order``."""
        n0 = len(self.wba.records)
        out = self.wba.collect(drain=drain)
        self._order += [("window", i) for i in range(n0, len(self.wba.records))]
        return out

    def _graphs_since(self, n0: int) -> None:
        """The loop closer's graph solves from the ``n0``-th on go into ``_order``."""
        self._order += [("graph", i) for i in range(n0, len(self.lclo.graph_solves))]

    @property
    def stats(self) -> dict:
        s = dict(loops_closed=self._loops_closed, ba_solves=self._ba_solves)
        if self.wba is not None:
            s["ba_rejected"] = self.wba.n_rejected
            s["records_window"] = len(self.wba.records)
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
            s["records_graph"] = len(self.lclo.graph_solves)
            s["records_rounds"] = len(self.lclo.rounds)
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
        self._drain(None)  # raises a worker error
        self._thread.join(timeout=60.0)

    # -- checkpoint / resume --------------------------------------------------
    #
    # The COMPLETE refinement state (ledgers, LoopCloser archive with the
    # descriptors read back from the device, loop edges, the in-flight
    # pipelined rounds (window solves and verification) as host arrays, the
    # associator's rings) round-trips through a flat numpy dict under the
    # reference's names, so a resumed run is bit-exact against the
    # uninterrupted one (tests/test_torch_checkpoint.py).

    def checkpoint_state(self) -> dict:
        """Drain the worker (staged jobs included) and snapshot the refinement state as a flat
        {name: np.ndarray} dict for npz persistence. In-flight device results are waited for and
        read to the host here."""
        from .checkpoint import generator_fields

        self._drain(_FLUSH)
        p: dict = {}
        with self._lock:
            order = list(self._kf_order)
            p["ref_kf_order"] = np.asarray(order, np.int64)
            p["ref_kf_corrected"] = _stack([self._kf_corrected[i] for i in order], (4, 4))
            p["ref_kf_chain"] = _stack([self._kf_chain[i] for i in order], (4, 4))
        p["ref_D"] = self._D.copy()
        p["ref_counters"] = np.asarray([self._loops_closed, self._ba_solves], np.int64)
        if self.lclo is not None:
            lc = self.lclo
            kfs = lc.keyframes
            host = self._kf_host_arrays(kfs)
            p["lc_kf_frame_idx"] = np.asarray([k.frame_idx for k in kfs], np.int64)
            p["lc_kf_pose"] = _stack([k.pose_c2w for k in kfs], (4, 4))
            p["lc_kf_lpx"] = _stack([h[0] for h in host], (0, 2))
            p["lc_kf_rpx"] = _stack([h[1] for h in host], (0, 2))
            p["lc_kf_desc"] = _stack([h[2] for h in host], (0, 128))
            p["lc_kf_mask"] = _stack([h[3] for h in host], (0,), bool)
            p["lc_kf_gdesc"] = _stack([k.global_desc for k in kfs], (128,))
            p["lc_kf_path"] = np.asarray([k.path_m for k in kfs], np.float64)
            p["lc_edges_a"] = np.asarray([e[0] for e in lc.loop_edges], np.int64)
            p["lc_edges_b"] = np.asarray([e[1] for e in lc.loop_edges], np.int64)
            p["lc_edges_Z"] = _stack([e[2] for e in lc.loop_edges], (4, 4))
            p["lc_scalars"] = np.asarray(
                [lc.decimations, lc.skipped_small, lc.n_verified, lc._cooldown_left], np.int64
            )
            p["lc_path_m"] = np.asarray(lc._path_m, np.float64)
            p["lc_last_t"] = lc._last_t if lc._last_t is not None else np.full(3, np.nan, np.float64)
            # lc_key (the reference's PRNG key) is a placeholder here: the
            # stream is the generator's state, under the port's names.
            p.update(generator_fields(lc._gen, prefix="lc_"))
            if lc._pending is not None:
                ver_fi, cand_fis, outs = lc._pending
                ok, n_inl, poses, n_m = outs.numpy()
                p["lc_pend_ver"] = np.asarray(ver_fi, np.int64)
                p["lc_pend_cands"] = np.asarray(cand_fis, np.int64)
                p["lc_pend_ok"] = ok
                p["lc_pend_ninl"] = n_inl
                p["lc_pend_poses"] = poses
                p["lc_pend_nm"] = n_m
        if self.wba is not None:
            w = self.wba
            kfs = list(w.window)
            slots = self.associator._slot_tids
            p["ba_win_frame_idx"] = np.asarray([k.frame_idx for k in kfs], np.int64)
            p["ba_win_pose"] = _stack([k.pose_c2w for k in kfs], (4, 4))
            p["ba_win_lpx"] = _stack([k.l_px for k in kfs], (0, 2))
            p["ba_win_rpx"] = _stack([k.r_px for k in kfs], (0, 2))
            p["ba_win_mask"] = _stack([k.mask for k in kfs], (0,), bool)
            p["ba_win_ids"] = _stack([np.asarray(k.ids, np.int64) for k in kfs], (0,), np.int64)
            # ids sharing: which associator ring slot each window keyframe's
            # ids array IS (in-place canonicalization must keep reaching it).
            p["ba_win_slot"] = np.asarray(
                [next((s for s, st in enumerate(slots) if st is not None and st is k.ids), -1) for k in kfs],
                np.int64,
            )
            C = self.cfg.max_tracks
            ring = np.full((len(slots), C), -1, np.int64)
            for s, st in enumerate(slots):
                if st is not None:
                    ring[s] = st
            p["ba_ring_tids"] = ring
            p["ba_ring_present"] = np.asarray([st is not None for st in slots], bool)
            p["ba_next"] = np.asarray(self.associator._next, np.int64)
            p["ba_rejected"] = np.asarray(w.n_rejected, np.int64)
            for j, (copy, kf_idxs, *_) in enumerate(w._pending):
                res = BAResult(*copy.numpy())
                p[f"ba_pend{j}_T"] = res.T_c2w
                p[f"ba_pend{j}_cost"] = res.cost
                p[f"ba_pend{j}_cost0"] = res.cost0
                p[f"ba_pend{j}_idxs"] = np.asarray(kf_idxs, np.int64)
        return p

    @staticmethod
    def _kf_host_arrays(kfs) -> list:
        """[(l_px, r_px, l_desc, mask)] of archived keyframes as host arrays; what has no host
        copy is read back from the keyframes' device tensors, all in one host copy."""
        names = ("l_px", "r_px", "l_desc", "mask")
        missing = [(i, j) for i, kf in enumerate(kfs) for j, n in enumerate(names) if getattr(kf, n) is None]
        read = dict(zip(missing, HostCopy(*(kfs[i].dev[j] for i, j in missing)).numpy())) if missing else {}
        dtypes = (np.float32, np.float32, np.float32, bool)
        return [
            tuple(
                np.asarray(read[(i, j)] if (i, j) in read else getattr(kf, n), dt)
                for j, (n, dt) in enumerate(zip(names, dtypes))
            )
            for i, kf in enumerate(kfs)
        ]

    def restore_state(self, p: dict) -> None:
        """Inverse of checkpoint_state. Call before any submit(). Takes the reference refiner's
        ``checkpoint_state()`` dict too (the same names; what is kept is copied). The sample stream
        does not cross between the packages: a state that the reference wrote has no generator
        fields, and the verification stream is then seeded from its ``lc_key``, so the run
        continues, but not with the draws the reference would have made."""
        from .checkpoint import generator_from_fields

        order = [int(i) for i in p["ref_kf_order"]]
        with self._lock:
            self._kf_order = order
            self._kf_corrected = {i: np.array(p["ref_kf_corrected"][k], np.float32) for k, i in enumerate(order)}
            self._kf_chain = {i: np.array(p["ref_kf_chain"][k], np.float32) for k, i in enumerate(order)}
        self._D = np.array(p["ref_D"], np.float64)
        self._loops_closed, self._ba_solves = (int(x) for x in p["ref_counters"])
        if self.lclo is not None and "lc_kf_frame_idx" in p:
            from ..slam.loop_closure import ArchivedKeyframe

            lc = self.lclo
            lc.keyframes = [
                ArchivedKeyframe(
                    frame_idx=int(p["lc_kf_frame_idx"][k]),
                    pose_c2w=np.array(p["lc_kf_pose"][k], np.float32),
                    l_px=p["lc_kf_lpx"][k],
                    r_px=p["lc_kf_rpx"][k],
                    l_desc=p["lc_kf_desc"][k],
                    mask=p["lc_kf_mask"][k],
                    global_desc=p["lc_kf_gdesc"][k],
                    path_m=float(p["lc_kf_path"][k]),
                    dev=None,  # uploaded on demand (LoopCloser._dev_of)
                )
                for k in range(p["lc_kf_frame_idx"].shape[0])
            ]
            lc.loop_edges = [
                (int(a), int(b), np.array(Z)) for a, b, Z in zip(p["lc_edges_a"], p["lc_edges_b"], p["lc_edges_Z"])
            ]
            lc.decimations, lc.skipped_small, lc.n_verified, lc._cooldown_left = (int(x) for x in p["lc_scalars"])
            lc._path_m = float(p["lc_path_m"])
            lt = np.asarray(p["lc_last_t"])
            lc._last_t = None if np.isnan(lt).any() else lt
            # Into the closer's own generator: its captured rounds draw from that one.
            lc._gen.set_state(generator_from_fields(p, self.device, prefix="lc_").get_state())
            if "lc_pend_ver" in p:
                lc._pending = (
                    int(p["lc_pend_ver"]),
                    [int(x) for x in p["lc_pend_cands"]],
                    _landed(p["lc_pend_ok"], p["lc_pend_ninl"], p["lc_pend_poses"], p["lc_pend_nm"]),
                )
        if self.wba is not None and "ba_win_frame_idx" in p:
            from .ba_runner import Keyframe

            slots: list = [None] * self.associator.n_slots
            for s in range(len(slots)):
                if p["ba_ring_present"][s]:
                    slots[s] = np.array(p["ba_ring_tids"][s], np.int64)
            self.associator._slot_tids = slots
            self.associator._next = int(p["ba_next"])
            live = set()
            for st in slots:
                if st is not None:
                    live.update(int(t) for t in st[st >= 0])
            self.associator._parent = {t: t for t in live}  # canonicalized invariant
            self.wba.window.clear()
            for k in range(p["ba_win_frame_idx"].shape[0]):
                s = int(p["ba_win_slot"][k])
                # The SAME array as the ring slot, or the associator's in-place
                # canonicalization stops reaching this keyframe.
                ids = slots[s] if s >= 0 and slots[s] is not None else np.array(p["ba_win_ids"][k])
                self.wba.window.append(
                    Keyframe(
                        frame_idx=int(p["ba_win_frame_idx"][k]),
                        pose_c2w=np.array(p["ba_win_pose"][k], np.float32),
                        ids=ids,
                        l_px=p["ba_win_lpx"][k],
                        r_px=p["ba_win_rpx"][k],
                        mask=p["ba_win_mask"][k],
                    )
                )
            self.wba.n_rejected = int(p["ba_rejected"])
            self.wba._pending.clear()
            j = 0
            while f"ba_pend{j}_T" in p:
                # The checkpoint holds no landmarks or observation count, as the reference's.
                res = _landed(p[f"ba_pend{j}_T"], np.zeros((0, 3), np.float32), p[f"ba_pend{j}_cost0"],
                              p[f"ba_pend{j}_cost"], np.asarray(0))
                self.wba._pending.append((res, [int(x) for x in p[f"ba_pend{j}_idxs"]]))
                j += 1

    # -- worker thread --------------------------------------------------------

    def _await_launch(self) -> None:
        """Worker: wait until the main thread has launched the last problem handed over (at once
        in the frame loop, where it was launched before the job that woke the worker was queued;
        in a drain, as the main thread gets to it)."""
        if self._unlaunched:
            self._launched.acquire()
            self._unlaunched = False

    def _finalize(self) -> None:
        """Collect the final in-flight work (the pipelined dispatches at the
        last keyframe have no successor to collect them): the last window
        solve, then the LoopCloser's last verification round, folding an
        end-of-run closure into the ledger."""
        self._await_launch()
        if self.wba is not None:
            for kf_idxs, T_new in self._collected(drain=True):
                self._ba_solves += 1
                with self._lock:
                    for k, fi in enumerate(kf_idxs):
                        self._kf_corrected[fi] = T_new[k].copy()
        if self.lclo is None:
            return
        n0 = len(self.lclo.graph_solves)
        res = self.lclo.flush()
        self._graphs_since(n0)
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
            if job is _FLUSH:
                try:
                    while staged:
                        self._process(staged.popleft())
                except BaseException as e:  # surfaced on the main thread
                    self._error = e
                finally:
                    staged.clear()
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
        self._await_launch()
        with span("vo_tpu_torch.refiner.copy", total=self._phase_s):
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
                self._order.append(("keyframe", job.frame_idx))

        if self.lclo is not None:
            from ..slam.loop_closure import ArchivedKeyframe

            with span("vo_tpu_torch.refiner.loop_closure", total=self._phase_s):
                n0 = len(self.lclo.graph_solves)
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
                self._graphs_since(n0)
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
            with span("vo_tpu_torch.refiner.ba_collect", total=self._phase_s):
                for kf_idxs, T_new in self._collected():
                    self._ba_solves += 1
                    with self._lock:
                        for k, fi in enumerate(kf_idxs):
                            self._kf_corrected[fi] = T_new[k].copy()

            # BA inits from the (loop-corrected) chain pose, never from a
            # previous window solve (non-compounding local refinement).
            cur_pose = pose.copy()
            with span("vo_tpu_torch.refiner.associate", total=self._phase_s):
                if "m_a" in h:
                    tids = self.associator.add(int(job.slot), mask, h["m_a"], h["m_b"], np.asarray(h["m_ok"], bool))
                else:
                    tids = np.asarray(h["ids"], np.int32)
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
            with span("vo_tpu_torch.refiner.ba_dispatch", total=self._phase_s):
                if self._hand_over:  # the main thread launches it (module docstring)
                    prepared = self.wba.prepare()
                    uploaded = None
                    if prepared is not None and self._stream is not None:
                        uploaded = torch.cuda.Event()
                        uploaded.record(self._stream)
                    self._unlaunched = True
                    self._prepared.put((prepared, uploaded))
                else:
                    self.wba.dispatch()
