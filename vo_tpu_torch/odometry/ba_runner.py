"""Sliding-window BA in the VO loop: keyframe windows over persistent tracks (port of vo_tpu.odometry.ba_runner).

Every ``keyframe_every``-th frame becomes a keyframe carrying its stereo
observations; the refiner's associator (WindowAssociator) gives them track
ids across the window; once the window holds >= 3 keyframes the multi-view
tracks are assembled on the host into a fixed-capacity BAProblem and solved
on the device (ba.window). See the reference module's docstring for what the
solve measurably buys (alone: nothing on the synthetic feed; with loop
closure: cleaner odometry edges for the closure graph).

On a CUDA card the solve is one CUDA graph (utils.graphs.StaticCall, the
reference's ``jax.jit(solve_window)``), captured at the first solve (``warmup``
makes it, at the production shapes (K, M) = (``cfg.window``,
``cfg.max_points``)); each dispatch copies the assembled problem into its
static buffers and replays. Landmark-sharded over a mesh's "model" axis
(dist.ba_sharded), the solve is one graph per rank where its group is an
NCCL group, its all-reduces and the final all-gather inside it.
``graph=False``, the CPU and a solve that reduces over gloo run eagerly.
``dispatch`` is ``prepare`` (the host assembly and the problem's upload)
then ``launch`` (the solve and the start of its host copies), so that a
caller can run the two halves on two threads (odometry.refiner does under
a mesh).

The host parts (triangulation, Keyframe, the union-find associator, the
window assembly and the collect gate) are the reference's numpy code, copied
because the reference module imports jax. The device solve is dispatched
without reading it: the host copies of its whole result (poses, landmarks,
costs and observation count) start at dispatch (utils.host_copy) and are
read ``PIPELINE_DEPTH`` keyframes later; ``last_result`` keeps the last one
that passed the cost gate, as host arrays.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ba.window import BAProblem, BAResult, solve_window
from ..config import BAConfig
from ..convert import ba_problem_from_numpy
from ..dist.ba_sharded import solve_window_sharded
from ..dist.mesh import axis_size
from ..geom.camera import StereoCalib
from ..utils import graphs
from ..utils.device import resolve
from ..utils.host_copy import HostCopy


def _triangulate_rectified_np(l_px: np.ndarray, r_px: np.ndarray, calib: StereoCalib) -> np.ndarray:
    """Host-side rectified closed form (geom.triangulate.triangulate_rectified
    in numpy): window assembly runs on the worker thread on host arrays."""
    disparity = l_px[:, 0] - r_px[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(disparity > 0, float(calib.fu) * float(calib.baseline) / disparity, np.inf)
    x = (l_px[:, 0] - float(calib.cu)) / float(calib.fu) * z
    y = (l_px[:, 1] - float(calib.cv)) / float(calib.fv) * z
    return np.stack([x, y, z], axis=-1).astype(np.float32)


@dataclasses.dataclass
class Keyframe:
    frame_idx: int
    pose_c2w: np.ndarray  # [4, 4]
    # [C] integer track ids, -1 invalid. On the associator path this is the
    # int64 array SHARED with WindowAssociator._slot_tids, canonicalized
    # in place as later keyframes merge tracks (safe: single worker thread);
    # the non-associator path stores an int32 copy.
    ids: np.ndarray
    l_px: np.ndarray  # [C, 2]
    r_px: np.ndarray  # [C, 2]
    mask: np.ndarray  # [C]


class WindowAssociator:
    """Descriptor-level association of observations across window keyframes.

    The VO pipeline's persistent track ids chain frame-to-frame through the
    4-stage cascade (odometry.pipeline), so survival across a keyframe gap
    compounds per-frame attrition (~survival^gap — measured 1.4% over 5
    frames on the synthetic feed) and the BA window starves (~15 multi-view
    landmarks, near-zero redundancy). Here each new keyframe is matched
    DIRECTLY against every keyframe still in the window (one vmapped MXU
    matmul on device, off the frame critical path — odometry.runner) and the
    pairings are merged with union-find: one matching stage per pair instead
    of ``gap`` chained stages.
    """

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._next = 0
        self._parent: dict[int, int] = {}
        # slot -> [C] int64 tids of the keyframe currently in that ring slot
        self._slot_tids: list = [None] * n_slots

    def _find(self, t: int) -> int:
        root = t
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[t] != root:  # path compression
            self._parent[t], t = root, self._parent[t]
        return root

    def _union(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[max(ra, rb)] = min(ra, rb)

    def add(
        self,
        slot: int,
        valid: np.ndarray,
        m_a: np.ndarray,
        m_b: np.ndarray,
        m_ok: np.ndarray,
    ) -> np.ndarray:
        """Register a keyframe entering ring ``slot``; returns its [C] tids.

        ``m_a/m_b/m_ok`` are [K, C] match payloads of the new keyframe (A
        side) against each ring slot's keyframe (B side), computed BEFORE the
        new keyframe overwrote ``slot`` (so row ``slot`` refers to the
        departing keyframe and is ignored).
        """
        C = valid.shape[0]
        tids = np.full(C, -1, np.int64)
        fresh = np.flatnonzero(valid)
        tids[fresh] = self._next + np.arange(fresh.size)
        for t in tids[fresh]:
            self._parent[int(t)] = int(t)
        self._next += fresh.size
        for k in range(self.n_slots):
            if k == slot or self._slot_tids[k] is None:
                continue
            prev_tids = self._slot_tids[k]
            for j in np.flatnonzero(m_ok[k]):
                a, b = int(m_a[k, j]), int(m_b[k, j])
                if valid[a] and prev_tids[b] >= 0:
                    self._union(int(tids[a]), int(prev_tids[b]))
        self._slot_tids[slot] = tids
        # Canonicalize every live slot so assembly can group by plain equality.
        for k in range(self.n_slots):
            st = self._slot_tids[k]
            if st is None:
                continue
            for j in np.flatnonzero(st >= 0):
                st[j] = self._find(int(st[j]))
        # Mark-and-sweep: every slot is fully canonicalized (all stored ids
        # are roots), so parent entries not referenced by any live slot can
        # never be reached again — drop them or _parent grows without bound
        # over long runs (ADVICE r2).
        live = set()
        for st in self._slot_tids:
            if st is not None:
                live.update(int(t) for t in st[st >= 0])
        self._parent = {t: t for t in live}
        return self._slot_tids[slot]


class WindowedBA:
    """Keyframe window + device solver; returns pose corrections."""

    def __init__(self, calib: StereoCalib, cfg: BAConfig, device=None, mesh=None, graph=None):
        """``mesh`` with a "model" axis > 1 runs every window solve landmark-sharded over it
        (dist.ba_sharded: the same solver, its landmark sums all-reduced over the mesh's
        group); every rank of the axis then holds the same window and calls the same methods
        in the same order. ``graph``: None solves
        through a CUDA graph on a CUDA device and eagerly on the CPU, False eagerly, True on
        the CPU raises; a sharded solve is captured where its group is an NCCL group and
        eager where it is a gloo group (``graph=True`` there raises; utils.graphs.wanted)."""
        self.calib = calib.to("cpu")  # the window assembly reads it on the host
        self.cfg = cfg
        self.device = resolve(device)
        self._calib_dev = calib.to(self.device)
        self._mesh = mesh if axis_size(mesh, "model") > 1 else None
        backends = None
        if self._mesh is not None:
            backends = (dist.get_backend(mesh.get_group("model")),)
        self._graphed = graphs.wanted(graph, self.device, backends)
        self._call: Optional[graphs.StaticCall] = None  # the captured solve (at the first solve: warmup)
        self.window: deque = deque(maxlen=cfg.window)
        # The last collected solve that passed the cost gate: a BAResult of host arrays, copied
        # out before any later replay could overwrite a graph's outputs.
        self.last_result: Optional[BAResult] = None
        self.n_rejected = 0  # solves discarded by the correction sanity gate
        # In-flight solves: (HostCopy of the BAResult's fields, window frame_idxs at
        # dispatch), collected PIPELINE_DEPTH keyframes later (dispatch()).
        self._pending: deque = deque()
        self.n_active: list[int] = []  # active landmarks per assembled window
        self.n_candidate: list[int] = []  # multi-view tracks before capacity cap

    def _solve_eager(self, prob: BAProblem):
        if self._mesh is not None:
            return solve_window_sharded(prob, self._calib_dev, self.cfg, self._mesh)
        return solve_window(prob, self._calib_dev, self.cfg)

    def _solve(self, prob: BAProblem):
        if not self._graphed:
            return self._solve_eager(prob)
        if self._call is None:
            self._call = graphs.StaticCall(self._solve_eager, (prob,), self.device, "window_solve")
        return self._call(prob)

    def warmup(self) -> None:
        """Run the solver once on the production (K, M) shapes with an empty problem (graphed: the
        capture, then one replay), so that first-use costs (solver library handles, allocator
        growth, the capture) land outside the timed loop."""
        K, M = self.cfg.window, self.cfg.max_points
        d = self.device
        prob = BAProblem(
            T_c2w=torch.eye(4, device=d).repeat(K, 1, 1),
            X=torch.zeros((M, 3), device=d),
            obs_uv=torch.zeros((K, M, 2), device=d),
            obs_mask=torch.zeros((K, M), dtype=torch.bool, device=d),
            obs_ur=torch.zeros((K, M), device=d),
            obs_ur_mask=torch.zeros((K, M), dtype=torch.bool, device=d),
            X_mask=torch.zeros(M, dtype=torch.bool, device=d),
            kf_mask=torch.zeros(K, dtype=torch.bool, device=d),
        )
        HostCopy(self._solve(prob).T_c2w).numpy()

    def add_keyframe(self, kf: Keyframe) -> None:
        self.window.append(kf)

    def _assemble(self) -> Optional[BAProblem]:
        K = self.cfg.window
        M = self.cfg.max_points
        kfs = list(self.window)
        if len(kfs) < 3:
            return None
        # Tracks seen in >= 2 keyframes, most-observed first.
        counts: dict = {}
        for kf in kfs:
            for tid in kf.ids[kf.mask]:
                if tid >= 0:
                    counts[int(tid)] = counts.get(int(tid), 0) + 1
        multi = [t for t, c in counts.items() if c >= 2]
        self.n_candidate.append(len(multi))
        if len(multi) < 12:
            return None
        multi.sort(key=lambda t: -counts[t])
        track_ids = multi[:M]
        col = {t: j for j, t in enumerate(track_ids)}

        obs_uv = np.zeros((K, M, 2), np.float32)
        obs_mask = np.zeros((K, M), bool)
        obs_ur = np.zeros((K, M), np.float32)
        X0 = np.zeros((M, 3), np.float32)
        X_seen = np.zeros(M, bool)
        T0 = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        kf_mask = np.zeros(K, bool)
        # Landmark init: triangulate at the FIRST observing keyframe.
        for k, kf in enumerate(kfs):
            T0[k] = kf.pose_c2w
            kf_mask[k] = True
            sel = kf.mask & (kf.ids >= 0)
            rows = np.flatnonzero(sel)
            cols = np.array([col.get(int(t), -1) for t in kf.ids[rows]])
            ok = cols >= 0
            rows, cols = rows[ok], cols[ok]
            obs_uv[k, cols] = kf.l_px[rows]
            obs_ur[k, cols] = kf.r_px[rows, 0]
            obs_mask[k, cols] = True
            new = ~X_seen[cols]
            if new.any():
                nr, nc = rows[new], cols[new]
                Xc = _triangulate_rectified_np(kf.l_px[nr], kf.r_px[nr], self.calib)
                good = (Xc[:, 2] > 0.5) & (Xc[:, 2] < 200.0) & np.isfinite(Xc).all(axis=1)
                Xw = Xc[good] @ kf.pose_c2w[:3, :3].T + kf.pose_c2w[:3, 3]
                X0[nc[good]] = Xw
                X_seen[nc[good]] = True
        # Reprojection pre-gate: drop gross-outlier observations
        # (mis-associated tracks) before they can lever the solve.
        P = np.asarray(self.calib.P1, np.float64)
        err_km = np.zeros((K, M), np.float64)  # per-obs residual under VO poses
        for k, kf in enumerate(kfs):
            Rw = kf.pose_c2w[:3, :3]
            t = kf.pose_c2w[:3, 3]
            Xc = (X0 - t) @ Rw  # world -> camera (R is orthonormal)
            z = Xc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = P[0, 0] * Xc[:, 0] / z + P[0, 2]
                v = P[1, 1] * Xc[:, 1] / z + P[1, 2]
            err = np.hypot(u - obs_uv[k, :, 0], v - obs_uv[k, :, 1])
            ur = P[0, 0] * (Xc[:, 0] - float(self.calib.baseline)) / z + P[0, 2]
            err_r = np.abs(ur - obs_ur[k])
            bad = obs_mask[k] & (
                (z <= 0.1)
                | ~np.isfinite(err)
                | (err > self.cfg.obs_gate_px)
                | ~np.isfinite(err_r)
                | (err_r > self.cfg.obs_gate_px)
            )
            obs_mask[k, bad] = False
            err_km[k] = np.where(obs_mask[k], np.maximum(err, err_r), 0.0)
        # Adaptive track-consistency gate: a track whose worst residual under
        # the VO-chained poses is far above the population's is either
        # mis-associated or anchored to a feature that does not track a
        # single 3D point (e.g. a texture extremum off the surface point);
        # such tracks bias the solve coherently while honest drift affects
        # all tracks alike. The threshold adapts to the window's drift level
        # (median of per-track maxima), with a floor so detection noise is
        # never gated.
        track_max = err_km.max(axis=0)
        active = X_seen & (obs_mask.sum(axis=0) >= 2)
        if active.any():
            med = float(np.median(track_max[active]))
            gate = max(self.cfg.track_gate_mult * med, self.cfg.track_gate_floor_px)
            obs_mask[:, active & (track_max > gate)] = False
        X_mask = X_seen & (obs_mask.sum(axis=0) >= 2)
        self.n_active.append(int(X_mask.sum()))
        if X_mask.sum() < 12:
            return None
        return ba_problem_from_numpy(
            dict(
                T_c2w=T0, X=X0, obs_uv=obs_uv, obs_mask=obs_mask, obs_ur=obs_ur,
                obs_ur_mask=obs_mask, X_mask=X_mask, kf_mask=kf_mask,
            ),
            self.device,
        )

    PIPELINE_DEPTH = 2  # keyframes between a solve's dispatch and its collect

    def dispatch(self) -> bool:
        """Assemble + launch the current window's solve WITHOUT reading the result (``prepare``,
        then ``launch``). Returns whether a solve was launched."""
        return self.launch(self.prepare())

    def prepare(self):
        """The host half of ``dispatch``: the current window's problem, assembled and uploaded on
        the current stream, with the window's frame indices -> (BAProblem, [frame_idx]), or None
        where the window has nothing to solve."""
        prob = self._assemble()
        if prob is None:
            return None
        return prob, [kf.frame_idx for kf in self.window]

    def launch(self, prepared) -> bool:
        """The device half of ``dispatch``: solve a ``prepare``d problem on the current stream
        without reading the result. Its host copies start now, on the stream of the solve and
        before any later solve can overwrite a graph's outputs, and are read PIPELINE_DEPTH
        keyframes later (collect()). Returns whether a solve was launched."""
        if prepared is None:
            return False
        prob, kf_idxs = prepared
        res = self._solve(prob)
        self._pending.append((HostCopy(*res), kf_idxs))
        return True

    def drop_pending(self) -> None:
        """Invalidate the in-flight solves (after a loop closure re-bases the
        window: they were computed from pre-closure poses and collecting
        them would write stale absolute poses over the closure correction)."""
        self._pending.clear()

    def collect(self, drain: bool = False) -> list:
        """Gate + return ripe solves as [(kf_frame_idxs, T_new [n,4,4])].

        A solve is ripe once PIPELINE_DEPTH newer dispatches exist (or on
        ``drain`` at end of run). Window keyframes do NOT adopt the refined
        poses: every solve is an independent local refinement anchored on
        the (VO/loop-corrected) chain poses the keyframes entered with.
        Adopting refined poses fed each solve's residual bias into the next
        window's anchor, so the bias INTEGRATED across solves — measured
        +0.08 m over 117 solves on a 600-frame run whose plain-VO drift was
        smaller than that. A sliding window can only observe intra-window
        structure; accumulated drift is the pose graph's job
        (slam.loop_closure), so corrections here are deliberately bounded
        and non-compounding."""
        out = []
        while self._pending and (drain or len(self._pending) >= self.PIPELINE_DEPTH):
            copy, kf_idxs = self._pending.popleft()
            res = BAResult(*copy.numpy())
            if not np.isfinite(float(res.cost)) or float(res.cost) > float(res.cost0):
                continue
            self.last_result = res
            n = len(kf_idxs)
            T_new = res.T_c2w[:n]
            # Sanity gate on the LAST keyframe's correction: beyond plausible
            # intra-window drift means the solve wandered (weak
            # conditioning); discard rather than corrupt the trajectory
            # through re-anchoring.
            T_old_last = None
            for kf in self.window:
                if kf.frame_idx == kf_idxs[-1]:
                    T_old_last = kf.pose_c2w
            if T_old_last is None:  # window moved on entirely; stale solve
                continue
            correction = T_new[-1] @ np.linalg.inv(T_old_last)
            d_t = float(np.linalg.norm(correction[:3, 3]))
            cos_a = np.clip((np.trace(correction[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            d_deg = float(np.degrees(np.arccos(cos_a)))
            if d_t > self.cfg.max_corr_t or d_deg > self.cfg.max_corr_deg:
                self.n_rejected += 1
                continue
            out.append((kf_idxs, T_new))
        return out

    def optimize(self):
        """Synchronous dispatch + collect (tests / non-pipelined callers).
        Returns (T_new, correction_of_last_kf) or None."""
        self.drop_pending()
        if not self.dispatch():
            return None
        got = self.collect(drain=True)
        if not got:
            return None
        _, T_new = got[-1]
        return T_new, T_new[-1] @ np.linalg.inv(self.window[-1].pose_c2w)
