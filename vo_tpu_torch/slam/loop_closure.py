"""Loop closure: proximity/appearance-gated detection + geometric verification +
global pose-graph correction (port of vo_tpu.slam.loop_closure).

1. every keyframe is archived (pose, stereo features, descriptors, and a
   unit-norm global descriptor for appearance retrieval);
2. when the current keyframe comes within ``radius`` meters of an archived
   keyframe at least ``min_gap`` keyframes older, or its global descriptor
   is close to one, the pair is VERIFIED on the device: the query's full
   detection set matched against the candidate's stereo set, the
   candidate's stereo pairs triangulated, and RANSAC-P3P estimates the
   current camera's pose in the candidate frame (``min_inliers`` inliers);
3. accepted loops become edges of a global SE(3) pose graph over all
   keyframes, solved on the host in float64 (ba.pose_graph.optimize_np);
4. the caller re-anchors non-keyframe poses on the corrected keyframes.

Verification of a round is dispatched at one keyframe and read at the next:
its outputs are copied to pinned host memory without waiting
(utils.host_copy). A round is the reference's static batch: the candidates
padded to ``cfg.candidate_budget`` with the first one, every one of them
verified (and drawn for), the outputs of the first ``n`` read. On a CUDA card
the round is one CUDA graph per query shape (utils.graphs, the reference's
``jax.jit(_verify_fused)``), captured at the first round of a shape
(``warmup`` makes that round at the production shapes); ``graph=False`` and the CPU verify
eagerly. RANSAC draws from a ``torch.Generator`` on the device, seeded 17 as
the reference seeds ``PRNGKey(17)``, and registered with each graph of the
round; ``_dispatch_verify`` also takes the per-candidate triples (eager
rounds only), so that tests can inject the reference's draws. The host logic (candidates, gates, decimation, the graph
solve) is the reference's numpy code, copied because the reference module
imports jax.

The closer keeps a record of its work as host arrays: every pose-graph solve
(``graph_solves``, ``GraphSolve``: nodes, edges, weights, result or rejection)
and every verification round it reads (``rounds``, ``VerificationRound``: the
query, the candidates, the generator's state before the round, and per
candidate the counts and the verdict). The generator's state is a host read;
nothing is copied from the device for them. A round restored from a
checkpoint has no generator state and is not recorded.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ba import pose_graph as pg
from ..config import LoopConfig, MatcherConfig, RansacConfig
from ..frontend.match import match
from ..geom.camera import StereoCalib
from ..geom.triangulate import triangulate_rectified
from ..pose.ransac import estimate_world_pose
from ..utils import graphs
from ..utils.device import resolve
from ..utils.host_copy import HostCopy, upload
from ..utils.precision import matmul_precision
from ..utils.profiling import span

logger = logging.getLogger(__name__)

__all__ = ["LoopConfig", "ArchivedKeyframe", "LoopCloser", "GraphSolve", "VerificationRound"]  # LoopConfig lives in config


class GraphSolve(NamedTuple):
    """One pose-graph solve (``LoopCloser._solve_graph``), as host arrays."""

    frame_idx: np.ndarray  # [n] int64, the archived keyframes that are the graph's nodes
    T0: np.ndarray  # [n, 4, 4] float64, the nodes' poses before the solve
    edge_i: np.ndarray  # [E] int64: n - 1 odometry edges (k, k + 1), then the loop edges
    edge_j: np.ndarray  # [E] int64
    edge_T: np.ndarray  # [E, 4, 4] float64, the measured T_i^-1 T_j
    edge_weight: np.ndarray  # [E] float64
    T: Optional[np.ndarray]  # [n, 4, 4] float64 as returned; None where the solve was rejected
    cost0: float
    cost: float


class VerificationRound(NamedTuple):
    """One verification round, read one keyframe after its dispatch, as host arrays."""

    query: int  # frame index of the keyframe verified
    candidates: np.ndarray  # [n] int64 frame indices in the round's order (the round pads them with the first)
    gen_state: np.ndarray  # uint8, the RANSAC generator's state before the round
    ok: np.ndarray  # [n] bool, RANSAC's own success flag
    n_inliers: np.ndarray  # [n] int64
    n_matches: np.ndarray  # [n] int64, depth-gated matches
    verdict: np.ndarray  # [n] bool: matches and inliers >= min_inliers and ok


@dataclasses.dataclass
class ArchivedKeyframe:
    frame_idx: int
    pose_c2w: np.ndarray
    l_px: np.ndarray | None
    r_px: np.ndarray | None
    l_desc: np.ndarray | None
    mask: np.ndarray | None
    global_desc: np.ndarray | None = None  # [128] masked-mean SIFT desc, unit norm
    path_m: float = 0.0  # cumulative trajectory length when archived (drift gate)
    # Device tensors (l_px, r_px, l_desc, mask) for verification. The refiner
    # passes the step's own tensors through, so verification never uploads.
    dev: tuple | None = None


def _global_desc(l_desc: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Unit-norm masked mean of the keyframe's SIFT descriptors (BoW-lite).

    Individual SIFT descriptors are unit-ish and non-negative, so the mean
    over a few hundred of them is a stable scene signature: cosine similarity
    between revisits of the same place stays high while drift moves the pose
    arbitrarily far. One [K, 128] @ [128] matvec retrieves over the archive.
    """
    m = mask.astype(np.float32)[:, None]
    s = (l_desc * m).sum(axis=0) / max(float(m.sum()), 1.0)
    n = float(np.linalg.norm(s))
    return (s / n if n > 1e-12 else s).astype(np.float32)


class LoopCloser:
    def __init__(
        self,
        calib: StereoCalib,
        cfg: LoopConfig,
        ransac: RansacConfig | None = None,
        matcher: MatcherConfig | None = None,
        device=None,
        graph=None,
    ):
        """``graph``: None verifies through CUDA graphs on a CUDA device and eagerly on the CPU,
        False eagerly, True on the CPU raises (module docstring)."""
        self.device = resolve(device)
        self.calib = calib.to(self.device)
        self.cfg = cfg
        self.ransac = ransac or RansacConfig(n_hypotheses=256)
        self.matcher = matcher or MatcherConfig()
        self.keyframes: list[ArchivedKeyframe] = []
        self.loop_edges: list[tuple[int, int, np.ndarray]] = []  # (old_k, new_k, Z)
        self.decimations = 0  # capacity-decimation count (observability)
        self.skipped_small = 0  # closures skipped by the min_correction gate
        # (path_delta_m, disc_m, gate_m, fired) per verified candidate, the
        # most recent _disc_cap of them; n_verified counts all.
        self.disc_events: list[tuple] = []
        self._disc_cap = 1024
        self.n_verified = 0
        self._cooldown_left = 0
        # In-flight verification round: (verified_frame_idx, [cand frame_idx],
        # HostCopy of the outputs). Dispatched at keyframe t, collected at t+1.
        self._pending = None
        self._pending_gen: Optional[np.ndarray] = None  # the generator's state before that round
        self.graph_solves: list[GraphSolve] = []
        self.rounds: list[VerificationRound] = []
        # Wall-clock per phase (candidates / dispatch / collect / solve), spans
        # vo_tpu_torch.refiner.lc.<phase>, exported through refiner stats as worker_lc_<phase>_s.
        self.phase_s: dict[str, float] = {}
        self._path_m = 0.0  # cumulative keyframe-chain trajectory length
        self._last_t: np.ndarray | None = None
        # Verification matches the query's FULL detection set against the
        # candidate's stereo (3D-able) set with a permissive ratio test, not
        # mutual: only the candidate side needs depth, and RANSAC absorbs the
        # permissive matcher's extra outliers (see the reference for the
        # measured recall difference).
        self._verify_matcher = dataclasses.replace(
            self.matcher, max_ratio=cfg.verify_ratio, mutual=cfg.verify_mutual
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(17)
        # The captured rounds, one per shape (None: eager). They hold _gen: a resume sets its
        # state, never a new generator.
        self._rounds = (
            graphs.ByShape(self._verify, self.device, "verification_round", generators=(self._gen,))
            if graphs.wanted(graph, self.device)
            else None
        )

    @matmul_precision("float32")
    def _verify(self, devs, cur_lpx, cur_desc, cur_mask, triples=None):
        """match -> triangulate -> RANSAC-P3P per candidate; returns stacked (ok [B], n_inliers [B],
        poses [B,4,4], n_matches [B]) on the device. ``triples[b]`` [H, 3] replaces candidate b's draw."""
        cfg, calib = self.cfg, self.calib
        outs = []
        for b, (lpx, rpx, desc, cmask) in enumerate(devs):
            m = match(cur_desc, cur_mask, desc, cmask, self._verify_matcher, cfg.match_capacity)
            X_cand = triangulate_rectified(lpx, rpx, calib)
            Xm = X_cand.index_select(0, m.b_idx)
            px = cur_lpx.index_select(0, m.a_idx)
            depth_ok = (Xm[:, 2] > 0.5) & (Xm[:, 2] < 150.0)
            msk = m.mask & depth_ok
            est = estimate_world_pose(
                px, Xm, msk, calib, self.ransac, gen=self._gen, triples=None if triples is None else triples[b]
            )
            # Quick-reject support count is the POST-depth-gate match count
            # (the set RANSAC actually scores), not raw matches.
            outs.append((est.ok, est.n_inliers, est.pose_c2w, msk.sum()))
        return tuple(torch.stack(o) for o in zip(*outs))

    def warmup(self, capacity: int, query_capacity: int | None = None) -> None:
        """Run one verification round on the production shapes (``capacity`` = max_tracks for
        the archived stereo side, ``query_capacity`` = max_keypoints for the full-query side;
        graphed: the capture, then one replay) before the timed loop; the RANSAC stream is left
        where it was."""
        d = self.device
        Q = capacity if query_capacity is None else query_capacity
        z = (
            torch.zeros((capacity, 2), device=d),
            torch.zeros((capacity, 2), device=d),
            torch.zeros((capacity, 128), device=d),
            torch.zeros(capacity, dtype=torch.bool, device=d),
        )
        query = (torch.zeros((Q, 2), device=d), torch.zeros((Q, 128), device=d), torch.zeros(Q, dtype=torch.bool, device=d))
        state = self._gen.get_state()
        HostCopy(*self._round((z,) * self.cfg.candidate_budget, query)).numpy()
        self._gen.set_state(state)

    def _round(self, devs, query, triples=None):
        """The padded round over ``devs`` (``cfg.candidate_budget`` candidates): the eager
        ``_verify``, or the replay of its graph for these shapes."""
        if self._rounds is None:
            return self._verify(devs, *query, triples=triples)
        if triples is not None:
            raise ValueError("triples are injected into eager rounds only: make the LoopCloser with graph=False")
        return self._rounds(devs, *query)

    # -- detection ----------------------------------------------------------
    def _candidates(self, pose: np.ndarray, gdesc: np.ndarray | None = None) -> list[int]:
        """Union of the metric-proximity and appearance-retrieval channels.

        Proximity alone fails under exactly the drift closure exists to fix
        (the reference drifts 41 m, 4500/error.png, vs the 10 m radius);
        appearance retrieval is drift-independent (VERDICT r2 item 5).
        """
        t = pose[:3, 3]
        horizon = max(0, len(self.keyframes) - self.cfg.min_gap)
        near = []
        for k in range(horizon):
            d = np.linalg.norm(self.keyframes[k].pose_c2w[:3, 3] - t)
            if d < self.cfg.radius:
                near.append(k)
        # Nearest few only.
        near.sort(key=lambda k: np.linalg.norm(self.keyframes[k].pose_c2w[:3, 3] - t))
        out = near[:3]
        if self.cfg.appearance and gdesc is not None and horizon > 0:
            G = np.stack(
                [self.keyframes[k].global_desc for k in range(horizon)]
            )  # [K, 128], unit rows
            sim = G @ gdesc
            order = np.argsort(-sim)[: self.cfg.appearance_top_k]
            for k in order:
                if sim[k] >= self.cfg.appearance_min_sim and int(k) not in out:
                    out.append(int(k))
        # The whole budget is verified in ONE fused device call; cap it so a
        # dense revisit can't stall the worker.
        return out[: self.cfg.candidate_budget]


    # -- verification -------------------------------------------------------
    def _dev_of(self, kf: ArchivedKeyframe) -> tuple:
        if kf.dev is None:
            kf.dev = tuple(
                upload(torch.from_numpy(np.ascontiguousarray(a, dt)), self.device)
                for a, dt in ((kf.l_px, np.float32), (kf.r_px, np.float32), (kf.l_desc, np.float32), (kf.mask, bool))
            )
        return kf.dev

    def _dispatch_verify(
        self, cands: list[ArchivedKeyframe], cur: ArchivedKeyframe, query_dev=None, triples=None
    ) -> HostCopy:
        """Verify every candidate on the current stream; returns the outputs' host copy,
        started and NOT waited for. The result is read one keyframe later
        (_collect_verify): a one-keyframe-late closure decision costs nothing,
        while waiting here would serialize the worker against the frame loop.

        ``query_dev`` — (xy, desc, mask) device tensors of the verified
        keyframe's FULL detection set (the production path); falls back to
        its archived stereo subset when absent (direct-API callers).
        ``triples`` — optional per-candidate [H, 3] RANSAC samples, one for each of the
        ``cfg.candidate_budget`` candidates of the padded round (eager rounds only)."""
        B = self.cfg.candidate_budget
        padded = list(cands) + [cands[0]] * (B - len(cands))  # the reference's static batch; extras ignored
        devs = tuple(self._dev_of(c) for c in padded)
        if query_dev is None:
            d = self._dev_of(cur)
            query_dev = (d[0], d[2], d[3])
        if self.device.type == "cuda":
            # These tensors come from the frame loop's stream: keep the
            # allocator from handing their memory back to it while this
            # stream's work on them is pending.
            stream = torch.cuda.current_stream(self.device)
            for t in [t for dv in devs for t in dv] + list(query_dev):
                t.record_stream(stream)
        return HostCopy(*self._round(devs, tuple(query_dev), triples))

    @staticmethod
    def _collect_verify(outs: HostCopy, n: int, min_inliers: int) -> list[Optional[np.ndarray]]:
        """Read a dispatched round: per candidate, Z = pose of the verified
        camera in the candidate camera frame, or None."""
        ok, n_inliers, poses, n_matches = outs.numpy()
        out: list[Optional[np.ndarray]] = []
        for b in range(n):
            good = (
                int(n_matches[b]) >= min_inliers
                and bool(ok[b])
                and int(n_inliers[b]) >= min_inliers
            )
            out.append(poses[b] if good else None)
        return out

    # -- public API ---------------------------------------------------------
    def add_keyframe(self, kf: ArchivedKeyframe, query_dev=None) -> Optional[dict]:
        """Archive kf, try to close a loop, and if one verifies, re-optimize
        the global graph. Returns {'corrected': [K,4,4], 'loop': (old,new)}
        or None. ``query_dev`` — (xy, desc, mask) device refs of kf's FULL
        detection set for the verification query side (_dispatch_verify).

        Verification is PIPELINED one keyframe deep: this call collects the
        round dispatched at the previous keyframe (so an accepted closure is
        reported one keyframe late — 5 frames — which costs nothing) and
        dispatches a new round for ``kf`` without blocking on the device.
        Call flush() at end of run to collect the final in-flight round.

        At node capacity the keyframe set is DECIMATED (every 2nd keyframe
        kept, newest always kept) instead of silently freezing: the graph
        keeps covering the whole trajectory at half temporal resolution, so
        arbitrarily long sequences stay closable (KITTI 00 is 4,541 frames).
        """
        if kf.global_desc is None:
            kf.global_desc = _global_desc(kf.l_desc, kf.mask)
        t = kf.pose_c2w[:3, 3]
        if self._last_t is not None:
            self._path_m += float(np.linalg.norm(t - self._last_t))
        self._last_t = t.copy()
        kf.path_m = self._path_m
        self.keyframes.append(kf)
        if len(self.keyframes) > self.cfg.max_keyframes:
            self._decimate()
        # Collect the round dispatched at the previous keyframe FIRST (its
        # async host copies have had a full keyframe period to complete).
        result = self._collect_pending()
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return result
        with span("vo_tpu_torch.refiner.lc.candidates", total=self.phase_s):
            cand_idx = self._candidates(kf.pose_c2w, kf.global_desc)
        if not cand_idx:
            return result
        # Pace verification: a revisit keeps proposing the same neighborhood
        # for tens of keyframes; one round per verify_cooldown keyframes
        # bounds the device dispatches without losing recall.
        self._cooldown_left = max(self._cooldown_left, self.cfg.verify_cooldown)
        with span("vo_tpu_torch.refiner.lc.dispatch", total=self.phase_s):
            self._pending_gen = self._gen.get_state().numpy()
            outs = self._dispatch_verify([self.keyframes[k] for k in cand_idx], kf, query_dev=query_dev)
        self._pending = (
            kf.frame_idx,
            [self.keyframes[k].frame_idx for k in cand_idx],
            outs,
        )
        return result

    def flush(self) -> Optional[dict]:
        """Collect the final in-flight verification round (end of run)."""
        return self._collect_pending()

    def _collect_pending(self) -> Optional[dict]:
        """Read the round dispatched at the PREVIOUS keyframe and run the
        gate / graph-solve logic on it. Keyframes are resolved by frame_idx
        (a decimation may have run since dispatch)."""
        if self._pending is None:
            return None
        ver_fi, cand_fis, outs = self._pending
        gen_state, self._pending, self._pending_gen = self._pending_gen, None, None
        by_fi = {k.frame_idx: i for i, k in enumerate(self.keyframes)}
        if ver_fi not in by_fi:
            return None  # verified keyframe was decimated away
        cur_k = by_fi[ver_fi]
        kf = self.keyframes[cur_k]
        with span("vo_tpu_torch.refiner.lc.collect", total=self.phase_s):
            Zs = self._collect_verify(outs, len(cand_fis), self.cfg.min_inliers)
            if gen_state is not None:
                n = len(cand_fis)
                ok, n_inl, _, n_m = outs.numpy()
                self.rounds.append(
                    VerificationRound(
                        query=int(ver_fi), candidates=np.asarray(cand_fis, np.int64), gen_state=gen_state,
                        ok=np.asarray(ok[:n], bool), n_inliers=np.asarray(n_inl[:n], np.int64),
                        n_matches=np.asarray(n_m[:n], np.int64), verdict=np.array([Z is not None for Z in Zs]),
                    )
                )
        for cf, Z in zip(cand_fis, Zs):
            if Z is None or cf not in by_fi:
                continue
            k = by_fi[cf]
            # Benefit gate: the loop implies the current camera sits at
            # cand_pose @ Z; if that only disagrees with the chained pose by
            # less than the expected noise, the "correction" is verification
            # noise — skip rather than degrade an accurate trajectory. The
            # threshold is DRIFT-AWARE (VERDICT r3 item 3): plausible drift
            # scales with the trajectory length traveled since the candidate
            # (drift_frac), floored at the verification-noise level and
            # capped at min_correction, so short loops stay closable (a 0.5 m
            # correction after a 100 m loop is real drift; after 5 m it is
            # noise) while a fixed 1.0 m gate no longer disables closure on
            # every sub-kilometer trajectory.
            implied = self.keyframes[k].pose_c2w @ Z
            disc = float(np.linalg.norm(implied[:3, 3] - kf.pose_c2w[:3, 3]))
            gate = float(
                np.clip(
                    self.cfg.drift_frac * (kf.path_m - self.keyframes[k].path_m),
                    self.cfg.min_correction_floor,
                    self.cfg.min_correction,
                )
            )
            self.disc_events.append(
                (round(kf.path_m - self.keyframes[k].path_m, 1), round(disc, 3), round(gate, 3), disc >= gate)
            )
            self.n_verified += 1
            if len(self.disc_events) > self._disc_cap:
                del self.disc_events[: -self._disc_cap]
            if not np.isfinite(Z).all():
                continue  # NaN-poisoned measurement: never let it into the graph
            if disc < gate:
                self.skipped_small += 1
                # "Too consistent to correct" is still a VERIFIED rigid
                # constraint: keep it as a graph edge (no solve — solves are
                # ~5 s of f64 host work at reference scale and a sub-gate
                # disc means the current estimate already satisfies the
                # edge). Accumulated revisit edges pin each stretch to its
                # earlier pass in every LATER solve. Measured effect on the
                # severity feed is neutral on xz mean (3.53 vs 3.36 m,
                # within run variance) but it makes the final solve's
                # constraint set complete rather than one-edge-per-loop —
                # kept for robustness, not as a measured accuracy win.
                # Near-duplicate pairs are skipped so a long revisit cannot
                # evict real closures from the bounded edge list.
                if not self._near_duplicate_edge(k, cur_k):
                    self.loop_edges.append((k, cur_k, Z))
                    if len(self.loop_edges) > self.cfg.max_loop_edges:
                        self.loop_edges.pop(0)
                # Medium cooldown: drift keeps growing, so a revisit that is
                # "too consistent" now may deserve a closure later — but
                # re-verifying every keyframe of a long revisit is the single
                # biggest worker cost.
                self._cooldown_left = max(self._cooldown_left, self.cfg.cooldown // 2)
                continue
            self.loop_edges.append((k, cur_k, Z))
            if len(self.loop_edges) > self.cfg.max_loop_edges:
                self.loop_edges.pop(0)
            with span("vo_tpu_torch.refiner.lc.solve", total=self.phase_s):
                corrected = self._solve_graph()
            if corrected is not None:
                self._cooldown_left = self.cfg.cooldown
                # Path bookkeeping tracks the CORRECTED chain: refresh the
                # last-position sample or the next keyframe's path increment
                # includes the full closure correction as phantom distance.
                self._last_t = self.keyframes[-1].pose_c2w[:3, 3].copy()
                return dict(corrected=corrected, loop=(k, cur_k))
            # Rejected solve (non-finite or cost-increasing): pop the edge
            # that triggered it so one bad measurement cannot permanently
            # poison every subsequent solve (ADVICE r4).
            self.loop_edges.pop()
        return None

    def _near_duplicate_edge(self, a: int, b: int, tol: int = 2) -> bool:
        """An edge between (almost) the same keyframe pair already exists."""
        return any(abs(ea - a) <= tol and abs(eb - b) <= tol for ea, eb, _ in self.loop_edges)

    def _decimate(self) -> None:
        """Halve keyframe density: keep even-position keyframes + the newest.

        Loop edges are index pairs into ``keyframes``; endpoints that are
        decimated away are REANCHORED onto their nearest surviving neighbor
        by composing the measurement with the current relative estimate
        (Z' = inv(T_surv) T_dropped Z for the source side) — the gap to the
        neighbor is one keyframe (~meters of travel), so the composition
        adds negligible odometry error while keeping the closure constraint
        alive (previously dropped: BIGRUN probes logged '0/1 loop edges
        kept', losing each closure's constraint at the next decimation).
        Odometry edges are rebuilt from the surviving poses at the next
        solve, so no relative measurement goes stale."""
        n = len(self.keyframes)
        keep = [i for i in range(n) if i % 2 == 0 or i == n - 1]
        remap = {old: new for new, old in enumerate(keep)}
        keep_arr = np.asarray(keep)
        T_old = [kf.pose_c2w.astype(np.float64) for kf in self.keyframes]
        n_edges_before = len(self.loop_edges)

        def reanchor(idx: int) -> tuple[int, np.ndarray, np.ndarray]:
            """(new_index, T_anchor_old, T_orig_old) for a pre-decimation index."""
            if idx in remap:
                return remap[idx], T_old[idx], T_old[idx]
            j = int(keep_arr[np.argmin(np.abs(keep_arr - idx))])
            return remap[j], T_old[j], T_old[idx]

        new_edges = []
        for a, b, Z in self.loop_edges:
            na, Ta_s, Ta = reanchor(a)
            nb, Tb_s, Tb = reanchor(b)
            if na == nb:
                continue  # both endpoints collapsed onto one keyframe
            # Z maps candidate(a) frame -> verified(b) camera: T_a Z ~ T_b.
            # Reanchored: T_a' Z' ~ T_b' with Z' = inv(T_a') T_a Z inv(T_b) T_b'.
            Zn = np.linalg.inv(Ta_s) @ Ta @ np.asarray(Z, np.float64) @ np.linalg.inv(Tb) @ Tb_s
            new_edges.append((na, nb, Zn.astype(np.float32)))
        self.keyframes = [self.keyframes[i] for i in keep]
        self.loop_edges = new_edges
        self.decimations += 1
        logger.warning(
            "LoopCloser at node capacity (%d): decimated to %d keyframes "
            "(%d/%d loop edges kept, decimation #%d)",
            n, len(self.keyframes), len(self.loop_edges), n_edges_before, self.decimations,
        )

    def _solve_graph(self) -> Optional[np.ndarray]:
        """Exact-size f64 host solve (pg.optimize_np). Runs on the refiner
        worker thread, once per accepted closure — a float32 pose-graph
        solve (the reference's jitted pg.optimize) under-corrects at this
        node count: the chain-redistribution modes have curvature ~O(1/n^2)
        and fall below f32 resolution against the gauge anchor (see the
        ba.pose_graph module docstring)."""
        n = len(self.keyframes)
        T0 = np.stack([kf.pose_c2w for kf in self.keyframes]).astype(np.float64)
        ei = list(range(n - 1))
        ej = list(range(1, n))
        eT = [
            np.linalg.inv(T0[k]) @ T0[k + 1] for k in range(n - 1)
        ]
        ew = [self.cfg.odometry_weight] * (n - 1)
        for a, b, Z in self.loop_edges:
            ei.append(a)
            ej.append(b)
            eT.append(np.asarray(Z, np.float64))
            ew.append(self.cfg.loop_weight)
        edges = (np.asarray(ei, np.int64), np.asarray(ej, np.int64), np.stack(eT), np.asarray(ew, np.float64))
        T, cost0, cost = pg.optimize_np(T0, *edges, iters=self.cfg.graph_iters)
        rejected = not np.isfinite(cost) or cost > cost0
        self.graph_solves.append(
            GraphSolve(
                np.asarray([kf.frame_idx for kf in self.keyframes], np.int64), T0, *edges,
                None if rejected else T, float(cost0), float(cost),
            )
        )
        if rejected:
            return None
        T = T.astype(np.float32)
        for k, kf in enumerate(self.keyframes):
            kf.pose_c2w = T[k]
        return T
