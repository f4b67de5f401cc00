"""The refiner's own check numbers (a workload's ``check.extra``: ``"refiner"``).

On the refined path the program returns its refiner's records (``RunResult.refine_log``: the
window solves collected past the cost gate, the pose-graph solves, the verification rounds, the
final corrected keyframes) beside the frame loop's rows (``step_poses``). After the window, the
plain float64 reference (perfbench/reference/window_ba.py, pose_graph.py, correction.py, and the
float32 round of verify.py) works each sampled record out again from its inputs, drawn from
``--seed`` across the window's jobs:

- ``refine_records_missing``: solves and rounds that ``refine_stats`` counts with no record in
  ``refine_log`` (accepted and rejected window solves, accepted graph solves, verified candidates);
  a program that keeps no records gets all of them;
- ``ba_pose_gap`` / ``ba_rot_gap_rad``: up to ``SAMPLES`` window solves, solved again from the
  recorded problem: the widest camera-position gap of the window's poses, in metres over
  (1 m + the distance from the origin), and the widest rotation gap (rad);
- ``graph_pose_gap``: up to ``SAMPLES`` pose-graph solves, solved again from the recorded nodes and
  loop edges with the configuration's edges and weights: the widest node-position gap, relative;
- ``graph_cost_gap``: the same solves: the wider of the gaps of the initial and of the final cost
  from the reference's, over the reference's initial cost (the program's solve takes
  forward-difference Jacobians, which leave its nodes off the optimum along the graph's flattest
  modes by up to about 1e-4 of their distance from the origin, as much as a change of 1e-12 m in
  its start moves them; the cost is flat along those modes, so the costs are held tighter than the
  nodes);
- ``lc_round_mismatches``: up to ``SAMPLES`` rounds, drawn again from the recorded generator state
  over features rebuilt from the keyframes' frames: candidates whose verdict differs, or whose
  inlier count differs by more than one (K3's sums, in their own order, can move a point across
  the inlier threshold);
- ``kf_pose_gap``: every keyframe of every job: the recorded corrected keyframes against the
  reference's ledger (reference/correction.py ``ledger``), replayed from the step rows and every
  window and graph solve's recorded result in the order the refiner applied them, relative; a
  keyframe set that differs counts as ``VERDICT_GAP``;
- ``reanchor_gap``: every frame of every job: the returned ``poses`` against ``step_poses``
  re-anchored onto the recorded corrected keyframes, relative.

A verdict of a solve that differs from the reference's (accepted, rejected by a gate) counts as a
gap of ``VERDICT_GAP``. ``control`` puts the program's own window solve and verification round,
computed with TF32 products on the card, in the program's place (the limits' upper reading).
"""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from perfbench.check import _angle
from perfbench.gen import world as world_mod
from perfbench.reference import correction, pose_graph, verify, window_ba
from perfbench.reference import frame as ref

NUMBERS = (
    "refine_records_missing", "ba_pose_gap", "ba_rot_gap_rad", "graph_pose_gap", "graph_cost_gap", "lc_round_mismatches",
    "kf_pose_gap", "reanchor_gap",
)
SAMPLES = 8
VERDICT_GAP = 1.0


def _log(job):
    return getattr(job.result, "refine_log", None)


def records_missing(res) -> int:
    s, log = res.refine_stats, getattr(res, "refine_log", None)
    win = [w.verdict for w in log.window_solves] if log is not None else []
    graphs = log.graph_solves if log is not None else []
    rounds = log.rounds if log is not None else []
    return (
        max(0, s.get("ba_solves", 0) - win.count("accepted"))
        + max(0, s.get("ba_rejected", 0) - win.count("rejected"))
        + max(0, s.get("loops_closed", 0) - sum(g.T is not None for g in graphs))
        + max(0, s.get("lc_verified", 0) - sum(int(np.sum(r.verdict)) for r in rounds))
    )


def _pick(items: list, seed: int, stream: int) -> list:
    """Up to SAMPLES of ``items``, drawn from ``seed``, in their order."""
    if len(items) <= SAMPLES:
        return items
    rng = np.random.default_rng([int(seed) % 2**64, stream])
    return [items[k] for k in sorted(rng.choice(len(items), size=SAMPLES, replace=False))]


def _rel_gap(Ta, Tb) -> float:
    """Widest position gap of two pose stacks, over 1 m + the distance from the origin."""
    a, b = np.asarray(Ta, np.float64)[..., :3, 3], np.asarray(Tb, np.float64)[..., :3, 3]
    return float((np.linalg.norm(a - b, axis=-1) / (1.0 + np.linalg.norm(b, axis=-1))).max(initial=0.0))


def _rot_gap(Ta, Tb) -> float:
    a, b = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    return max((_angle(x[:3, :3], y[:3, :3]) for x, y in zip(a, b)), default=0.0)


class _Setup:
    """What both sides are held to: the samples and the reference's solves and rounds."""

    def __init__(self, cell, run, device):
        self.cell, self.run, self.device = cell, run, device
        self.cfg = ref.pipeline_config(cell.config["pipeline"])
        w = cell.world
        self.calib = ref.calib(w.P1, w.P2, w.image_size, device)
        self.cam = (self.calib.fu, self.calib.fv, self.calib.cu, self.calib.cv, self.calib.baseline)
        logs = [(j, _log(j)) for j in run.jobs if _log(j) is not None]
        self.windows = _pick([(j, w) for j, log in logs for w in log.window_solves], run.seed, 11)
        self.graphs = _pick([(j, g) for j, log in logs for g in log.graph_solves], run.seed, 12)
        self.rounds = _pick([(j, r) for j, log in logs for r in log.rounds], run.seed, 13)
        self._kfs: dict = {}
        t0 = time.perf_counter()
        with _tf32(False):  # the reference's products in full precision
            self.ref_windows = [window_ba.solve(w.problem._asdict(), self.cam, self.cfg.ba, device, len(w.frame_idx))
                                for _, w in self.windows]
            t1 = time.perf_counter()
            self.ref_graphs = [self._graph(g) for _, g in self.graphs]
            t2 = time.perf_counter()
            self.ref_rounds = [self._round(j, r) for j, r in self.rounds]
        print(f"# refiner check: {len(self.windows)} window solves {t1 - t0:.3f} s, {len(self.graphs)} graph solves "
              f"{t2 - t1:.3f} s, {len(self.rounds)} rounds {time.perf_counter() - t2:.3f} s", file=sys.stderr)

    def _graph(self, gr) -> pose_graph.GraphSolveRef:
        # On the host, as the program solves it: on the card its steps of small float64 operations
        # take about 2 s a solve.
        n = len(gr.frame_idx)
        T0 = torch.as_tensor(gr.T0, dtype=torch.float64)
        loops = [(gr.edge_i[k], gr.edge_j[k], gr.edge_T[k]) for k in range(n - 1, len(gr.edge_i))]
        return pose_graph.solve(T0, *pose_graph.edges(T0, loops, self.cfg.loop), iters=self.cfg.loop.graph_iters)

    def keyframe(self, job, f: int) -> verify.Keyframe:
        key = (job.index, f)
        if key not in self._kfs:
            w, t = self.cell.world, self.cell.traffic
            img = world_mod.noisy_log(w.stage(self.device)[0], w.log[: job.n_frames], t.sensor_noise, self.run.seed,
                                      job.index, frames=[f])[0]
            self._kfs[key] = verify.keyframe(img[0], img[1], self.cfg)
        return self._kfs[key]

    def _round(self, job, r) -> list:
        q = self.keyframe(job, r.query)
        cands = [self.keyframe(job, int(c)) for c in r.candidates]
        return verify.round_(q, cands, self.calib, self.cfg, r.gen_state, self.device)


@contextlib.contextmanager
def _tf32(on: bool):
    """The TF32 flags set to ``on`` for the block, the caller's given back after."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = on
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = old


def _ledger_gap(res, log, ba_cfg) -> float:
    """The recorded corrected keyframes against the reference's replay of the records."""
    order = getattr(log, "order", None)
    if order is None:
        return VERDICT_GAP
    windows = [(w.frame_idx, w.problem.T_c2w[len(w.frame_idx) - 1], w.result.T_c2w, float(w.result.cost0),
                float(w.result.cost)) for w in log.window_solves]
    graphs = [(g.frame_idx, g.T) for g in log.graph_solves]
    fi, want = correction.ledger(res.step_poses, order, windows, graphs, ba_cfg)
    if not np.array_equal(fi, np.asarray(log.kf_frame_idx)):
        return VERDICT_GAP
    return _rel_gap(log.kf_poses, want.numpy())


def _numbers(s: _Setup, window_T: list, round_out: list) -> dict:
    """The numbers of a side: ``window_T`` [(T_c2w [n, 4, 4], verdict)] for the sampled solves,
    ``round_out`` [[(n_inliers, verdict)]] for the sampled rounds; graphs and rows are the program's."""
    where: dict = {}
    ba_t = ba_r = 0.0
    for (job, w), (T, verdict), r in zip(s.windows, window_T, s.ref_windows):
        n = len(w.frame_idx)
        g = _rel_gap(T[:n], r.T_c2w[:n].cpu().numpy())
        rot = _rot_gap(T[:n], r.T_c2w[:n].cpu().numpy())
        if verdict != "stale" and verdict != r.verdict:
            g = rot = VERDICT_GAP
            where.setdefault("ba_verdicts", []).append((job.index, int(w.frame_idx[-1]), verdict, r.verdict))
        if g > ba_t:
            ba_t, where["ba_pose_gap"] = g, (job.index, int(w.frame_idx[-1]))
        ba_r = max(ba_r, rot)
    gp = gc = 0.0
    for (job, gr), r in zip(s.graphs, s.ref_graphs):
        if (gr.T is None) != (r.T is None):
            g = VERDICT_GAP
            where.setdefault("graph_verdicts", []).append((job.index, int(gr.frame_idx[-1]), gr.T is None, r.T is None))
        else:
            g = 0.0 if gr.T is None else _rel_gap(gr.T, r.T.cpu().numpy())
        c = max(abs(gr.cost0 - r.cost0), abs(gr.cost - r.cost)) / max(r.cost0, 1e-300)
        key = (job.index, int(gr.frame_idx[-1]), len(gr.edge_i) - len(gr.frame_idx) + 1)
        if g > gp:
            gp, where["graph_pose_gap"] = g, key
        if c > gc:
            gc, where["graph_cost_gap"] = c, (key, (gr.cost0, gr.cost), (r.cost0, r.cost))
    mism = 0
    for (job, rd), got, want in zip(s.rounds, round_out, s.ref_rounds):
        for c, (n_in, v), w in zip(rd.candidates, got, want):
            if abs(int(n_in) - w.n_inliers) > 1 or bool(v) != w.verdict:
                mism += 1
                where.setdefault("lc_round_mismatches", []).append(
                    (job.index, rd.query, int(c), (int(n_in), bool(v)), (w.n_inliers, w.verdict)))
    kg = rg = 0.0
    for j in s.run.jobs:
        log = _log(j)
        if log is None:
            continue
        g = _ledger_gap(j.result, log, s.cfg.ba)
        if g > kg:
            kg, where["kf_pose_gap"] = g, j.index
        want = correction.reanchor(j.result.step_poses, log.kf_frame_idx - 1, log.kf_poses, s.device).cpu().numpy()
        g = _rel_gap(j.result.poses, want)
        if g > rg:
            rg, where["reanchor_gap"] = g, j.index
    return dict(
        refine_records_missing=sum(records_missing(j.result) for j in s.run.jobs),
        ba_pose_gap=ba_t, ba_rot_gap_rad=ba_r, graph_pose_gap=gp, graph_cost_gap=gc, lc_round_mismatches=mism,
        kf_pose_gap=kg, reanchor_gap=rg,
        where=where,
    )


def values(cell, run, device) -> dict:
    s = _Setup(cell, run, device)
    return _numbers(
        s,
        [(w.result.T_c2w, w.verdict) for _, w in s.windows],
        [list(zip(r.n_inliers, r.verdict)) for _, r in s.rounds],
    )


class _Stuck:
    """A flags module whose ``allow_tf32`` reads True and ignores writes (the rest is the module's)."""

    def __init__(self, real):
        object.__setattr__(self, "_real", real)

    def __getattr__(self, name):
        return True if name == "allow_tf32" else getattr(self._real, name)

    def __setattr__(self, name, value):
        if name != "allow_tf32":
            setattr(self._real, name, value)


@contextlib.contextmanager
def tf32_forced():
    """TF32 products in the block, whatever the code inside sets: the program pins float32 around
    its solvers (utils.precision), so the flags' modules are stood in for by ones that stay on."""
    import torch.backends.cuda as bc

    with _tf32(True):
        mm, cudnn = bc.matmul, torch.backends.cudnn
        bc.matmul, torch.backends.cudnn = _Stuck(mm), _Stuck(cudnn)
        try:
            yield
        finally:
            bc.matmul, torch.backends.cudnn = mm, cudnn


def control(cell, run, device) -> dict:
    """The numbers with the program's window solve and verification round computed with TF32
    products in the program's place, on ``run``'s sampled records (judged against the cell's limits)."""
    from perfbench import check
    from vo_tpu_torch.ba.window import solve_window
    from vo_tpu_torch.convert import ba_problem_from_numpy
    from vo_tpu_torch.geom.camera import calib_from_projections
    from vo_tpu_torch.slam.loop_closure import LoopCloser
    from perfbench.harness import program_config

    s = _Setup(cell, run, device)
    pcfg = program_config(cell.config["pipeline"])
    w = cell.world
    calib = calib_from_projections(w.P1, w.P2, image_size=w.image_size, device=device)
    windows = []
    with tf32_forced():
        for _, rec in s.windows:
            res = solve_window(ba_problem_from_numpy(rec.problem._asdict(), device), calib, pcfg.ba)
            windows.append((res.T_c2w.cpu().numpy(), rec.verdict))
        lc = LoopCloser(calib, pcfg.loop, matcher=pcfg.matcher, device=device, graph=False)
        rounds = []
        for job, rd in s.rounds:
            kfs = [s.keyframe(job, int(c)) for c in rd.candidates]
            kfs += [kfs[0]] * (pcfg.loop.candidate_budget - len(kfs))
            q = s.keyframe(job, rd.query)
            lc._gen.set_state(torch.as_tensor(rd.gen_state))
            ok, n_in, _, n_m = (t.cpu().numpy() for t in lc._verify([(k.l_xy, k.r_xy, k.l_desc, k.s_mask) for k in kfs],
                                                                    q.xy, q.desc, q.mask))
            m = pcfg.loop.min_inliers
            rounds.append([(n_in[b], bool(ok[b]) and n_in[b] >= m and n_m[b] >= m) for b in range(len(rd.candidates))])
    values = _numbers(s, windows, rounds)
    return check.judge(values, cell.check["limits"], NUMBERS)
