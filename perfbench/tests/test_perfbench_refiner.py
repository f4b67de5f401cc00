"""The refiner's check (checks/refiner.py) and its plain reference, on the CPU at a small size.

- The reference's solvers against the program's on seeded problems: the window BA
  (reference/window_ba.py against ``ba.window.solve_window``), the pose graph (reference/pose_graph.py
  against ``ba.pose_graph.optimize_np``), a verification round (reference/verify.py against
  ``LoopCloser._verify``, eager, from one generator state) and re-anchoring
  (reference/correction.py against ``odometry.correction.reanchor_trajectory``).
- A small ``slam.offline`` run through ``harness.run_cell`` comes out correct, with window solves,
  verification rounds and pose-graph solves to check (the loop closer's gates opened so that its
  31-frame logs close loops).
- Each fault planted in the refiner comes out not correct, on the number that should see it: a
  solve's output moved 1 cm, one LM iteration left out, a loop edge's weight halved, one keyframe
  left out of the re-anchoring, a round's inlier threshold changed, the window solves' results kept
  from the keyframe ledger, a closure not propagated over it.

The TF32 control runs on the card (test_perfbench_refiner_control.py).
"""
import copy
import sys
import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import correction, pose_graph, verify, window_ba
from perfbench.reference import frame as ref

from .conftest import REFINED

SEED = 2**33 + 29
# REFINED on the cell, with the loop closer's gates opened: candidates two keyframes back, every
# verified loop closed, every keyframe verified.
SLAM = copy.deepcopy(REFINED)
SLAM["config"]["pipeline"]["loop"] = dict(min_gap=2, min_correction=0.0, min_correction_floor=0.0, cooldown=0, verify_cooldown=0)


def _run():
    code, out = harness.run_cell("slam.offline", SEED, 100.0, False, time.perf_counter(), device="cpu", overrides=SLAM, workers=2)
    assert code == 0
    print({k: v["value"] for k, v in out["checks"].items()})
    return out


def _failed(out):
    return sorted(k for k, v in out["checks"].items() if not v["value"] <= v["limit"])


@pytest.fixture(scope="module")
def cell():
    return harness.Cell("slam.offline", SLAM)


def _window_problem(rng, calib, K=6, M=120):
    """A window of K keyframes 1 m apart along the optical axis, M landmarks 5-30 m ahead, stereo
    observations with 0.3 px of noise, the poses perturbed by a few cm and mrad."""
    fu, fv, cu, cv, b = calib
    T = np.tile(np.eye(4), (K, 1, 1))
    T[:, 2, 3] = np.arange(K)
    X = np.stack([rng.uniform(-8, 8, M), rng.uniform(-2, 2, M), rng.uniform(5, 30, M)], -1) + [0, 0, K]
    obs_uv = np.zeros((K, M, 2))
    obs_ur = np.zeros((K, M))
    for k in range(K):
        xc = X - T[k, :3, 3]
        obs_uv[k] = np.stack([fu * xc[:, 0] / xc[:, 2] + cu, fv * xc[:, 1] / xc[:, 2] + cv], -1)
        obs_ur[k] = fu * (xc[:, 0] - b) / xc[:, 2] + cu
    obs_uv += rng.normal(scale=0.3, size=obs_uv.shape)
    obs_ur += rng.normal(scale=0.3, size=obs_ur.shape)
    obs_mask = rng.random((K, M)) < 0.8
    T0 = T.copy()
    T0[1:, :3, 3] += rng.normal(scale=0.03, size=(K - 1, 3))
    X0 = X + rng.normal(scale=0.05, size=X.shape)
    kf_mask = np.ones(K, bool)
    kf_mask[-1] = False  # an unused slot stays frozen
    return dict(
        T_c2w=T0.astype(np.float32), X=X0.astype(np.float32), obs_uv=obs_uv.astype(np.float32), obs_mask=obs_mask,
        obs_ur=obs_ur.astype(np.float32), obs_ur_mask=obs_mask, X_mask=np.ones(M, bool), kf_mask=kf_mask,
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_window_ba_is_the_programs(cell, seed):
    from vo_tpu_torch.ba.window import solve_window
    from vo_tpu_torch.convert import ba_problem_from_numpy
    from vo_tpu_torch.geom.camera import calib_from_projections

    rng = np.random.default_rng(seed)
    w = cell.world
    calib = calib_from_projections(w.P1, w.P2, image_size=w.image_size, device="cpu")
    cam = (calib.fu, calib.fv, calib.cu, calib.cv, calib.baseline)
    cfg = ref.pipeline_config(cell.config["pipeline"]).ba
    prob = _window_problem(rng, cam)
    got = solve_window(ba_problem_from_numpy(prob, "cpu"), calib, harness.program_config(cell.config["pipeline"]).ba)
    want = window_ba.solve(prob, cam, cfg, "cpu", n_kf=5)
    assert want.verdict == "accepted" and want.cost < 0.5 * want.cost0
    T, R = got.T_c2w.double().numpy(), want.T_c2w.numpy()
    assert np.abs(T[:, :3, 3] - R[:, :3, 3]).max() < 2e-5
    assert np.abs(T[:, :3, :3] - R[:, :3, :3]).max() < 2e-5
    assert np.abs(R[:, :3, 3] - prob["T_c2w"][:, :3, 3]).max() > 1e-3  # the solve moved the poses
    np.testing.assert_array_equal(R[-1], prob["T_c2w"][-1])  # the frozen slot stayed
    assert abs(float(got.cost) - want.cost) <= 1e-4 * want.cost


def _chain(rng, n):
    from vo_tpu_torch.ba.pose_graph import _np_exp_se3

    T = [np.eye(4)]
    for _ in range(n - 1):
        step = np.concatenate([[0.0, 0.0, 1.0] + rng.normal(scale=0.05, size=3), rng.normal(scale=0.02, size=3)])
        T.append(T[-1] @ _np_exp_se3(step))
    return np.stack(T)


@pytest.mark.parametrize("seed", [5, 6])
def test_pose_graph_is_the_programs(cell, seed):
    from vo_tpu_torch.ba.pose_graph import _np_exp_se3, optimize_np

    rng = np.random.default_rng(seed)
    cfg = ref.pipeline_config(cell.config["pipeline"]).loop
    n = 40
    truth = _chain(rng, n)
    # The chain as odometry drifted it, and three loops measured against the truth.
    drift = [np.eye(4)]
    for k in range(1, n):
        noise = _np_exp_se3(np.concatenate([rng.normal(scale=0.02, size=3), rng.normal(scale=0.003, size=3)]))
        drift.append(drift[-1] @ np.linalg.inv(truth[k - 1]) @ truth[k] @ noise)
    T0 = np.stack(drift)
    loops = [(a, b, np.linalg.inv(truth[a]) @ truth[b]) for a, b in ((0, 30), (5, 38), (12, 25))]
    ei = np.array(list(range(n - 1)) + [a for a, _, _ in loops])
    ej = np.array(list(range(1, n)) + [b for _, b, _ in loops])
    eT = np.stack([np.linalg.inv(T0[k]) @ T0[k + 1] for k in range(n - 1)] + [Z for _, _, Z in loops])
    ew = np.array([cfg.odometry_weight] * (n - 1) + [cfg.loop_weight] * len(loops))
    T, cost0, cost = optimize_np(T0, ei, ej, eT, ew, iters=cfg.graph_iters)
    T0_t = torch.as_tensor(T0)
    r = pose_graph.solve(T0_t, *pose_graph.edges(T0_t, loops, cfg), iters=cfg.graph_iters)
    assert cost < 0.1 * cost0 and abs(r.cost0 - cost0) <= 1e-9 * cost0
    assert np.abs(r.T.numpy()[:, :3, 3] - T[:, :3, 3]).max() < 1e-6  # forward differences against exact Jacobians
    assert np.abs(r.T.numpy()[:, :3, 3] - T0[:, :3, 3]).max() > 0.1  # the loops moved the chain


def test_verification_round_is_the_programs(cell):
    from vo_tpu_torch.geom.camera import calib_from_projections
    from vo_tpu_torch.slam.loop_closure import LoopCloser

    from perfbench.gen import world

    w, t = cell.world, cell.traffic
    cfg = ref.pipeline_config(cell.config["pipeline"])
    pcfg = harness.program_config(cell.config["pipeline"])
    imgs = world.noisy_log(w.stage("cpu", 2)[0], w.log, t.sensor_noise, SEED, 0, frames=[5, 10, 20, 25])
    kfs = [verify.keyframe(x[0], x[1], cfg) for x in imgs]
    lc = LoopCloser(calib_from_projections(w.P1, w.P2, image_size=w.image_size, device="cpu"), pcfg.loop,
                    matcher=pcfg.matcher, device="cpu", graph=False)
    calib = ref.calib(w.P1, w.P2, w.image_size, "cpu")
    for q, cands in ((2, [1, 0]), (3, [0, 1, 2])):  # frame 20 (GT 10) and 25 (GT 5) against the way out
        state = lc._gen.get_state().numpy()
        padded = cands + [cands[0]] * (pcfg.loop.candidate_budget - len(cands))
        ok, n_in, _, n_m = (a.numpy() for a in lc._verify(
            [(kfs[c].l_xy, kfs[c].r_xy, kfs[c].l_desc, kfs[c].s_mask) for c in padded], kfs[q].xy, kfs[q].desc, kfs[q].mask))
        want = verify.round_(kfs[q], [kfs[c] for c in cands], calib, cfg, state, "cpu")
        assert [v.n_inliers for v in want] == list(n_in[: len(cands)])
        assert [v.n_matches for v in want] == list(n_m[: len(cands)]) and [v.ok for v in want] == list(ok[: len(cands)])
        assert want[0].verdict  # the revisit verifies


def test_reanchoring_is_the_programs():
    from vo_tpu_torch.odometry.correction import reanchor_trajectory

    rng = np.random.default_rng(7)
    P = _chain(rng, 60).astype(np.float32)
    rows = np.array([4, 9, 14, 30, 59])
    K = _chain(rng, 5).astype(np.float32) + 0.0
    got = reanchor_trajectory(P, rows, K)
    want = correction.reanchor(P, rows[::-1], K[::-1], "cpu").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(want[:4], P[:4])


def test_sound_run_is_correct():
    out = _run()
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is True and not _failed(out), checks
    assert checks["refine_records_missing"] == 0 and checks["lc_round_mismatches"] == 0


def _solve_fault(monkeypatch, fault):
    from vo_tpu_torch.odometry import ba_runner

    solve = ba_runner.solve_window

    def planted(prob, calib, cfg, group=None):
        return fault(solve, prob, calib, cfg, group)

    monkeypatch.setattr(ba_runner, "solve_window", planted)


def test_solve_output_moved(monkeypatch):
    def moved(solve, prob, calib, cfg, group):
        res = solve(prob, calib, cfg, group)
        T = res.T_c2w.clone()
        T[:, 0, 3] += 0.01
        return res._replace(T_c2w=T)

    _solve_fault(monkeypatch, moved)
    out = _run()
    assert out["correct"] is False and "ba_pose_gap" in _failed(out)


def test_one_lm_iteration_left_out(monkeypatch):
    """At the configuration's 8 iterations the solves have converged to float32 rounding by the
    4th, so that a missing last one changes no pose beyond it (ba_pose_gap 1.8e-7 against 2.7e-7
    sound at this size); the case runs the cell at 3 iterations, and the fault does 2."""
    _solve_fault(monkeypatch, lambda solve, prob, calib, cfg, group: solve(prob, calib, dataclasses.replace(cfg, iters=cfg.iters - 1), group))
    monkeypatch.setitem(SLAM["config"]["pipeline"], "ba", dict(iters=3))
    out = _run()
    assert out["correct"] is False and {"ba_pose_gap", "ba_rot_gap_rad"} & set(_failed(out))


def test_loop_edge_weight_halved(monkeypatch):
    from vo_tpu_torch.slam import loop_closure

    optimize = loop_closure.pg.optimize_np

    def halved(T0, ei, ej, eT, ew, iters):
        ew = np.array(ew)
        ew[-1] *= 0.5  # the newest loop edge
        return optimize(T0, ei, ej, eT, ew, iters=iters)

    monkeypatch.setattr(loop_closure.pg, "optimize_np", halved)
    out = _run()
    assert out["correct"] is False and "graph_cost_gap" in _failed(out)


def test_keyframe_left_out_of_reanchoring(monkeypatch):
    from vo_tpu_torch.odometry import runner

    reanchor = runner.reanchor_trajectory

    def one_less(poses, rows, kf_poses):
        keep = np.arange(len(rows)) != len(rows) // 2
        return reanchor(poses, rows[keep], kf_poses[keep])

    monkeypatch.setattr(runner, "reanchor_trajectory", one_less)
    out = _run()
    assert out["correct"] is False and _failed(out) == ["reanchor_gap"]


def test_round_inlier_threshold_changed(monkeypatch):
    from vo_tpu_torch.slam import loop_closure

    init = loop_closure.LoopCloser.__init__

    def wider(self, *a, **k):
        init(self, *a, **k)
        self.ransac = dataclasses.replace(self.ransac, max_reproj_err_px=0.5 * self.ransac.max_reproj_err_px)

    monkeypatch.setattr(loop_closure.LoopCloser, "__init__", wider)
    out = _run()
    assert out["correct"] is False and "lc_round_mismatches" in _failed(out)


class _WindowWritesDropped(dict):
    """A keyframe ledger that takes a keyframe's entry and the closures' moves, but drops the window
    solves' results (a write from the worker's collect: a key it holds already)."""

    def __setitem__(self, key, value):
        if key in self and sys._getframe(1).f_code.co_name in ("_process", "_finalize"):
            return
        super().__setitem__(key, value)


def test_window_results_kept_from_the_keyframes(monkeypatch):
    from vo_tpu_torch.odometry import refiner

    init = refiner.RefinerWorker.__init__

    def dropping(self, *a, **k):
        init(self, *a, **k)
        self._kf_corrected = _WindowWritesDropped()

    monkeypatch.setattr(refiner.RefinerWorker, "__init__", dropping)
    out = _run()
    assert out["correct"] is False and _failed(out) == ["kf_pose_gap"]


def test_closure_not_propagated(monkeypatch):
    """At the cell's window of 10 keyframes the one window solve of these 31-frame logs, collected
    at the end, covers all six keyframes and sets their poses outright, closures or not; at a window
    of 3 the logs have no window solve, and the keyframes' poses are the closures' work alone."""
    from vo_tpu_torch.odometry import refiner

    propagate = refiner.propagate_closure

    def skipped(kf_order, kf_corrected, kf_chain, surv):
        return propagate(kf_order, dict(kf_corrected), dict(kf_chain), surv)  # the ledger left as it was

    monkeypatch.setattr(refiner, "propagate_closure", skipped)
    monkeypatch.setitem(SLAM["config"]["pipeline"], "ba", dict(window=3))
    out = _run()
    assert out["correct"] is False and "kf_pose_gap" in _failed(out)
