"""What ``run_sequence`` returns besides the trajectory: the frame loop's own rows, the step rule,
and on the refined path the refiner's records (``RunResult.refine_log``).

- ``runner.step_group`` is the group the frame loop steps with (read from the tracer's record of
  the frames each step took) on the plain path, with ``progress``, on the refined path and under a
  (1, 1) mesh;
- on the plain path ``step_poses`` / ``step_rel_poses`` are ``poses`` / ``rel_poses`` themselves
  and nothing is recorded;
- on the refined path (the out-and-back feed of tests/test_torch_refiner.py) the step rows chain,
  ``poses`` are those rows re-anchored onto the recorded corrected keyframes, the records are as
  many as ``refine_stats`` counts, every recorded window solve, solved again from its record,
  gives the recorded result, and the corrected keyframes are the step rows with the recorded
  solves applied in the recorded order (perfbench/reference/correction.py's replay).

Everything runs on the CPU (``device="cpu"``), without the jax reference.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch import config as p_config
from vo_tpu_torch.ba.window import solve_window
from vo_tpu_torch.convert import ba_problem_from_numpy
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import runner as p_runner
from vo_tpu_torch.odometry.correction import reanchor_trajectory
from vo_tpu_torch.utils import profiling

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
SIZE = (160, 320)


def _cfg(loop=None, **kw):
    return p_config.PipelineConfig(
        sift=p_config.SIFTConfig(max_keypoints=256, n_octaves=2),
        ransac=p_config.RansacConfig(n_hypotheses=128),
        landmarks=p_config.LandmarkConfig(capacity=20000),
        ba=p_config.BAConfig(keyframe_every=2, window=6),
        # min_gap 4 keyframes: the revisit of the start (keyframe 8) sees keyframes 0-4.
        loop=loop or p_config.LoopConfig(radius=8.0, min_gap=4, min_inliers=15),
        max_tracks=256,
        **kw,
    )


@pytest.fixture(scope="module")
def feed():
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    poses = np.concatenate([gt[:10], gt[8::-1]])
    return p_syn.SyntheticSequence(
        p_kitti.load_stereo_calib(str(DATA / "00")), poses, n_landmarks=2500, seed=12, image_size=SIZE
    )


@pytest.fixture(scope="module")
def refined(feed):
    return p_runner.run_sequence(feed, _cfg(), warmup=False, use_ba=True, use_loop_closure=True, seed=1, device="cpu")


# The loop closer's benefit gate opened, so that the revisit's verified loops are closed.
CLOSING = p_config.LoopConfig(radius=8.0, min_gap=4, min_inliers=15, min_correction=0.0, min_correction_floor=0.0)


@pytest.mark.parametrize("case", ["plain", "progress", "refined", "meshed"])
def test_step_group_is_the_group_run_sequence_steps(feed, case):
    cfg = _cfg(fused_group=2)
    n = 7  # three groups of two and a single-frame tail on the deferred path
    kw = dict(n_frames=n, warmup=False, seed=1, device="cpu")
    mesh = None
    if case == "progress":
        kw["progress"] = lambda i, stats: None
    elif case == "refined":
        kw.update(use_ba=True, use_loop_closure=True)
    elif case == "meshed":
        from vo_tpu_torch.dist.mesh import make_mesh

        mesh = kw["mesh"] = make_mesh(p_config.MeshConfig(data=1, model=1), device="cpu")
    try:
        with profiling.tracing():
            res = p_runner.run_sequence(feed, cfg, **kw)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    g = p_runner.step_group(
        cfg, deferred=case != "progress", refined=case == "refined", meshed=case == "meshed"
    )
    assert g == (2 if case == "plain" else 1)
    want = [tuple(range(i, i + g)) for i in range(0, n - n % g, g)] + [(i,) for i in range(n - n % g, n)]
    assert res.trace.frames == want


def test_plain_run_step_rows_are_the_poses(feed):
    res = p_runner.run_sequence(feed, _cfg(), n_frames=5, warmup=False, seed=1, device="cpu")
    assert res.step_poses is res.poses and res.step_rel_poses is res.rel_poses
    assert res.refine_log is None


def test_refined_step_rows_chain(refined):
    P = np.asarray(refined.step_poses, np.float64)
    R = np.asarray(refined.step_rel_poses, np.float64)
    prev = np.concatenate([np.eye(4)[None], P[:-1]])
    gap = np.linalg.norm(np.einsum("tij,tjl->til", prev, R)[:, :3, 3] - P[:, :3, 3], axis=1)
    assert gap.max() < 1e-5
    assert np.abs(refined.poses - refined.step_poses).max() > 1e-4  # re-anchoring moved rows


def test_refined_poses_are_the_step_rows_reanchored(refined):
    log = refined.refine_log
    rows = log.kf_frame_idx - 1
    keep = (rows >= 0) & (rows < len(refined.step_poses))
    want = reanchor_trajectory(refined.step_poses, rows[keep], log.kf_poses[keep])
    np.testing.assert_array_equal(refined.poses, want)
    assert log.kf_frame_idx.size == refined.refine_stats["n_keyframes"] == 9


def test_record_counts_are_the_counters(refined):
    s, log = refined.refine_stats, refined.refine_log
    verdicts = [w.verdict for w in log.window_solves]
    assert s["records_window"] == len(log.window_solves) >= 1
    assert s["ba_solves"] == verdicts.count("accepted") and s["ba_rejected"] == verdicts.count("rejected")
    assert s["records_graph"] == len(log.graph_solves)
    assert s["loops_closed"] == sum(g.T is not None for g in log.graph_solves)
    assert s["records_rounds"] == len(log.rounds) >= 1
    assert s["lc_verified"] == sum(int(r.verdict.sum()) for r in log.rounds) >= 1
    for r in log.rounds:
        assert r.gen_state.dtype == np.uint8 and len(r.candidates) == len(r.verdict) >= 1
        np.testing.assert_array_equal(r.verdict, r.ok & (r.n_inliers >= 15) & (r.n_matches >= 15))
    for g in log.graph_solves:
        n = len(g.frame_idx)
        assert g.T0.shape == (n, 4, 4) and len(g.edge_i) == len(g.edge_weight) >= n
        assert np.isin(g.frame_idx, log.kf_frame_idx).all()


def test_recorded_window_solves_solve_again_to_their_results(feed, refined):
    cfg = _cfg()
    calib = feed.calib.to("cpu")
    for w in refined.refine_log.window_solves:
        assert isinstance(w.problem.T_c2w, np.ndarray) and w.problem.T_c2w.shape == (cfg.ba.window, 4, 4)
        got = solve_window(ba_problem_from_numpy(w.problem._asdict(), "cpu"), calib, cfg.ba)
        for name, a, b in zip(got._fields, got, w.result):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_corrected_keyframes_are_the_records_replayed(feed):
    from perfbench.reference.correction import ledger

    cfg = _cfg(loop=CLOSING)
    refined = p_runner.run_sequence(feed, cfg, warmup=False, use_ba=True, use_loop_closure=True, seed=1, device="cpu")
    log = refined.refine_log
    kinds = [k for k, _ in log.order]
    assert [i for k, i in log.order if k == "keyframe"] == list(log.kf_frame_idx)
    assert [i for k, i in log.order if k == "window"] == list(range(len(log.window_solves)))
    assert [i for k, i in log.order if k == "graph"] == list(range(len(log.graph_solves)))
    assert kinds.count("window") >= 1 and any(g.T is not None for g in log.graph_solves)
    windows = [(w.frame_idx, w.problem.T_c2w[len(w.frame_idx) - 1], w.result.T_c2w, float(w.result.cost0),
                float(w.result.cost)) for w in log.window_solves]
    fi, want = ledger(refined.step_poses, log.order, windows, [(g.frame_idx, g.T) for g in log.graph_solves], cfg.ba)
    np.testing.assert_array_equal(fi, log.kf_frame_idx)
    np.testing.assert_allclose(log.kf_poses, want.numpy(), atol=1e-5)
    # The replay is not the trajectory without its solves: the step rows at the keyframes differ.
    assert np.abs(want.numpy() - refined.step_poses[log.kf_frame_idx - 1]).max() > 1e-3
