"""The port's refiner, trajectory correction and refined run_sequence against vo_tpu.

``propagate_closure`` and the correction functions are the reference's numpy
code, so their results must be equal. The slice as a whole runs both
packages' ``run_sequence(use_ba=True, use_loop_closure=True)`` on a small
out-and-back feed (GT 0..9 then 8..0 at 160x320, the loop fixture of
tests/test_loop_closure.py): equal keyframe counts, finite poses, at least
one window solve and one verified loop candidate each, ATEs within 0.02 m,
and two port runs with the same seed give identical poses. Each package gets
the configuration in its own classes (``_cfg(module)``), and the port runs on
the CPU because every call names it (``device="cpu"``).

The reference is imported by the ``ref`` fixture only, so the ``gpu`` case
also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_refiner.py
"""
import threading
import traceback
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vo_tpu_torch import config as p_config
from vo_tpu_torch.ba.pose_graph import _np_exp_so3
from vo_tpu_torch.eval import metrics
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import correction as p_corr
from vo_tpu_torch.odometry import refiner as p_ref
from vo_tpu_torch.odometry import runner as p_runner

DATA = Path(__file__).parent / "data" / "kitti"
SIZE = (160, 320)


@pytest.fixture(scope="module")
def ref():
    """The jax reference's modules."""
    from vo_tpu import config
    from vo_tpu.io import kitti, synthetic
    from vo_tpu.odometry import correction, refiner, runner

    return SimpleNamespace(config=config, kitti=kitti, syn=synthetic, corr=correction, refiner=refiner, runner=runner)


def _cfg(c=p_config):
    """The test's configuration in the classes of config module ``c`` (the port's, or the reference's)."""
    return c.PipelineConfig(
        sift=c.SIFTConfig(max_keypoints=256, n_octaves=2),
        ransac=c.RansacConfig(n_hypotheses=128),
        landmarks=c.LandmarkConfig(capacity=20000),
        ba=c.BAConfig(keyframe_every=2, window=6),
        # min_gap 4 keyframes: the revisit of the start (keyframe 8) sees keyframes 0-4.
        loop=c.LoopConfig(radius=8.0, min_gap=4, min_inliers=15),
        max_tracks=256,
    )


def _out_and_back():
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    return np.concatenate([gt[:10], gt[8::-1]])


@pytest.fixture(scope="module")
def feed():
    poses = _out_and_back()
    return p_syn.SyntheticSequence(
        p_kitti.load_stereo_calib(str(DATA / "00")), poses, n_landmarks=2500, seed=12, image_size=SIZE
    )


@pytest.fixture(scope="module")
def port_run(feed):
    return p_runner.run_sequence(feed, _cfg(), warmup=False, use_ba=True, use_loop_closure=True, seed=1, device="cpu")


def _random_traj(rng, T):
    poses = [np.eye(4)]
    for _ in range(T - 1):
        rel = np.eye(4)
        rel[:3, :3] = _np_exp_so3(rng.normal(scale=0.02, size=3))
        rel[:3, 3] = rng.normal(scale=0.3, size=3) + [0.0, 0.0, 1.0]
        poses.append(poses[-1] @ rel)
    return np.stack(poses)


def test_propagate_closure_equals_reference(ref, rng):
    chain = _random_traj(rng, 12).astype(np.float32)
    order = list(range(12))
    corrected = {i: chain[i].copy() for i in order}
    corrected[3][0, 3] += 0.05  # window-BA offsets that must ride through the closure
    corrected[8][1, 3] -= 0.04
    surv = {i: (_random_traj(rng, 2)[1] @ chain[i]).astype(np.float32) for i in range(0, 12, 3)}
    outs = []
    for fn in (ref.refiner.propagate_closure, p_ref.propagate_closure):
        kc = {i: v.copy() for i, v in corrected.items()}
        kch = {i: chain[i].copy() for i in order}
        surv_sorted, deltas = fn(order, kc, kch, {i: v.copy() for i, v in surv.items()})
        outs.append((kc, kch, surv_sorted, deltas))
    (a, b, c, d), (e, f, g, h) = outs
    np.testing.assert_array_equal(g, c)
    for i in order:
        np.testing.assert_array_equal(e[i], a[i])
        np.testing.assert_array_equal(f[i], b[i])
    assert h.keys() == d.keys() and all(np.array_equal(h[k], d[k]) for k in d)


def test_correction_equals_reference(ref, rng):
    poses = _random_traj(rng, 40)
    rows = np.array([5, 15, 25, 35])
    fixed = _random_traj(rng, 4)
    want = ref.corr.reanchor_trajectory(poses, rows, fixed)
    got = p_corr.reanchor_trajectory(poses, rows, fixed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(p_corr.rebuild_rel_poses(got), ref.corr.rebuild_rel_poses(want))


def test_refined_run_matches_reference(ref, port_run):
    r_seq = ref.syn.SyntheticSequence(
        ref.kitti.load_stereo_calib(str(DATA / "00")), _out_and_back(), n_landmarks=2500, seed=12, image_size=SIZE
    )
    r_res = ref.runner.run_sequence(r_seq, _cfg(ref.config), warmup=False, use_ba=True, use_loop_closure=True, seed=1)
    gt = _out_and_back()
    for res in (port_run, r_res):
        assert res.poses.shape == (len(gt) - 1, 4, 4) and np.isfinite(res.poses).all()
        assert res.refine_stats["ba_solves"] >= 1 and res.refine_stats["lc_verified"] >= 1
    assert port_run.refine_stats["n_keyframes"] == r_res.refine_stats["n_keyframes"] == 9
    a_p, a_r = metrics.ate(port_run.poses, gt)["rmse"], metrics.ate(r_res.poses, gt)["rmse"]
    assert abs(a_p - a_r) <= 0.02, (a_p, a_r)
    # rel_poses were rebuilt from the corrected absolute poses.
    p = np.concatenate([np.eye(4)[None], port_run.poses.astype(np.float64)])
    np.testing.assert_allclose(p[:-1] @ port_run.rel_poses.astype(np.float64), p[1:], atol=5e-3)


def test_refined_run_is_deterministic(feed, port_run):
    again = p_runner.run_sequence(feed, _cfg(), warmup=False, use_ba=True, use_loop_closure=True, seed=1, device="cpu")
    np.testing.assert_array_equal(again.poses, port_run.poses)
    assert again.refine_stats["ba_solves"] == port_run.refine_stats["ba_solves"]


def test_worker_error_reaches_the_main_thread(feed, monkeypatch):
    """A failure on the worker thread is raised by the runner, not swallowed."""
    from vo_tpu_torch.odometry import ba_runner

    def fail(self):
        raise RuntimeError("window solve failed")

    monkeypatch.setattr(ba_runner.WindowedBA, "dispatch", fail)
    with pytest.raises(RuntimeError, match="window solve failed"):
        p_runner.run_sequence(feed, _cfg(), n_frames=9, warmup=False, use_ba=True, device="cpu")


@pytest.mark.gpu
def test_refined_frame_loop_never_syncs_on_cuda(feed):
    """On the card, the main thread's frame loop issues no synchronising call: every sync warning
    raised under set_sync_debug_mode("warn") is attributed to its thread and Python stack, and none
    may come from the main thread inside _frame_loop (throttle waits on a queue, not the device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    staged = p_runner.StagedSequence(feed, len(feed), dev)
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()
        where = [f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno} {f.name}" for f in stack if "vo_tpu_torch" in f.filename]
        seen.append((threading.current_thread() is threading.main_thread(), where[-1:], [f.name for f in stack]))

    p_runner.run_sequence(staged, _cfg(), use_ba=True, use_loop_closure=True, device=dev)  # warm
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = p_runner.run_sequence(staged, _cfg(), use_ba=True, use_loop_closure=True, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    in_loop = sorted({w for main, where, stack in seen if main and "_frame_loop" in stack for w in where})
    assert not in_loop, in_loop
    assert any(main for main, _, _ in seen)  # the final synchronise was seen: the hook works
    assert res.refine_stats["ba_solves"] >= 1 and res.refine_stats["lc_verified"] >= 1
    assert np.isfinite(res.poses).all()
