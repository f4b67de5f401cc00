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
from vo_tpu_torch.frontend.track import StereoFeatures as PStereoFeatures
from vo_tpu_torch.odometry import correction as p_corr
from vo_tpu_torch.odometry import refiner as p_ref
from vo_tpu_torch.odometry import runner as p_runner

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
SIZE = (160, 320)


@pytest.fixture(scope="module")
def ref():
    """The jax reference's modules."""
    from vo_tpu import config
    from vo_tpu.frontend import track
    from vo_tpu.io import kitti, synthetic
    from vo_tpu.odometry import correction, refiner, runner

    return SimpleNamespace(
        config=config, kitti=kitti, syn=synthetic, corr=correction, refiner=refiner, runner=runner, track=track
    )


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


def _synthetic_keyframes(rng, calib, gt_poses, K, Kw, M=300, C=256):
    """K keyframes 2 frames apart observing M landmarks with 0.3 px detection noise: each one's
    stereo payload and the window-match payload (slot, a, b, ok) of the runner's associator ring of
    ``Kw`` slots, made from the landmarks' identities."""
    lms = p_syn.scatter_landmarks(rng, gt_poses[: 2 * K], M)
    P1, P2 = calib.P1.numpy().astype(np.float64), calib.P2.numpy().astype(np.float64)
    H, W = calib.image_size
    ring = [None] * Kw
    out = []
    for k in range(K):
        T = gt_poses[2 * k]
        cam = p_syn._w2c_apply(T, lms)
        safe = np.where(cam[:, 2:3] > 1.0, cam, [0, 0, 10.0])
        px, pxr = p_syn.project_np(P1, safe), p_syn.project_np(P2, safe)
        vis = np.flatnonzero((cam[:, 2] > 1.0) & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H))
        rows = rng.permutation(vis)[:C]
        n = rows.size
        l_xy, r_xy = np.zeros((C, 2), np.float32), np.zeros((C, 2), np.float32)
        l_xy[:n] = px[rows] + rng.normal(scale=0.3, size=(n, 2))
        r_xy[:n] = np.stack([pxr[rows, 0], px[rows, 1]], -1) + rng.normal(scale=0.3, size=(n, 2))
        lm = np.full(C, -1, np.int64)
        lm[:n] = rows
        mask = lm >= 0
        m_a, m_b, m_ok = (np.zeros((Kw, C), dt) for dt in (np.int32, np.int32, bool))
        for s, old in enumerate(ring):
            if old is None:
                continue
            a, b = np.nonzero((lm[:, None] == old[None, :]) & mask[:, None])
            m_a[s, : a.size], m_b[s, : a.size], m_ok[s, : a.size] = a, b, True
        ring[k % Kw] = lm
        pose = gt_poses[2 * k].astype(np.float32)
        pose[:3, 3] += rng.normal(scale=0.02, size=3)
        out.append(dict(
            frame_idx=2 * k + 2, pose=pose, l_xy=l_xy, r_xy=r_xy, l_desc=rng.random((C, 128)).astype(np.float32),
            r_desc=rng.random((C, 128)).astype(np.float32), mask=mask, ids=np.arange(C, dtype=np.int32),
            assoc=(k % Kw, m_a, m_b, m_ok),
        ))
    return out


def _submit(worker, kf, features, asarray):
    feats = features(**{f: asarray(kf[f]) for f in PStereoFeatures._fields})
    slot, *payload = kf["assoc"]
    worker.submit(kf["frame_idx"], asarray(kf["pose"]), feats, assoc=(slot, *(asarray(x) for x in payload)))


GENERATOR_FIELDS = {"lc_torch_gen_state", "lc_torch_gen_device"}


def test_checkpoint_state_matches_reference_and_resumes_from_it(ref, rng):
    """The same 7 keyframes into both workers: equal checkpoint_state (key sets apart from the
    port's generator fields, integers equal, floats within 1e-4). Then the reference's state
    as it is into a new port worker's restore_state, 4 more keyframes into both: corrected keyframes
    within 1e-4 m, and each restored window keyframe shares its ids array with its ring slot."""
    import jax.numpy as jnp

    calib = p_kitti.load_stereo_calib(str(DATA / "00"))
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    cfg, r_cfg = _cfg(), _cfg(ref.config)
    kfs = _synthetic_keyframes(rng, calib, gt, K=11, Kw=cfg.ba.window)
    r_worker = ref.refiner.RefinerWorker(ref.kitti.load_stereo_calib(str(DATA / "00")), r_cfg, True, True)
    p_worker = p_ref.RefinerWorker(calib, cfg, True, True, device="cpu")
    resumed = p_ref.RefinerWorker(calib, cfg, True, True, device="cpu")
    try:
        for kf in kfs[:7]:
            _submit(r_worker, kf, ref.track.StereoFeatures, jnp.asarray)
            _submit(p_worker, kf, PStereoFeatures, torch.from_numpy)
        r_state, p_state = r_worker.checkpoint_state(), p_worker.checkpoint_state()
        assert set(p_state) - set(r_state) == GENERATOR_FIELDS and set(r_state) <= set(p_state)
        assert {"ba_pend0_T", "ba_pend1_T", "lc_kf_desc", "lc_key", "ba_win_slot"} <= set(r_state)
        n_cand = len(r_state["lc_pend_cands"])
        assert n_cand >= 1  # a verification round is in flight in both
        for k, want in r_state.items():
            got = np.asarray(p_state[k])
            want = np.asarray(want)
            if k in ("lc_pend_ok", "lc_pend_ninl", "lc_pend_poses", "lc_pend_nm"):
                # Both pad the round to candidate_budget with the first candidate and read the
                # first n_cand. The two packages draw different RANSAC samples, so only the match
                # counts and (no keyframe here resembles another) the verdicts agree, padding too.
                assert got.shape == want.shape and n_cand <= want.shape[0], k
                if k in ("lc_pend_ok", "lc_pend_nm"):
                    np.testing.assert_array_equal(got, want, err_msg=k)
                continue
            assert got.shape == want.shape, k
            if k == "lc_key":
                assert got.dtype == want.dtype  # a placeholder of the reference's shape and dtype
            elif np.issubdtype(want.dtype, np.floating):
                # (the costs are sums over every observation: relative, as in test_torch_ba.py)
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3 if "cost" in k else 0, err_msg=k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
        assert p_state["ref_counters"][1] >= 1  # window solves were collected before the checkpoint

        resumed.restore_state(r_state)  # the reference's dict as it is: only the sample stream does not cross
        slots = resumed.associator._slot_tids
        assert len(resumed.wba.window) == cfg.ba.window
        for k, kf in enumerate(resumed.wba.window):
            assert kf.ids is slots[int(r_state["ba_win_slot"][k])]
        for kf in kfs[7:]:
            _submit(r_worker, kf, ref.track.StereoFeatures, jnp.asarray)
            _submit(resumed, kf, PStereoFeatures, torch.from_numpy)
            _submit(p_worker, kf, PStereoFeatures, torch.from_numpy)
    finally:
        for w in (r_worker, p_worker, resumed):
            w.close()
    r_idx, r_poses = r_worker.corrected_keyframes()
    for w in (resumed, p_worker):
        idx, poses = w.corrected_keyframes()
        np.testing.assert_array_equal(idx, r_idx)
        np.testing.assert_allclose(poses, r_poses, atol=1e-4)
    assert resumed.stats["ba_solves"] == r_worker.stats["ba_solves"] == p_worker.stats["ba_solves"] >= 5
    # In the port, a restored worker continues exactly as the one that was never interrupted would
    # from the same state: resumed from the port's own state, bit for bit.
    again = p_ref.RefinerWorker(calib, cfg, True, True, device="cpu")
    try:
        again.restore_state(p_state)
        for kf in kfs[7:]:
            _submit(again, kf, PStereoFeatures, torch.from_numpy)
    finally:
        again.close()
    np.testing.assert_array_equal(again.corrected_keyframes()[1], p_worker.corrected_keyframes()[1])


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
