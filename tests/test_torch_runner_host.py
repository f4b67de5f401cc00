"""The port runner's per-frame host paths: progress, the metrics JSONL, live figures, save_result.

Any per-frame consumer takes the run off the deferred path (one frame per
step, the frame's scalars read through one host copy); the trajectory must
not change for it. The same small feed goes through the reference's
``run_sequence(progress=, metrics_path=)`` and ``save_result`` (JAX on the
CPU): the port's JSONL rows, ``progress`` dicts and result files are held to
what the reference wrote, not to names copied into this file. Tolerances
against the reference: ``n_tracks`` and ``pose_ok`` equal, ``n_inliers``
within 2 (the two packages draw different RANSAC triples), ``mean_reproj_err``
within 1e-3 px, poses within 0.03 m as in tests/test_torch_pipeline.py.
``viz_every`` writes the reference's four figures per dumped frame. All on
the CPU (``device="cpu"``), at 128x256 with 256 keypoints.
"""
import dataclasses
import json
import os

from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu import config as r_config
from vo_tpu.io import synthetic as r_syn
from vo_tpu.odometry import runner as r_runner
from vo_tpu_torch import convert
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import pipeline as p_pipe
from vo_tpu_torch.odometry import runner as p_runner
from vo_tpu_torch.utils import host_copy

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

N = 7
DATA = Path(__file__).resolve().parent / "data"
FEED = dict(n_frames=N, n_landmarks=800, seed=3, image_size=(128, 256))
N_INLIERS_TOL = 2
REPROJ_TOL_PX = 1e-3
POSE_TOL_M = 0.03


def ref_cfg(**kw):
    return r_config.PipelineConfig(
        sift=r_config.SIFTConfig(max_keypoints=256, n_octaves=3),
        ransac=r_config.RansacConfig(n_hypotheses=128),
        landmarks=r_config.LandmarkConfig(capacity=20000),
        max_tracks=256,
        **kw,
    )


def small_cfg(**kw):
    return convert.config_from_reference(ref_cfg(**kw))


@pytest.fixture(scope="module")
def seq():
    return p_syn.kitti_synthetic_sequence(**FEED)


@pytest.fixture(scope="module")
def host_run(seq, tmp_path_factory):
    """One non-deferred run with every per-frame consumer attached."""
    d = tmp_path_factory.mktemp("host")
    seen = []
    res = p_runner.run_sequence(
        seq, small_cfg(), warmup=False, device="cpu", progress=lambda i, info: seen.append((i, info)),
        metrics_path=str(d / "metrics.jsonl"),
    )
    rows = [json.loads(line) for line in open(d / "metrics.jsonl")]
    return res, seen, rows


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's non-deferred run over the same feed, and the files its save_result writes."""
    d = tmp_path_factory.mktemp("ref")
    seen = []
    res = r_runner.run_sequence(
        r_syn.kitti_synthetic_sequence(str(DATA), **FEED), ref_cfg(), warmup=False,
        progress=lambda i, info: seen.append((i, info)), metrics_path=str(d / "metrics.jsonl"),
    )
    rows = [json.loads(line) for line in open(d / "metrics.jsonl")]
    res.refine_stats = dict(ba_solves=3)
    r_runner.save_result(res, str(d / "out"))
    return res, seen, rows, d / "out"


def test_non_deferred_run_equals_the_deferred_single_frame_run(seq, host_run):
    """Reading every frame on the host changes nothing: bit-equal to the deferred run that steps
    one frame at a time (fused_group=1), and within float noise of the default 2-frame groups."""
    res = host_run[0]
    single = p_runner.run_sequence(seq, small_cfg(fused_group=1), warmup=False, device="cpu")
    for k in ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks"):
        np.testing.assert_array_equal(getattr(res, k), getattr(single, k), err_msg=k)
    grouped = p_runner.run_sequence(seq, small_cfg(), warmup=False, device="cpu")
    assert np.abs(grouped.poses - res.poses).max() < 1e-3
    assert res.poses.shape == (N - 1, 4, 4) and res.poses.dtype == np.float32 and res.pose_ok.sum() >= N - 2


def test_progress_values_equal_the_result_rows(host_run, ref_run):
    """progress is called as the reference calls it (same frames, same keys, same Python types,
    the reference's values at the stated tolerances), with the values of the result's rows."""
    res, seen, _ = host_run
    r_seen = ref_run[1]
    assert [i for i, _ in seen] == [i for i, _ in r_seen] == list(range(N))
    assert seen[0][1] == r_seen[0][1]  # frame 0 tracks nothing, in both
    for (i, info), (_, r_info) in zip(seen, r_seen):
        assert list(info) == list(r_info)
        assert {k: type(v) for k, v in info.items()} == {k: type(v) for k, v in r_info.items()}
        assert info["n_tracks"] == r_info["n_tracks"] and info["pose_ok"] == r_info["pose_ok"]
        assert abs(info["n_inliers"] - r_info["n_inliers"]) <= N_INLIERS_TOL
    for i, info in seen[1:]:
        assert info == dict(n_tracks=int(res.n_tracks[i - 1]), n_inliers=int(res.n_inliers[i - 1]),
                            pose_ok=bool(res.pose_ok[i - 1]))


def test_metrics_jsonl_rows(host_run, ref_run):
    """The JSONL file row for row against the one the reference's run_sequence(metrics_path=) wrote
    over the same feed: as many rows (frame 0 included), the same keys in the same order with the
    same JSON types, the same values apart from the clock (frame_ms) at the stated tolerances."""
    res, _, rows = host_run
    r_res, _, r_rows, _ = ref_run
    assert len(rows) == len(r_rows) == N
    for r, want in zip(rows, r_rows):
        assert list(r) == list(want)
        assert {k: type(v) for k, v in r.items()} == {k: type(v) for k, v in want.items()}
        for k in ("frame", "n_tracks", "pose_ok"):
            assert r[k] == want[k], (k, r, want)
        assert abs(r["n_inliers"] - want["n_inliers"]) <= N_INLIERS_TOL
        assert abs(r["mean_reproj_err"] - want["mean_reproj_err"]) <= REPROJ_TOL_PX, (r, want)
        assert r["inlier_ratio"] == round(r["n_inliers"] / max(r["n_tracks"], 1), 4)
        assert r["frame_ms"] > 0
    assert {k: v for k, v in rows[0].items() if k != "frame_ms"} == {k: v for k, v in r_rows[0].items() if k != "frame_ms"}
    assert rows[1]["mean_reproj_err"] > 0  # a tracked frame has a residual: the field is not a constant
    for r in rows[1:]:
        i = r["frame"]
        assert r["n_tracks"] == res.n_tracks[i - 1] and r["n_inliers"] == res.n_inliers[i - 1]
    np.testing.assert_array_equal(res.pose_ok, r_res.pose_ok)
    assert np.abs(res.poses[:, :3, 3] - r_res.poses[:, :3, 3]).max() < POSE_TOL_M


def test_each_frame_is_read_through_one_host_copy(seq, monkeypatch):
    """The per-frame sync is one HostCopy of the frame's scalars, not one read per field."""
    made = []

    class Counting(host_copy.HostCopy):
        def __init__(self, *tensors):
            made.append(len(tensors))
            super().__init__(*tensors)

    monkeypatch.setattr(p_runner, "HostCopy", Counting)
    p_runner.run_sequence(seq, small_cfg(), n_frames=3, warmup=False, device="cpu", progress=lambda i, s: None)
    assert made == [5, 5, 5]
    made.clear()
    p_runner.run_sequence(seq, small_cfg(), n_frames=3, warmup=False, device="cpu")
    assert made == []  # the deferred path reads nothing inside the loop


def test_viz_every_writes_the_four_figures(seq, tmp_path, capsys):
    viz = tmp_path / "img"
    res = p_runner.run_sequence(seq, small_cfg(), warmup=False, device="cpu", viz_every=3, viz_dir=str(viz))
    assert sorted(os.listdir(viz)) == ["3", "6"]
    for d in ("3", "6"):
        for name in ("view.png", "map.png", "error.png", "3d_map.png"):
            assert os.path.getsize(viz / d / name) > 1000, (d, name)
    out = capsys.readouterr().out
    assert "frame 3\n" in out and "frame 6\n" in out and "km/h" in out
    # A viz-only run stays on the deferred path: the default groups of two frames.
    grouped = p_runner.run_sequence(seq, small_cfg(), warmup=False, device="cpu")
    np.testing.assert_array_equal(res.poses, grouped.poses)


def test_save_result_writes_three_files(host_run, ref_run, tmp_path):
    """save_result's directory against the one the reference's save_result wrote for its run of
    the same feed: the same files, the same arrays in each npz (names, dtypes, dimensions), the
    same keys and types in stats.json; and the port's own values in them."""
    res = dataclasses.replace(host_run[0], refine_stats=dict(ba_solves=3))
    r_out = ref_run[3]
    p_runner.save_result(res, str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out")) == sorted(os.listdir(r_out))
    assert len(os.listdir(r_out)) == 3
    for name in ("trajectory.npz", "landmarks.npz"):
        z, r_z = np.load(tmp_path / "out" / name), np.load(r_out / name)
        assert sorted(z.files) == sorted(r_z.files)
        for k in r_z.files:
            assert z[k].dtype == r_z[k].dtype and z[k].ndim == r_z[k].ndim, (name, k)
            assert z[k].shape[1:] == r_z[k].shape[1:], (name, k)
    z = np.load(tmp_path / "out" / "trajectory.npz")
    for k in z.files:
        np.testing.assert_array_equal(z[k], getattr(res, k), err_msg=k)
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "landmarks.npz")["landmarks"], res.landmarks)
    stats, r_stats = (json.load(open(d / "stats.json")) for d in (tmp_path / "out", r_out))
    assert list(stats) == list(r_stats)
    assert {k: type(v) for k, v in stats.items()} == {k: type(v) for k, v in r_stats.items()}
    assert stats["n_frames"] == r_stats["n_frames"] == N and stats["refine_ba_solves"] == 3 and stats["frames_per_sec"] > 0


def test_dt_at_reads_the_feed_times():
    class Feed:
        times = np.array([0.0, 0.1, 0.25])

    assert p_runner._dt_at(Feed, 2) == pytest.approx(0.15)
    assert p_runner._dt_at(Feed, 0) == p_runner._dt_at(Feed, 3) == p_runner._dt_at(object(), 1) == p_runner.KITTI_DT


def test_nan_debug_names_the_stage(seq, monkeypatch):
    """Under utils.debug.nan_debug the step raises at the first stage whose output is not finite."""
    from vo_tpu_torch.utils import debug

    real = p_pipe.triangulate_rectified

    def poisoned(l_px, r_px, calib):
        X = real(l_px, r_px, calib)
        X[:, 2] = float("nan")
        return X

    monkeypatch.setattr(p_pipe, "triangulate_rectified", poisoned)
    # Without the context the step carries on (the pose falls back to constant velocity).
    p_runner.run_sequence(seq, small_cfg(), n_frames=3, warmup=False, device="cpu")
    with debug.nan_debug():
        with pytest.raises(FloatingPointError, match="stage 'triangulate'"):
            p_runner.run_sequence(seq, small_cfg(), n_frames=3, warmup=False, device="cpu")
    assert not debug.nan_checks_enabled()
