"""``run_sequence(mesh=)`` on gloo (CPU) against the single-process run, port to port.

Every rank of a launched world (dist.mesh.launch: real processes, one thread
each, a time limit) runs the same ``run_sequence`` over the same small feed
and returns its whole result; the tests hold every rank's result to rank 0's
bit for bit, and rank 0's to the run made in this process without a mesh:

- (2, 2), plain VO (detection sharded over "data", so each rank detects ONE
  image of the pair; RANSAC over "model"): ``pose_ok`` equal, positions within
  2e-2 m, ATE within 0.02 m (tests/test_dist.py's integrated test).
- (1, 2) with window BA (the refiner's worker reduces over a process group of
  its own while the frame loop gathers on the mesh's): the single-process
  keyframe and solve counts.
- A checkpoint written under a mesh (by rank 0) resumes under it, on every
  rank, to the poses of the uninterrupted meshed run.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch import config as p_config
from vo_tpu_torch.dist import mesh as p_mesh
from vo_tpu_torch.eval import metrics
from vo_tpu_torch.frontend import kernels
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import runner as p_runner

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

SIZE = (160, 320)
N_FRAMES = 12
FIELDS = ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")


def _cfg():
    c = p_config
    return c.PipelineConfig(
        sift=c.SIFTConfig(max_keypoints=256, n_octaves=2),
        ransac=c.RansacConfig(n_hypotheses=128),
        landmarks=c.LandmarkConfig(capacity=20000),
        ba=c.BAConfig(keyframe_every=2, window=6, max_points=256),
        max_tracks=256,
    )


def _feed(n_frames=N_FRAMES):
    return p_syn.kitti_synthetic_sequence(n_frames=n_frames, n_landmarks=1200, seed=4, image_size=SIZE)


def _as_dict(res) -> dict:
    out = {k: getattr(res, k) for k in FIELDS}
    # What the run decided; seconds and the per-process telemetry of window sizes stay out.
    out["refine_stats"] = {k: res.refine_stats[k] for k in ("n_keyframes", "ba_solves", "ba_rejected") if k in res.refine_stats}
    return out


def _run_rank(mesh, device, kw):
    return _as_dict(p_runner.run_sequence(_feed(), _cfg(), warmup=False, mesh=mesh, device=device, **kw))


def _resume_rank(mesh, device, path):
    """An interrupted meshed run (a checkpoint at frame 8 of 12, then a stop after frame 9),
    the resumed run, and the uninterrupted run on the same non-deferred path."""
    seq, cfg = _feed(), _cfg()
    kw = dict(warmup=False, mesh=mesh, device=device, use_ba=True, checkpoint_path=path)
    p_runner.run_sequence(seq, cfg, n_frames=10, checkpoint_every=8, **kw)
    resumed = p_runner.run_sequence(seq, cfg, checkpoint_every=100, resume=True, **kw)
    full = p_runner.run_sequence(seq, cfg, warmup=False, mesh=mesh, device=device, use_ba=True, progress=lambda i, s: None)
    return _as_dict(resumed), _as_dict(full)


def _assert_same(a: dict, b: dict, what: str):
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")
    assert a["refine_stats"] == b["refine_stats"], what


def test_meshed_run_matches_single_process():
    single = p_runner.run_sequence(_feed(), _cfg(), warmup=False, device="cpu", progress=lambda i, s: None)
    per_rank = p_mesh.launch(_run_rank, (2, 2), "cpu", args=({},), timeout=120.0)
    for r in range(1, 4):
        _assert_same(per_rank[r], per_rank[0], f"rank {r} against rank 0")
    meshed = per_rank[0]
    assert meshed["poses"].shape == single.poses.shape == (N_FRAMES - 1, 4, 4)
    np.testing.assert_array_equal(meshed["pose_ok"], single.pose_ok)
    d = np.linalg.norm(meshed["poses"][:, :3, 3] - single.poses[:, :3, 3], axis=1)
    assert d.max() < 2e-2, d
    gt = _feed().gt_poses
    assert abs(metrics.ate(meshed["poses"], gt)["rmse"] - metrics.ate(single.poses, gt)["rmse"]) < 0.02
    assert meshed["landmarks"].shape[0] > 100


def test_meshed_ba_run_makes_the_single_process_solves():
    """Window BA under a (1, 2) mesh: the worker's solves reduce over its own group while the frame
    loop gathers over the mesh's. Same keyframes, same number of solves, same poses to 2e-2 m."""
    single = p_runner.run_sequence(_feed(), _cfg(), warmup=False, device="cpu", use_ba=True)
    per_rank = p_mesh.launch(_run_rank, (1, 2), "cpu", args=(dict(use_ba=True),), timeout=120.0)
    _assert_same(per_rank[1], per_rank[0], "rank 1 against rank 0")
    stats = per_rank[0]["refine_stats"]
    assert stats["n_keyframes"] == single.refine_stats["n_keyframes"] == 5
    assert stats["ba_solves"] == single.refine_stats["ba_solves"] >= 1
    assert np.abs(per_rank[0]["poses"][:, :3, 3] - single.poses[:, :3, 3]).max() < 2e-2


def test_meshed_checkpoint_resumes_under_the_mesh(tmp_path):
    path = str(tmp_path / "ck.npz")
    per_rank = p_mesh.launch(_resume_rank, (1, 2), "cpu", args=(path,), timeout=180.0)
    for r, (resumed, full) in enumerate(per_rank):
        _assert_same(resumed, full, f"rank {r}: resumed against uninterrupted")
    _assert_same(per_rank[1][0], per_rank[0][0], "rank 1 against rank 0")
    assert per_rank[0][0]["refine_stats"]["ba_solves"] >= 1
    assert Path(path).exists()


def test_run_sequence_refuses_what_is_not_a_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        p_runner.run_sequence(_feed(2), _cfg(), device="cpu", mesh=(1, 2))


def _batch_one_rank(mesh, device):
    """What a "data" = 2 mesh hands the detection kernels: one image per rank."""
    seen = []
    plain = kernels.extrema_scores_octaves

    def spy(stacks, *a, **k):
        seen.append(int(stacks[0].shape[0]))
        return plain(stacks, *a, **k)

    kernels.extrema_scores_octaves = spy
    p_runner.run_sequence(_feed(3), _cfg(), warmup=False, mesh=mesh, device=device)
    return seen


def test_data_axis_gives_detection_a_batch_of_one():
    per_rank = p_mesh.launch(_batch_one_rank, (2, 1), "cpu", timeout=120.0)
    assert per_rank[0] == per_rank[1] == [1, 1, 1]


@pytest.mark.slow
def test_meshed_run_2x4_matches_single_process():
    """The reference's 2 x 4 mesh (eight ranks)."""
    single = p_runner.run_sequence(_feed(), _cfg(), warmup=False, device="cpu", progress=lambda i, s: None)
    per_rank = p_mesh.launch(_run_rank, (2, 4), "cpu", args=({},), timeout=600.0)
    for r in range(1, 8):
        _assert_same(per_rank[r], per_rank[0], f"rank {r} against rank 0")
    np.testing.assert_array_equal(per_rank[0]["pose_ok"], single.pose_ok)
    assert np.abs(per_rank[0]["poses"][:, :3, 3] - single.poses[:, :3, 3]).max() < 2e-2
