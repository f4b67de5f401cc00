"""The port runner's per-frame history (``runner._History``), the counterpart of the reference's
``_DeviceHistory``: a device row keeps the five history fields of a frame, never its whole
``FrameOutput``, and every ``HISTORY_CHUNK`` rows are stacked on the device. A run longer than
several chunks gives the same ``RunResult`` whatever the chunk, deferred and resumed from a
checkpoint alike. On the CPU, at 128x256 with 256 keypoints."""
import numpy as np
import pytest
import torch

from vo_tpu_torch.config import PipelineConfig, RansacConfig, SIFTConfig
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import pipeline as p_pipe
from vo_tpu_torch.odometry import runner as p_runner

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

N = 11
RESULT_FIELDS = ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")


def _cfg():
    return PipelineConfig(
        sift=SIFTConfig(max_keypoints=256, n_octaves=3), ransac=RansacConfig(n_hypotheses=128), max_tracks=256
    )


@pytest.fixture(scope="module")
def seq():
    return p_syn.kitti_synthetic_sequence(n_frames=N, n_landmarks=800, seed=3, image_size=(128, 256))


def _contains_frame_output(obj, depth: int = 0) -> bool:
    if isinstance(obj, p_pipe.FrameOutput):
        return True
    if depth > 4:
        return False
    if isinstance(obj, dict):
        return any(_contains_frame_output(v, depth + 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_contains_frame_output(v, depth + 1) for v in obj)
    return False


class _Watched(p_runner._History):
    """A history that checks, after every frame lands, that it holds no FrameOutput."""

    made: list = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Watched.made.append(self)
        self.appended = 0

    def append(self, out) -> None:
        super().append(out)
        self.appended += 1
        assert not _contains_frame_output(vars(self)), "a FrameOutput stays in the history"
        assert len(self._pending) < self.chunk


def _run(seq, monkeypatch, chunk: int, **kw):
    monkeypatch.setattr(p_runner, "HISTORY_CHUNK", chunk)
    monkeypatch.setattr(p_runner, "_History", _Watched)
    _Watched.made.clear()
    res = p_runner.run_sequence(seq, _cfg(), warmup=False, device="cpu", **kw)
    (hist,) = _Watched.made
    return res, hist


def _same(a, b):
    for k in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def test_chunks_of_four_give_the_same_run(seq, monkeypatch):
    """Deferred run of N frames (N-1 rows: three chunks of 4 rows, the last partial) against one chunk."""
    small, hist = _run(seq, monkeypatch, 4)
    assert hist.chunk == 4 and hist.appended == N - 1
    assert len(hist._chunks) == -(-(N - 1) // 4) and not hist._pending
    big, hist_big = _run(seq, monkeypatch, 128)
    assert len(hist_big._chunks) == 1
    _same(small, big)
    assert small.poses.shape == (N - 1, 4, 4) and small.n_inliers.dtype == np.int32 and small.pose_ok.dtype == bool


def test_chunks_through_a_checkpoint_and_resume(seq, monkeypatch, tmp_path):
    """Checkpoint at frame 6 (host rows), then a deferred resume to N: the resumed history is the
    checkpoint's host rows followed by two device chunks; the result does not depend on the chunk."""
    ck = str(tmp_path / "ck.npz")
    p_runner.run_sequence(seq, _cfg(), n_frames=6, checkpoint_path=ck, checkpoint_every=6, warmup=False, device="cpu")
    small, hist = _run(seq, monkeypatch, 4, checkpoint_path=ck, resume=True)
    assert len(hist.host["pose_c2w"]) == 5 and hist.appended == N - 6 and len(hist._chunks) == 2
    big, _ = _run(seq, monkeypatch, 128, checkpoint_path=ck, resume=True)
    _same(small, big)
    # The non-deferred resume reads every frame on the host: no device rows at all.
    host, hist_host = _run(seq, monkeypatch, 4, checkpoint_path=ck, resume=True, progress=lambda i, s: None)
    assert hist_host.appended == 0 and not hist_host._chunks
    assert np.abs(host.poses - small.poses).max() < 1e-3  # 2-frame groups against single frames


def _fake_out(i: int) -> p_pipe.FrameOutput:
    z = torch.zeros(3)
    pose = torch.eye(4) + i
    return p_pipe.FrameOutput(
        pose_c2w=pose, rel_pose=pose * 2, pose_ok=torch.tensor(i % 2 == 0), n_tracks=torch.tensor(10 + i),
        n_inliers=torch.tensor(i, dtype=torch.int32), mean_reproj_err=torch.tensor(0.5),
        tracked_cur_px=z, tracked_old_px=z, tracked_disp_3d=z, tracked_mask=z, new_lm_l_px=z, new_lm_r_px=z, new_lm_mask=z,
    )


def test_stacked_mid_run_then_more_rows():
    """``stacked`` closes a partial chunk and can be called again after more rows land (live figures do)."""
    h = p_runner._History(chunk=3)
    h.extend_host(pose_c2w=[np.zeros((4, 4))], rel_pose=[np.zeros((4, 4))], n_inliers=[7], n_tracks=[8], pose_ok=[False])
    for i in range(4):
        h.append(_fake_out(i))
    mid = h.stacked()
    assert mid["pose_c2w"].shape == (5, 4, 4) and len(h._chunks) == 2
    for i in range(4, 9):
        h.append(_fake_out(i))
    rows = h.stacked()
    assert not _contains_frame_output(vars(h))
    want = [_fake_out(i) for i in range(9)]
    np.testing.assert_array_equal(rows["pose_c2w"][1:], np.stack([o.pose_c2w.numpy() for o in want]))
    np.testing.assert_array_equal(rows["rel_pose"][1:], np.stack([o.rel_pose.numpy() for o in want]))
    np.testing.assert_array_equal(rows["n_inliers"], [7] + list(range(9)))
    np.testing.assert_array_equal(rows["n_tracks"], [8] + [10 + i for i in range(9)])
    np.testing.assert_array_equal(rows["pose_ok"], [False] + [i % 2 == 0 for i in range(9)])
    for f in p_runner._HIST_FIELDS:
        np.testing.assert_array_equal(mid[f], rows[f][:5], err_msg=f)


def test_empty_history_has_typed_empty_rows():
    rows = p_runner._History().stacked()
    assert rows["pose_c2w"].shape == (0, 4, 4) and rows["n_inliers"].dtype == np.int32 and rows["pose_ok"].dtype == bool


def test_chunk_default_is_the_reference_chunk():
    from vo_tpu.odometry import runner as r_runner

    assert p_runner.HISTORY_CHUNK == r_runner._DeviceHistory().chunk == 128
