"""Shared fixtures of the benchmark's tests: ``cuda`` decides inside the test whether there is a card."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


# A cell at a size the CPU runs in seconds: 94x311 images, 256 keypoints, an 11-frame log.
SMALL = dict(
    config=dict(sequence=dict(image_size=[94, 311]), pipeline=dict(sift=dict(max_keypoints=256), max_tracks=256, ransac=dict(n_hypotheses=64))),
    traffic=dict(poses=6, landmarks_per_pose=60),
    check=dict(samples=8),
)
# SMALL for a closed-loop cell: a window of two jobs (the traffic file's 8 would take the CPU long).
SMALL_CLOSED = dict(SMALL, traffic=dict(SMALL["traffic"], jobs=2))
# SMALL_CLOSED on the refined path (window BA + loop closure), over 31-frame logs (GT poses 0..15..0):
# six keyframes a job, so the refiner solves the window and re-anchoring moves rows.
REFINED = dict(
    SMALL_CLOSED,
    config=dict(SMALL_CLOSED["config"], run=dict(use_ba=True, use_loop_closure=True)),
    traffic=dict(SMALL_CLOSED["traffic"], poses=16),
)


@pytest.fixture
def step_rows(monkeypatch):
    """Every RunResult carries the frame loop's own rows, before re-anchoring, as ``step_poses`` /
    ``step_rel_poses``: where the program's ``RunResult`` has no such fields, this stands in for
    them with the rows ``run_sequence`` reads from its history (``_History.stacked``) after its loop."""
    import dataclasses

    from vo_tpu_torch.odometry import runner

    if "step_poses" in {f.name for f in dataclasses.fields(runner.RunResult)}:
        return
    kept = []
    stacked, run_sequence = runner._History.stacked, runner.run_sequence

    def keep(self):
        kept.append(stacked(self))
        return kept[-1]

    def with_rows(*a, **k):
        kept.clear()
        res = run_sequence(*a, **k)
        res.step_poses, res.step_rel_poses = kept[-1]["pose_c2w"], kept[-1]["rel_pose"]
        return res

    monkeypatch.setattr(runner._History, "stacked", keep)
    monkeypatch.setattr(runner, "run_sequence", with_rows)
