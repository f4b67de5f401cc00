"""A run with the timed path broken underneath comes out not correct. The look for a card is
skipped: each case drives the rest of a run (set-up, window, check) on the CPU at a small size,
with one fault planted in the program:

- the step returns its state unchanged;
- half of each detection batch left out (the group's second frame gets the first one's features);
- an answer altered where it is produced: the pose estimate moved 1 cm, the landmarks the step
  inserts moved 1 cm, or the world pose the step chains moved 1 cm a frame (on the plain and on the
  refined path).

(The cells run on one card: there is no exchange between cards to leave out.)
"""
import time

import pytest
import torch

from perfbench import harness

from .conftest import REFINED, SMALL_CLOSED


def _run(cell="vo.offline", overrides=SMALL_CLOSED):
    code, out = harness.run_cell(cell, 2**32 + 11, 1.0, False, time.perf_counter(), device="cpu", overrides=overrides, workers=2)
    assert code == 0
    print({k: v["value"] for k, v in out["checks"].items()})
    return out


def _failed(out):
    return sorted(k for k, v in out["checks"].items() if not v["value"] <= v["limit"])


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True and not _failed(out)


def test_state_unchanged(monkeypatch):
    from vo_tpu_torch.odometry import pipeline

    core = pipeline._step_core

    def stuck(state, *a, **k):
        return state, core(state, *a, **k)[1]

    monkeypatch.setattr(pipeline, "_step_core", stuck)
    out = _run()
    assert out["correct"] is False and "stat_mismatches" in _failed(out)


def test_half_the_batch_left_out(monkeypatch):
    from vo_tpu_torch.odometry import pipeline

    def half(state, frames, calib, cfg):
        feats = pipeline._detect(torch.stack([pipeline._normalize(f) for f in frames[:2]]), cfg)
        outs = []
        for _ in range(len(frames) // 2):
            state, out = pipeline._step_core(state, pipeline._image_features(feats, 0), pipeline._image_features(feats, 1), calib, cfg)
            outs.append(out)
        return state, outs

    monkeypatch.setattr(pipeline, "vo_step_multi", half)
    out = _run()
    assert out["correct"] is False and "stat_mismatches" in _failed(out)


def test_pose_altered(monkeypatch):
    from vo_tpu_torch.odometry import pipeline

    est = pipeline.estimate_world_pose

    def moved(*a, **k):
        e = est(*a, **k)
        p = e.pose_c2w.clone()
        p[0, 3] += 0.01
        return e._replace(pose_c2w=p)

    monkeypatch.setattr(pipeline, "estimate_world_pose", moved)
    out = _run()
    assert out["correct"] is False and "rel_t_gap_m" in _failed(out)


def test_landmarks_altered(monkeypatch):
    from vo_tpu_torch.odometry import landmarks

    insert = landmarks.insert

    def moved(lmap, l_px, r_px, mask, pose, calib, cfg):
        p = pose.clone()
        p[1, 3] += 0.01
        return insert(lmap, l_px, r_px, mask, p, calib, cfg)

    monkeypatch.setattr(landmarks, "insert", moved)
    out = _run()
    assert out["correct"] is False and _failed(out) == ["landmark_miss_share"]


@pytest.mark.parametrize("path", ["plain", "refined"])
def test_world_pose_altered(monkeypatch, request, path):
    """Also on the refined path, where the check reads the frame loop's own rows (``step_rows``)."""
    from vo_tpu_torch.odometry import pipeline

    if path == "refined":
        request.getfixturevalue("step_rows")

    core = pipeline._step_core

    def drifting(state, *a, **k):
        new, out = core(state, *a, **k)
        p = out.pose_c2w.clone()
        p[2, 3] += 0.01
        return new._replace(pose_c2w=p), out._replace(pose_c2w=p)

    monkeypatch.setattr(pipeline, "_step_core", drifting)
    out = _run(overrides=REFINED if path == "refined" else SMALL_CLOSED)
    assert out["correct"] is False and "chain_rel_gap" in _failed(out)
