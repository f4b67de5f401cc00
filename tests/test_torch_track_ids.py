"""Persistent track ids through the port's ``make_jitted_step``, and its determinism.

The port's counterparts of tests/test_track_ids.py and
tests/test_dist.py::test_step_determinism, at those tests' sizes, on the
committed KITTI-00 geometry (tests/data/kitti), so no dataset outside the
repository is read.
Each frame's state and output are read to numpy as soon as the step returns
them: on a CUDA card the step's next call overwrites them.
"""
import numpy as np
import pytest
import torch

from vo_tpu_torch import convert
from vo_tpu_torch.config import PipelineConfig, RansacConfig, SIFTConfig
from vo_tpu_torch.geom import se3, triangulate
from vo_tpu_torch.io import synthetic
from vo_tpu_torch.odometry.pipeline import init_state, make_jitted_step

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)


def _frame(seq, i):
    return tuple(torch.from_numpy(np.asarray(im, np.float32)) for im in seq.frame(i))


@pytest.fixture(scope="module")
def run_states():
    seq = synthetic.kitti_synthetic_sequence(n_frames=5, n_landmarks=900, seed=7, image_size=(128, 256))
    cfg = PipelineConfig(sift=SIFTConfig(max_keypoints=256, n_octaves=2), ransac=RansacConfig(n_hypotheses=64), max_tracks=256)
    step = make_jitted_step(seq.calib, cfg)
    st = init_state(cfg, seed=0, device="cpu")
    states = []
    for i in range(5):
        st, out = step(st, *_frame(seq, i))
        states.append((convert.to_numpy(st), convert.to_numpy(out)))
    return seq, states


def test_ids_unique_per_frame(run_states):
    _, states = run_states
    for st, _ in states:
        ids, m = st.prev.ids, st.prev.mask
        valid = ids[m]
        assert (valid >= 0).all()
        assert len(np.unique(valid)) == len(valid)  # no duplicate ids in a frame
        assert (ids[~m] == -1).all()


def test_ids_persist_across_frames(run_states):
    _, states = run_states
    # A healthy fraction of frame-3 ids already exist in frame 2 (features tracked across frames).
    ids2 = states[2][0].prev.ids[states[2][0].prev.mask]
    ids3 = states[3][0].prev.ids[states[3][0].prev.mask]
    shared = np.intersect1d(ids2, ids3)
    assert len(shared) > 0.3 * min(len(ids2), len(ids3)), (len(shared), len(ids2), len(ids3))


def test_shared_ids_are_same_landmark(run_states):
    """Rows sharing an id across frames are geometrically consistent: the world point triangulated
    in frame 2 is near the one from frame 3."""
    seq, states = run_states
    pts = {}
    for k in (2, 3):
        st, out = states[k]
        m = st.prev.mask
        X = triangulate.triangulate_rectified(torch.from_numpy(st.prev.l_xy), torch.from_numpy(st.prev.r_xy), seq.calib)
        Xw = se3.apply(torch.from_numpy(out.pose_c2w), X).numpy()[m]
        pts[k] = dict(zip(st.prev.ids[m].tolist(), Xw))
    shared = set(pts[2]) & set(pts[3])
    assert shared
    med = np.median([np.linalg.norm(pts[2][i] - pts[3][i]) for i in shared])
    # Stereo depth noise scales as z^2 / (f * b): at this reduced resolution a half-pixel disparity
    # error at z = 30 m is already ~3 m. Id mix-ups would show tens of meters; gate well below that.
    sigma_z = 30.0**2 / (seq.calib.fu * seq.calib.baseline) * 0.25
    assert med < max(1.0, 2.0 * sigma_z), (med, sigma_z)


def test_next_id_monotone(run_states):
    _, states = run_states
    nid = [int(st.next_id) for st, _ in states]
    assert all(b >= a for a, b in zip(nid, nid[1:]))
    assert nid[-1] > 0


def test_step_determinism():
    """Identical inputs, the same seed -> bit-identical step outputs."""
    seq = synthetic.kitti_synthetic_sequence(n_frames=2, n_landmarks=500, seed=9, image_size=(128, 256))
    cfg = PipelineConfig(sift=SIFTConfig(max_keypoints=128, n_octaves=2), ransac=RansacConfig(n_hypotheses=64), max_tracks=128)
    step = make_jitted_step(seq.calib, cfg)
    left, right = _frame(seq, 0)
    s1, o1 = convert.to_numpy(step(init_state(cfg, seed=3, device="cpu"), left, right))
    s2, o2 = convert.to_numpy(step(init_state(cfg, seed=3, device="cpu"), left, right))
    np.testing.assert_array_equal(o1.pose_c2w, o2.pose_c2w)
    np.testing.assert_array_equal(s1.prev.l_desc, s2.prev.l_desc)
    np.testing.assert_array_equal(s1.prev.ids, s2.prev.ids)
    assert s1.prev.mask.sum() > 20
