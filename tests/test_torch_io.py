"""vo_tpu_torch.io against vo_tpu.io: the committed KITTI-00 geometry and byte-identical rendered frames."""
from pathlib import Path

import numpy as np
import pytest

from vo_tpu.io import kitti as r_kitti
from vo_tpu.io import synthetic as r_syn
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn

DATA = Path(__file__).parent / "data"


def test_committed_kitti_00_geometry():
    calib = p_kitti.load_stereo_calib(str(DATA / "kitti" / "00"))
    assert calib.fu == pytest.approx(718.856)
    assert calib.baseline == pytest.approx(0.5372, abs=1e-4)
    poses = p_kitti.read_poses(str(DATA / "kitti" / "poses" / "00.txt"))
    assert poses.shape == (4500, 4, 4)
    np.testing.assert_array_equal(poses, r_kitti.read_poses(str(DATA / "kitti" / "poses" / "00.txt")))
    np.testing.assert_allclose(poses[:, :3, :3] @ poses[:, :3, :3].transpose(0, 2, 1), np.broadcast_to(np.eye(3), (4500, 3, 3)), atol=1e-5)


@pytest.mark.parametrize("image_size", [None, (188, 620)])
def test_rendered_frames_byte_identical(image_size):
    kw = dict(n_frames=3, n_landmarks=800, seed=4, image_size=image_size)
    p = p_syn.kitti_synthetic_sequence(**kw)  # default root: the committed tests/data/kitti
    r = r_syn.kitti_synthetic_sequence(str(DATA), **kw)
    assert p.calib.image_size == r.calib.image_size
    np.testing.assert_array_equal(p.calib.P1.numpy(), np.asarray(r.calib.P1))
    np.testing.assert_array_equal(p.landmarks, r.landmarks)
    for i in (0, 2):
        for a, b in zip(p.frame(i), r.frame(i)):
            assert a.dtype == b.dtype == np.float32
            assert a.tobytes() == b.tobytes()
