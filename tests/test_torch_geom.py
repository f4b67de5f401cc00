"""vo_tpu_torch.geom against vo_tpu.geom on the same float32 inputs (tolerance 1e-5)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.geom import se3 as r_se3
from vo_tpu.geom import triangulate as r_tri
from vo_tpu.io import kitti as r_kitti
from vo_tpu_torch.geom import se3 as p_se3
from vo_tpu_torch.geom import triangulate as p_tri
from vo_tpu_torch.geom.camera import calib_from_projections
from vo_tpu_torch.io import kitti as p_kitti

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

KITTI_00 = Path(__file__).parent / "data" / "kitti" / "00"
TOL = 1e-5


def test_se3_exp_compose_inv_apply(rng):
    xi = np.concatenate([rng.normal(0, 2.0, (16, 3)), rng.normal(0, 0.5, (16, 3))], axis=1).astype(np.float32)
    xi[0, 3:] = 0.0  # the small-angle branch
    Tr = np.array(r_se3.exp(jnp.asarray(xi)))
    Tp = p_se3.exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(Tp, Tr, atol=TOL)
    A, B = Tr[:8], Tr[8:]
    np.testing.assert_allclose(
        p_se3.compose(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
        np.asarray(r_se3.compose(jnp.asarray(A), jnp.asarray(B))),
        atol=TOL,
    )
    np.testing.assert_allclose(p_se3.inv(torch.from_numpy(Tr)).numpy(), np.asarray(r_se3.inv(jnp.asarray(Tr))), atol=TOL)
    pts = rng.normal(0, 10.0, (16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        p_se3.apply(torch.from_numpy(Tr), torch.from_numpy(pts)).numpy(),
        np.asarray(r_se3.apply(jnp.asarray(Tr), jnp.asarray(pts))),
        atol=10 * TOL,  # 10 m coordinates: 1e-5 relative
    )
    w = rng.normal(0, 0.3, (8, 3)).astype(np.float32)
    np.testing.assert_allclose(p_se3.exp_so3(torch.from_numpy(w)).numpy(), np.asarray(r_se3.exp_so3(jnp.asarray(w))), atol=TOL)
    np.testing.assert_array_equal(p_se3.hat(torch.from_numpy(w)).numpy(), np.asarray(r_se3.hat(jnp.asarray(w))))


def test_calib_from_committed_kitti_00():
    r = r_kitti.load_stereo_calib(str(KITTI_00))
    p = p_kitti.load_stereo_calib(str(KITTI_00))
    np.testing.assert_array_equal(p.P1.numpy(), np.asarray(r.P1))
    np.testing.assert_array_equal(p.P2.numpy(), np.asarray(r.P2))
    for k in ("fu", "fv", "cu", "cv", "baseline"):
        assert getattr(p, k) == pytest.approx(float(getattr(r, k)), rel=TOL), k
    assert p.image_size == r.image_size == (376, 1241)


def test_triangulate_rectified(rng):
    P = r_kitti.read_calib(str(KITTI_00 / "calib.txt"))
    r = r_kitti.load_stereo_calib(str(KITTI_00))
    p = calib_from_projections(P["P0"], P["P1"], device="cpu")
    px_l = rng.uniform([0, 0], [1241, 376], (64, 2)).astype(np.float32)
    px_r = px_l - np.stack([rng.uniform(-2.0, 60.0, 64), np.zeros(64)], -1).astype(np.float32)  # some disparities <= 0
    Xr = np.asarray(r_tri.triangulate_rectified(jnp.asarray(px_l), jnp.asarray(px_r), r))
    Xp = p_tri.triangulate_rectified(torch.from_numpy(px_l), torch.from_numpy(px_r), p).numpy()
    np.testing.assert_allclose(Xp, Xr, rtol=TOL, atol=TOL)
