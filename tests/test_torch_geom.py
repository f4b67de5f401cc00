"""vo_tpu_torch.geom against vo_tpu.geom on the same inputs: 1e-5 in float32 for the first slice's
functions; 1e-6 (float32) and 1e-12 (float64) for the logarithms, the projections and the alignment."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.geom import camera as r_cam
from vo_tpu.geom import se3 as r_se3
from vo_tpu.geom import triangulate as r_tri
from vo_tpu.io import kitti as r_kitti
from vo_tpu_torch.geom import camera as p_cam
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


def _rotations(rng, dtype):
    """Axis-angle vectors covering every branch of log_so3: theta = 0, theta < 1e-4, generic,
    and theta within 1e-3 of pi."""
    w = rng.normal(0, 0.7, (24, 3))
    w[0] = 0.0
    w[1:4] *= 3e-5 / np.linalg.norm(w[1:4], axis=1, keepdims=True)
    near_pi = np.pi - np.array([5e-4, 2e-4, 9e-4, 1e-5])
    w[4:8] *= (near_pi / np.linalg.norm(w[4:8], axis=1))[:, None]
    return w.astype(dtype)


# 1e-6 in float32 means 1e-6 of the value's scale: the translations below run to a few metres,
# where one float32 ulp is 5e-7.
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_se3_log_matches_reference(rng, dtype, tol):
    from jax import enable_x64

    with enable_x64(dtype == np.float64):  # scoped: the reference's own tests run in this process too
        w = _rotations(rng, dtype)
        R = np.array(r_se3.exp_so3(jnp.asarray(w)))
        got = p_se3.log_so3(torch.from_numpy(R)).numpy()
        want = np.asarray(r_se3.log_so3(jnp.asarray(R)))
        assert got.dtype == want.dtype == dtype
        np.testing.assert_allclose(got, want, atol=tol)  # every branch, the near-pi rows (4:8) included
        np.testing.assert_array_equal(got[0], 0.0)

        xi = np.concatenate([rng.normal(0, 2.0, (24, 3)), w], axis=1).astype(dtype)
        xi[4:8, 3:] *= 0.5  # the translation's V^-1 divides by 1 - cos: keep it away from pi
        T = np.array(r_se3.exp(jnp.asarray(xi)))
        got = p_se3.log(torch.from_numpy(T)).numpy()
        np.testing.assert_allclose(got, np.asarray(r_se3.log(jnp.asarray(T))), atol=4 * tol)
        # exp(log(T)) = T
        back = p_se3.exp(torch.from_numpy(got)).numpy()
        np.testing.assert_allclose(back, T, atol=1e-5 if dtype == np.float32 else 1e-10)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_orthonormalize_kabsch_identity_match_reference(rng, dtype, tol):
    from jax import enable_x64

    with enable_x64(dtype == np.float64):
        M = (np.asarray(r_se3.exp_so3(jnp.asarray(rng.normal(0, 0.6, (8, 3))))) + rng.normal(0, 0.05, (8, 3, 3))).astype(dtype)
        M[0] = M[0] @ np.diag([1.0, 1.0, -1.0]).astype(dtype)  # a reflection: det +1 must be enforced
        got = p_se3.orthonormalize(torch.from_numpy(M)).numpy()
        np.testing.assert_allclose(got, np.asarray(r_se3.orthonormalize(jnp.asarray(M))), atol=4 * tol)
        np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)

        src = rng.normal(0, 3.0, (4, 20, 3)).astype(dtype)
        Rt = np.asarray(r_se3.exp_so3(jnp.asarray(rng.normal(0, 0.5, (4, 3)).astype(dtype))))
        dst = (np.einsum("bij,bnj->bni", Rt, src) + rng.normal(0, 2.0, (4, 1, 3)) + rng.normal(0, 0.01, src.shape)).astype(dtype)
        wts = rng.uniform(0.2, 1.0, (4, 20)).astype(dtype)
        for w_np in (None, wts):
            Rp, tp = p_se3.kabsch(torch.from_numpy(src), torch.from_numpy(dst), None if w_np is None else torch.from_numpy(w_np))
            Rr, tr = r_se3.kabsch(jnp.asarray(src), jnp.asarray(dst), None if w_np is None else jnp.asarray(w_np))
            np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), atol=4 * tol)
            np.testing.assert_allclose(tp.numpy(), np.asarray(tr), atol=16 * tol)
        eye = p_se3.identity(torch.float64 if dtype == np.float64 else torch.float32, device="cpu")
        np.testing.assert_array_equal(eye.numpy(), np.asarray(r_se3.identity(dtype)))


def test_camera_projections_match_reference(rng):
    r = r_kitti.load_stereo_calib(str(KITTI_00))
    p = p_kitti.load_stereo_calib(str(KITTI_00))
    np.testing.assert_array_equal(p.K.numpy(), np.asarray(r.K))
    pts = np.concatenate([rng.uniform(-20, 20, (2, 40, 2)), rng.uniform(2, 60, (2, 40, 1))], -1).astype(np.float32)
    px = rng.uniform([0, 0], [1241, 376], (2, 40, 2)).astype(np.float32)
    depth = rng.uniform(2, 60, (2, 40)).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    # pixels run to ~1e3: 1e-6 relative
    np.testing.assert_allclose(p_cam.project(p.P2, t(pts)).numpy(), np.asarray(r_cam.project(r.P2, j(pts))), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        p_cam.project_pinhole(p, t(pts)).numpy(), np.asarray(r_cam.project_pinhole(r, j(pts))), rtol=1e-6, atol=1e-4
    )
    np.testing.assert_allclose(
        p_cam.unproject_pinhole(p, t(px), t(depth)).numpy(), np.asarray(r_cam.unproject_pinhole(r, j(px), j(depth))),
        rtol=1e-6, atol=1e-5,
    )
    np.testing.assert_allclose(p_cam.bearings(p, t(px)).numpy(), np.asarray(r_cam.bearings(r, j(px))), atol=1e-6)
    back = p_cam.project_pinhole(p, p_cam.unproject_pinhole(p, t(px), t(depth))).numpy()
    np.testing.assert_allclose(back, px, atol=1e-3)


def test_triangulate_dlt_matches_reference(rng):
    r = r_kitti.load_stereo_calib(str(KITTI_00))
    p = p_kitti.load_stereo_calib(str(KITTI_00))
    pts = np.concatenate([rng.uniform(-15, 15, (64, 2)), rng.uniform(4, 50, (64, 1))], -1).astype(np.float32)
    px1 = np.array(r_cam.project(r.P1, jnp.asarray(pts)))
    px2 = np.array(r_cam.project(r.P2, jnp.asarray(pts)))
    got = p_tri.triangulate_dlt(torch.from_numpy(px1), torch.from_numpy(px2), p.P1, p.P2).numpy()
    want = np.asarray(r_tri.triangulate_dlt(jnp.asarray(px1), jnp.asarray(px2), r.P1, r.P2))
    # Both sides solve the same 3x3 normal equations in float32, whose error in depth is itself
    # 2e-2 m against the truth here; the two solvers differ by 5e-4 of the depth (measured).
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, pts, rtol=2e-2, atol=5e-2)
