"""The port's undistortion stage against vo_tpu.io.undistort, and the port's mirrors of
tests/test_undistort.py on the committed KITTI-00 calibration.

``build_remap`` is the reference's numpy code, so the tables must be equal;
``undistort_image`` keeps the reference's gather arithmetic and must agree at
1e-6 on the same image and a real plumb-bob model. The remap table and the
warp live on the device the caller names (``device="cpu"`` here).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.io import kitti as r_kitti
from vo_tpu.io import undistort as r_und
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import undistort as p_und

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
MODEL = dict(k1=-0.05, k2=0.002, p1=1e-4, p2=-1e-4, k3=1e-4)


@pytest.fixture(scope="module")
def calibs():
    return p_kitti.load_stereo_calib(str(DATA / "00")), r_kitti.load_stereo_calib(str(DATA / "00"))


def _smooth_image(H, W):
    yy, xx = np.mgrid[0:H, 0:W]
    return (0.5 + 0.3 * np.sin(xx / 40.0) * np.cos(yy / 30.0)).astype(np.float32)


def test_build_remap_equals_reference(calibs):
    p_calib, r_calib = calibs
    got = p_und.build_remap(p_calib, p_und.DistortionModel(**MODEL))
    want = r_und.build_remap(r_calib, r_und.DistortionModel(**MODEL))
    assert got.shape == (376, 1241, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    xn, yn = np.linspace(-0.8, 0.8, 9), np.linspace(-0.3, 0.3, 9)
    for a, b in zip(p_und.distort_normalized(xn, yn, p_und.DistortionModel(**MODEL)),
                    r_und.distort_normalized(xn, yn, r_und.DistortionModel(**MODEL))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", [MODEL, dict(k1=0.08, p1=2e-4)], ids=["barrel", "pincushion"])
def test_undistort_image_matches_reference(calibs, rng, model):
    p_calib, _ = calibs
    H, W = p_calib.image_size
    img = _smooth_image(H, W) + rng.normal(scale=0.02, size=(H, W)).astype(np.float32)
    remap = p_und.build_remap(p_calib, p_und.DistortionModel(**model))
    got = p_und.undistort_image(torch.from_numpy(img), torch.from_numpy(remap)).numpy()
    want = np.asarray(r_und.undistort_image(jnp.asarray(img), jnp.asarray(remap)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # The pincushion model pulls samples from outside the frame near the corners: zero-filled.
    outside = (remap[..., 1] < 0) | (remap[..., 1] > W - 1) | (remap[..., 0] < 0) | (remap[..., 0] > H - 1)
    assert outside.any() == (model is not MODEL)
    assert not got[outside].any() and got[~outside].min() > 0.0


def test_undistorter_matches_reference(calibs):
    p_calib, r_calib = calibs
    img = _smooth_image(*p_calib.image_size)
    got = p_und.Undistorter(p_calib, p_und.DistortionModel(**MODEL), device="cpu")(torch.from_numpy(img))
    want = r_und.Undistorter(r_calib, r_und.DistortionModel(**MODEL))(jnp.asarray(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_identity_model_is_noop(calibs):
    u = p_und.Undistorter(calibs[0], device="cpu")  # no coefficients: VO.m:50-51
    assert u.identity
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (32, 64)).astype(np.float32))
    assert u(img) is img  # literally no work


def test_remap_inverts_distortion(calibs):
    """The remap agrees with the forward model at feature positions: a point at undistorted
    (u, v) is sampled from distort(u, v)."""
    calib = calibs[0]
    model = p_und.DistortionModel(k1=-0.05, k2=0.002, p1=1e-4, p2=-1e-4)
    assert not model.is_identity
    remap = p_und.build_remap(calib, model)
    fu, fv, cu, cv_ = float(calib.fu), float(calib.fv), float(calib.cu), float(calib.cv)
    for u, v in [(200.0, 100.0), (900.0, 300.0), (620.0, 190.0)]:
        xd, yd = p_und.distort_normalized(np.array([(u - cu) / fu]), np.array([(v - cv_) / fv]), model)
        got_v, got_u = remap[int(v), int(u)]
        assert abs(got_u - (xd[0] * fu + cu)) < 1.0 and abs(got_v - (yd[0] * fv + cv_)) < 1.0


def test_center_pixel_fixed_point(calibs):
    """The principal point is a fixed point of radial distortion."""
    calib = calibs[0]
    remap = p_und.build_remap(calib, p_und.DistortionModel(k1=-0.1))
    src = remap[int(float(calib.cv)), int(float(calib.cu))]
    assert abs(src[1] - float(calib.cu)) < 1.5 and abs(src[0] - float(calib.cv)) < 1.5


def test_undistorter_follows_the_default_device_rule(calibs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        p_und.Undistorter(calibs[0], p_und.DistortionModel(k1=-0.1))
    u = p_und.Undistorter(calibs[0], p_und.DistortionModel(k1=-0.1), device="cpu")
    assert u._remap.device.type == "cpu"
