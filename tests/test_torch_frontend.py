"""vo_tpu_torch.frontend against vo_tpu.frontend on the same inputs.

Pyramids agree to float32 rounding (1e-5). Detection is held as a SET:
top-k tie order is not specified, and the quadratic subpixel step amplifies
last-bit differences of the pyramid, so a keypoint is shared when the port has
one within 1e-3 px of it (same orientation within 1e-3 rad) whose descriptor
is within 1e-4; at least 98% of the reference's valid keypoints must be
shared. Matching and tracking fed the same descriptors give identical index sets.
The port gets each configuration in its own classes (``config_from_reference``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.config import MatcherConfig, SIFTConfig
from vo_tpu.frontend import match as r_match
from vo_tpu.frontend import pyramid as r_pyr
from vo_tpu.frontend import sift as r_sift
from vo_tpu.frontend import track as r_track
from vo_tpu_torch.convert import config_from_reference, features_from_numpy, to_numpy
from vo_tpu_torch.frontend import match as p_match
from vo_tpu_torch.frontend import pyramid as p_pyr
from vo_tpu_torch.frontend import sift as p_sift
from vo_tpu_torch.frontend import track as p_track
from vo_tpu_torch.io import synthetic

SIZE = (188, 620)
CFG = SIFTConfig(max_keypoints=384, n_octaves=3)


@pytest.fixture(scope="module")
def frames():
    """Left/right images of frames 0 and 1 of a rendered 188x620 feed, [4, H, W] float32."""
    seq = synthetic.kitti_synthetic_sequence(n_frames=2, n_landmarks=1500, seed=2, image_size=SIZE)
    return np.stack([im for i in range(2) for im in seq.frame(i)]).astype(np.float32)


@pytest.fixture(scope="module")
def port_feats(frames):
    """The port's Features of the four images, as numpy (fed to both packages' matchers)."""
    return to_numpy(p_sift.detect_and_describe(torch.from_numpy(frames), config_from_reference(CFG)))


def _image(feats, i):
    return type(feats)(*(f[i] for f in feats))


def test_pyramid_gauss_and_dog(frames):
    cfg = SIFTConfig(n_octaves=4)
    P = p_pyr.build_pyramid(torch.from_numpy(frames[:2]), config_from_reference(cfg))
    for b in range(2):
        R = r_pyr.build_pyramid(jnp.asarray(frames[b]), cfg)
        for o in range(4):
            np.testing.assert_allclose(P.gauss[o][b].numpy(), np.asarray(R.gauss[o]), atol=1e-5)
            np.testing.assert_allclose(P.dog[o][b].numpy(), np.asarray(R.dog[o]), atol=1e-5)


@pytest.mark.parametrize("n_orientations", [1, 2])
def test_detect_and_describe_matches_reference(frames, n_orientations):
    cfg = SIFTConfig(max_keypoints=384, n_octaves=3, n_orientations=n_orientations)
    img = frames[:2]
    ref = jax.jit(jax.vmap(lambda im: r_sift.detect_and_describe(im, cfg)))(jnp.asarray(img))
    got = p_sift.detect_and_describe(torch.from_numpy(img), config_from_reference(cfg))
    for b in range(2):
        rm = np.asarray(ref.mask[b])
        pm = got.mask[b].numpy()
        assert rm.sum() > 100 and abs(int(rm.sum()) - int(pm.sum())) <= 0.02 * rm.sum()
        rxy, pxy = np.asarray(ref.xy[b])[rm], got.xy[b].numpy()[pm]
        rori, pori = np.asarray(ref.orientation[b])[rm], got.orientation[b].numpy()[pm]
        rdesc, pdesc = np.asarray(ref.desc[b])[rm], got.desc[b].numpy()[pm]
        dxy = np.abs(rxy[:, None, :] - pxy[None, :, :]).max(-1)
        dori = np.abs(rori[:, None] - pori[None, :])
        close = (dxy < 1e-3) & (dori < 1e-3)
        j = np.argmax(close, axis=1)
        shared = close.any(axis=1) & (np.abs(rdesc - pdesc[j]).max(-1) < 1e-4)
        assert shared.mean() >= 0.98, (b, shared.mean())


def test_match_identical_index_sets(port_feats):
    """Stereo match of frame 0 and the temporal match frame 1 -> 0, mutual and not."""
    f = port_feats
    for a, b in ((0, 1), (2, 0)):
        for mutual in (True, False):
            cfg = MatcherConfig(mutual=mutual)
            args = (f.desc[a], f.mask[a], f.desc[b], f.mask[b])
            r = r_match.match(*(jnp.asarray(x) for x in args), cfg, 256)
            p = p_match.match(*(torch.from_numpy(x) for x in args), config_from_reference(cfg), 256)
            assert int(np.asarray(r.mask).sum()) > 20
            for k in ("a_idx", "b_idx", "mask"):
                np.testing.assert_array_equal(getattr(p, k).numpy(), np.asarray(getattr(r, k)), err_msg=k)
            np.testing.assert_allclose(p.dist.numpy(), np.asarray(r.dist), atol=1e-5)


def test_track_identical_index_sets(port_feats):
    """Frame 0's stereo set, then the 4-stage cascade of frame 1 against it."""
    cap = 256
    mc = MatcherConfig()
    pmc = config_from_reference(mc)
    f0l, f0r, f1l, f1r = (_image(port_feats, i) for i in range(4))
    r_old = r_track.stereo_features(
        r_sift.Features(*(jnp.asarray(x) for x in f0l)), r_sift.Features(*(jnp.asarray(x) for x in f0r)), mc, cap
    )
    p_old, _ = p_track.stereo_features_with_matches(
        features_from_numpy(f0l, "cpu"), features_from_numpy(f0r, "cpu"), pmc, cap
    )
    for k in ("l_xy", "r_xy", "l_desc", "r_desc", "mask", "ids"):
        np.testing.assert_array_equal(getattr(p_old, k).numpy(), np.asarray(getattr(r_old, k)), err_msg=k)
    r = r_track.track(
        r_old, r_sift.Features(*(jnp.asarray(x) for x in f1l)), r_sift.Features(*(jnp.asarray(x) for x in f1r)), mc, cap
    )
    p = p_track.track(p_old, features_from_numpy(f1l, "cpu"), features_from_numpy(f1r, "cpu"), pmc, cap)
    assert int(np.asarray(r.mask).sum()) > 20
    for k in ("cur_l_idx", "cur_r_idx", "old_row", "mask"):
        np.testing.assert_array_equal(getattr(p, k).numpy(), np.asarray(getattr(r, k)), err_msg=k)
