"""The port's Lowe-exact oracle path (``fast_descriptor=False``) against vo_tpu's, stage by stage.

``gradients`` at 1e-6; ``_bilinear_flat``, ``_orientation_hist_one`` and
``_descriptor_one`` at 1e-5 against the reference's per-keypoint functions
(vmapped) on the same two-octave gradient buffers and keypoints, made from a
numpy seed. The whole ``detect_and_describe`` on a rendered frame is held as
a SET, as tests/test_torch_frontend.py holds the fast path: a keypoint is
shared when the port has one within 1e-3 px and 1e-3 rad whose descriptor is
within 1e-4, and 98% of the reference's must be shared. On the CPU the exact
path takes K1's plain version and never computes K2's bin maps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.config import SIFTConfig
from vo_tpu.frontend import pyramid as r_pyr
from vo_tpu.frontend import sift as r_sift
from vo_tpu_torch.convert import config_from_reference
from vo_tpu_torch.frontend import kernels
from vo_tpu_torch.frontend import pyramid as p_pyr
from vo_tpu_torch.frontend import sift as p_sift
from vo_tpu_torch.io import synthetic

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

SIZE = (188, 620)
SHAPES = [(6, 40, 56), (6, 20, 28)]  # two octaves' [L, H, W] gradient stacks
B, K = 2, 48


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.kitti_synthetic_sequence(n_frames=1, n_landmarks=1500, seed=2, image_size=SIZE)
    return np.stack(seq.frame(0)).astype(np.float32)


@pytest.fixture(scope="module")
def stacks():
    """Per image: smooth random Gaussian stacks of two octaves, their gradients flattened into one
    buffer, and K keypoints spread over both octaves (some with windows past the image border)."""
    rng = np.random.default_rng(7)
    G = [
        np.stack([np.cumsum(np.cumsum(rng.normal(scale=0.05, size=s), axis=1), axis=2) for _ in range(B)]).astype(np.float32)
        for s in SHAPES
    ]
    grads = [p_pyr.gradients(torch.from_numpy(g)) for g in G]
    gx = torch.cat([g[0].flatten(1) for g in grads], dim=1)
    gy = torch.cat([g[1].flatten(1) for g in grads], dim=1)
    octave = rng.integers(0, 2, (B, K))
    H = np.asarray([s[1] for s in SHAPES])[octave]
    W = np.asarray([s[2] for s in SHAPES])[octave]
    row0 = np.asarray([0, int(np.prod(SHAPES[0]))])[octave]
    kp = dict(
        lvl=rng.integers(1, 4, (B, K)),
        yc=(rng.uniform(-1, 1, (B, K)) * 0.6 + 0.5) * H,
        xc=(rng.uniform(-1, 1, (B, K)) * 0.6 + 0.5) * W,
        sigma_rel=rng.uniform(1.6, 3.2, (B, K)),
        theta=rng.uniform(-np.pi, np.pi, (B, K)),
        H=H, W=W, row0=row0,
    )
    kp = {k: v.astype(np.float32) if v.dtype == np.float64 else v.astype(np.int64) for k, v in kp.items()}
    return G, gx, gy, kp


def _t(kp, *names):
    return [torch.from_numpy(kp[n]) for n in names]


def _j(kp, b, *names):
    return [jnp.asarray(kp[n][b]) for n in names]


def test_gradients_match_reference(stacks):
    G = stacks[0]
    for g in G:
        gx, gy = p_pyr.gradients(torch.from_numpy(g))
        for b in range(B):
            rx, ry = r_pyr.gradients(jnp.asarray(g[b]))
            np.testing.assert_allclose(gx[b].numpy(), np.asarray(rx), atol=1e-6)
            np.testing.assert_allclose(gy[b].numpy(), np.asarray(ry), atol=1e-6)
        assert not gx[..., 0].any() and not gx[..., -1].any() and not gy[..., 0, :].any() and not gy[..., -1, :].any()
        assert gx.abs().max() > 0


def test_bilinear_flat_matches_reference(stacks):
    _, gx, _, kp = stacks
    rng = np.random.default_rng(8)
    P = 33
    ys = (kp["yc"][..., None] + rng.uniform(-12, 12, (B, K, P))).astype(np.float32)
    xs = (kp["xc"][..., None] + rng.uniform(-12, 12, (B, K, P))).astype(np.float32)
    lvl, H, W, row0 = (t[..., None] for t in _t(kp, "lvl", "H", "W", "row0"))
    got = p_sift._bilinear_flat(gx, lvl, torch.from_numpy(ys), torch.from_numpy(xs), H, W, row0).numpy()
    for b in range(B):
        one = jax.vmap(lambda l, y, x, h, w, r0: r_sift._bilinear_flat(jnp.asarray(gx[b].numpy()), l, y, x, h, w, r0))
        want = one(*_j(kp, b, "lvl"), jnp.asarray(ys[b]), jnp.asarray(xs[b]), *_j(kp, b, "H", "W", "row0"))
        np.testing.assert_allclose(got[b], np.asarray(want), atol=1e-5)
    assert np.abs(got).max() > 0.01


def test_orientation_hist_matches_reference(stacks):
    _, gx, gy, kp = stacks
    cfg = SIFTConfig()
    got = p_sift._orientation_hist_one(
        gx, gy, *_t(kp, "lvl", "yc", "xc", "sigma_rel", "H", "W"), config_from_reference(cfg), row0=_t(kp, "row0")[0]
    ).numpy()
    assert got.shape == (B, K, cfg.ori_bins)
    for b in range(B):
        gxb, gyb = jnp.asarray(gx[b].numpy()), jnp.asarray(gy[b].numpy())
        one = jax.vmap(
            lambda l, y, x, s, h, w, r0: r_sift._orientation_hist_one(gxb, gyb, l, y, x, s, h, w, cfg, row0=r0)
        )
        want = np.asarray(one(*_j(kp, b, "lvl", "yc", "xc", "sigma_rel", "H", "W", "row0")))
        np.testing.assert_allclose(got[b], want, atol=1e-5)
        assert want.max() > 0.01


def test_descriptor_matches_reference(stacks):
    _, gx, gy, kp = stacks
    got = p_sift._descriptor_one(
        gx, gy, *_t(kp, "lvl", "yc", "xc", "sigma_rel", "theta", "H", "W"), row0=_t(kp, "row0")[0]
    ).numpy()
    assert got.shape == (B, K, 128)
    for b in range(B):
        gxb, gyb = jnp.asarray(gx[b].numpy()), jnp.asarray(gy[b].numpy())
        one = jax.vmap(lambda l, y, x, s, t, h, w, r0: r_sift._descriptor_one(gxb, gyb, l, y, x, s, t, h, w, row0=r0))
        want = np.asarray(one(*_j(kp, b, "lvl", "yc", "xc", "sigma_rel", "theta", "H", "W", "row0")))
        np.testing.assert_allclose(got[b], want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-4)
    assert got.min() >= 0.0 and 0.05 < got.max() < 0.5  # clipped at 0.2, then renormalised


def test_static_geometry_equals_reference():
    np.testing.assert_array_equal(p_sift._W_SPATIAL, r_sift._W_SPATIAL)
    np.testing.assert_array_equal(p_sift._W_GAUSS_DESC, r_sift._W_GAUSS_DESC)
    assert (p_sift._DESC_GRID, p_sift._DESC_CELLS, p_sift._DESC_BINS, p_sift._ORI_R) == (
        r_sift._DESC_GRID, r_sift._DESC_CELLS, r_sift._DESC_BINS, r_sift._ORI_R)


@pytest.mark.parametrize("n_orientations", [1, 2])
def test_exact_detect_and_describe_matches_reference(frames, n_orientations):
    cfg = SIFTConfig(max_keypoints=384, n_octaves=3, n_orientations=n_orientations, fast_descriptor=False)
    ref = jax.jit(jax.vmap(lambda im: r_sift.detect_and_describe(im, cfg)))(jnp.asarray(frames))
    got = p_sift.detect_and_describe(torch.from_numpy(frames), config_from_reference(cfg))
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


def test_fast_and_exact_find_same_keypoints(frames):
    """The port's mirror of tests/test_fast_frontend.py: detection is shared, so with one
    orientation per keypoint the two paths return the same keypoints; only orientation and
    descriptor differ."""
    exact = config_from_reference(SIFTConfig(max_keypoints=384, n_octaves=3, n_orientations=1, fast_descriptor=False))
    fast = dataclasses.replace(exact, fast_descriptor=True)
    img = torch.from_numpy(frames)
    fa, fe = p_sift.detect_and_describe(img, fast), p_sift.detect_and_describe(img, exact)
    np.testing.assert_array_equal(fa.mask.numpy(), fe.mask.numpy())
    np.testing.assert_allclose(fa.xy.numpy(), fe.xy.numpy(), atol=1e-4)
    assert int(fa.mask.sum()) > 200
    m = fa.mask.numpy()
    assert np.abs(fa.desc.numpy()[m] - fe.desc.numpy()[m]).max() > 1e-3  # two descriptors, not one


def test_exact_path_uses_plain_k1_and_never_k2(frames, monkeypatch):
    calls = {"k1_plain": 0, "k2": 0}
    k1_plain = kernels.extrema_scores_plain

    def count_k1(*a, **kw):
        calls["k1_plain"] += 1
        return k1_plain(*a, **kw)

    def count_k2(*a, **kw):
        calls["k2"] += 1
        raise AssertionError("the exact path computed bin maps")

    monkeypatch.setattr(kernels, "extrema_scores_plain", count_k1)
    for name in ("bin_maps_plain", "bin_maps_octaves", "bin_maps", "soft_bin_pool_plain"):
        monkeypatch.setattr(kernels, name, count_k2)
    cfg = config_from_reference(SIFTConfig(max_keypoints=256, n_octaves=3, fast_descriptor=False))
    kernels.reset_launches()
    f = p_sift.detect_and_describe(torch.from_numpy(frames), cfg)
    assert calls == {"k1_plain": 3, "k2": 0}  # one plain K1 per octave on a CPU tensor
    assert kernels.LAUNCHES == {"extrema_scores": 0, "bin_maps": 0, "pose_refine": 0, "gauss_blur": 0}  # nothing was launched on the CPU
    assert int(f.mask.sum()) > 100 and torch.isfinite(f.desc).all()
