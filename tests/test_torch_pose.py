"""vo_tpu_torch.pose against vo_tpu.pose on the same float32 inputs (tolerance 1e-4).

RANSAC parity injects the reference's own sampled triples: torch cannot
reproduce ``jax.random`` draws.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.config import RansacConfig
from vo_tpu.io import kitti as r_kitti
from vo_tpu.io import synthetic as r_syn
from vo_tpu.pose import p3p as r_p3p
from vo_tpu.pose import ransac as r_ransac
from vo_tpu_torch.convert import calib_from_numpy, config_from_reference
from vo_tpu_torch.pose import p3p as p_p3p
from vo_tpu_torch.pose import ransac as p_ransac

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
TOL = 1e-4


@pytest.fixture(scope="module")
def calib():
    return r_kitti.load_stereo_calib(str(DATA / "00"))


def _tracks(calib, seed, noise_px=0.3, outlier_frac=0.2):
    gt = r_kitti.read_poses(str(DATA / "poses" / "00.txt"))[:40]
    rng = np.random.default_rng(seed)
    lms = r_syn.scatter_landmarks(rng, gt, 800)
    return r_syn.make_tracks(rng, calib, gt[10], gt[11], lms, noise_px=noise_px, outlier_frac=outlier_frac, max_points=200)


def test_solve_quartic(rng):
    """Well-separated real roots (a multiple root is ill-conditioned in float32 on both sides)."""
    roots = np.cumsum(rng.uniform(0.4, 1.5, (64, 4)), axis=1) - 3.0
    coeffs = np.stack([np.poly(r) for r in roots]) * rng.uniform(0.5, 2.0, (64, 1))
    coeffs[-16:] = np.stack([np.polymul([1.0, -r[0] - r[1], r[0] * r[1]], [1.0, 0.5, 2.0]) for r in roots[-16:]])  # a complex pair
    c = [coeffs[:, i].astype(np.float32) for i in range(5)]
    r_x, r_ok = (np.asarray(a) for a in r_p3p.solve_quartic(*(jnp.asarray(x) for x in c)))
    p_x, p_ok = (a.numpy() for a in p_p3p.solve_quartic(*(torch.from_numpy(x) for x in c)))
    np.testing.assert_array_equal(p_ok, r_ok)
    assert r_ok[:48].all() and r_ok[48:].sum() == 32
    np.testing.assert_allclose(p_x[r_ok], r_x[r_ok], atol=TOL, rtol=TOL)


def test_p3p_grunert(calib):
    """Grunert in float32 is ill-conditioned near a multiple root of its quartic: there the
    reference's own float32 pose is centimeters off its float64 pose. So the validity masks
    must agree on 99% of the solutions (a root on a validity gate may fall either side), and
    the poses are held at 1e-4 where the reference's float32 result is within 5e-5 of its
    float64 result."""
    tr = _tracks(calib, 5, noise_px=0.0, outlier_frac=0.0)
    bear = np.asarray(r_ransac._bearings(jnp.asarray(tr.px_cur_l, jnp.float32), calib))
    pts = tr.pts_prev_cam.astype(np.float32)
    pick = np.random.default_rng(1)
    idx = np.stack([pick.choice(len(pts), 3, replace=False) for _ in range(128)])
    tb, tp = bear[idx], pts[idx]
    r = r_p3p.p3p_grunert(jnp.asarray(tb), jnp.asarray(tp))
    r64 = r_p3p.p3p_grunert(jnp.asarray(tb, jnp.float64), jnp.asarray(tp, jnp.float64))
    p = p_p3p.p3p_grunert(torch.from_numpy(tb), torch.from_numpy(tp))
    rv, pv = np.asarray(r.valid), p.valid.numpy()
    assert rv.sum() > 200 and (rv == pv).mean() >= 0.99
    good = rv & pv & np.asarray(r64.valid)
    good &= np.abs(np.asarray(r.t_w2c) - np.asarray(r64.t_w2c)).max(-1) < 5e-5
    good &= np.abs(np.asarray(r.R_w2c) - np.asarray(r64.R_w2c)).max((-1, -2)) < 5e-5
    assert good.sum() >= 50
    np.testing.assert_allclose(p.R_w2c.numpy()[good], np.asarray(r.R_w2c)[good], atol=TOL)
    np.testing.assert_allclose(p.t_w2c.numpy()[good], np.asarray(r.t_w2c)[good], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_world_pose_with_injected_triples(calib, seed):
    # 0.05 px noise keeps every inlier well inside the 1 px gate, so the consensus
    # set, and hence the refined optimum, does not hinge on last-bit differences.
    tr = _tracks(calib, seed, noise_px=0.05)
    px = tr.px_cur_l.astype(np.float32)
    pts = tr.pts_prev_cam.astype(np.float32)
    mask = np.ones(len(px), bool)
    mask[-10:] = False
    cfg = RansacConfig(n_hypotheses=128)
    key = jax.random.PRNGKey(seed)
    triples = np.asarray(r_ransac._sample_triples(key, jnp.asarray(mask), cfg.n_hypotheses))
    r = r_ransac.estimate_world_pose(jnp.asarray(px), jnp.asarray(pts), jnp.asarray(mask), calib, cfg, key)
    p = p_ransac.estimate_world_pose(
        torch.from_numpy(px), torch.from_numpy(pts), torch.from_numpy(mask), calib_from_numpy(calib, "cpu"),
        config_from_reference(cfg),
        triples=torch.tensor(triples, dtype=torch.long),
    )
    assert bool(r.ok) and bool(p.ok)
    np.testing.assert_array_equal(p.inliers.numpy(), np.asarray(r.inliers))
    assert int(p.n_inliers) == int(r.n_inliers) > 100
    np.testing.assert_allclose(p.pose_c2w.numpy(), np.asarray(r.pose_c2w), atol=TOL)
    np.testing.assert_allclose(p.pose_c2w.numpy(), tr.rel_pose, atol=0.05)


def test_sample_triples_distinct_valid():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    gen = torch.Generator().manual_seed(0)
    t = p_ransac._sample_triples(gen, mask, 256)
    assert t.shape == (256, 3)
    assert bool(mask[t].all())
    s = torch.sort(t, dim=1).values
    assert bool((s[:, 1:] != s[:, :-1]).all())
