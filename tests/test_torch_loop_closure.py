"""vo_tpu_torch.slam.loop_closure against vo_tpu.slam.loop_closure on identical keyframes.

The feed drives out along KITTI 00 and back (GT poses 0..9 then 8..0, the
loop fixture of tests/test_loop_closure.py) at 160x320; every frame is
detected once with the port, and both packages archive the same features.
Verification parity injects the reference's own RANSAC draws, rebuilt from
``jax.random.split(PRNGKey(17))`` as its fused program splits it. The port's
closers get the port's own configuration classes (``convert.config_from_reference``)
and run on the CPU because every call names it.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.config import LoopConfig, MatcherConfig, SIFTConfig
from vo_tpu.frontend.match import match as r_match
from vo_tpu.geom.camera import scale_calib as r_scale_calib
from vo_tpu.geom.triangulate import triangulate_rectified as r_triangulate
from vo_tpu.io import kitti as r_kitti
from vo_tpu.pose import ransac as r_ransac
from vo_tpu.slam import loop_closure as r_lc
from vo_tpu_torch import convert
from vo_tpu_torch.frontend.sift import detect_and_describe
from vo_tpu_torch.frontend.track import stereo_features_with_matches
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry.refiner import global_desc
from vo_tpu_torch.slam import loop_closure as p_lc

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
CAP = 384
CFG = LoopConfig(radius=8.0, min_gap=8, min_inliers=15, max_keyframes=32, graph_iters=10)


@pytest.fixture(scope="module")
def loop():
    """(reference calib at the feed's size, true poses, per-frame (stereo features, full left detections))."""
    gt = r_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    poses = np.concatenate([gt[:10], gt[8::-1]])
    seq = p_syn.SyntheticSequence(
        p_kitti.load_stereo_calib(str(DATA / "00")), poses, n_landmarks=2500, seed=12, image_size=(160, 320)
    )
    sift = convert.config_from_reference(SIFTConfig(max_keypoints=CAP, n_octaves=2))
    feats = []
    for i in range(len(poses)):
        f = detect_and_describe(torch.from_numpy(np.stack(seq.frame(i))), sift)
        fl, fr = (type(f)(*(x[k] for x in f)) for k in (0, 1))
        sf, _ = stereo_features_with_matches(fl, fr, convert.config_from_reference(MatcherConfig()), CAP)
        feats.append((convert.to_numpy(sf), (fl.xy.numpy(), fl.desc.numpy(), fl.mask.numpy())))
    return r_scale_calib(r_kitti.load_stereo_calib(str(DATA / "00")), (160, 320)), poses, feats


def _port_closer(calib, cfg):
    return p_lc.LoopCloser(convert.calib_from_numpy(calib, "cpu"), convert.config_from_reference(cfg), device="cpu")


def _archived(cls, i, pose, sf):
    return cls(
        frame_idx=i, pose_c2w=np.asarray(pose, np.float32), l_px=sf.l_xy.copy(), r_px=sf.r_xy.copy(),
        l_desc=sf.l_desc.copy(), mask=sf.mask.copy(),
    )


def _drifted(poses, i, dx):
    d = np.eye(4, dtype=np.float32)
    d[0, 3] = dx * i
    return (d @ poses[i]).astype(np.float32)


def test_global_desc_matches_reference(loop):
    _, _, feats = loop
    for sf, (_, desc, mask) in feats[:5]:
        want = r_lc._global_desc(sf.l_desc, sf.mask)
        np.testing.assert_array_equal(p_lc._global_desc(sf.l_desc, sf.mask), want)
        got = global_desc(torch.from_numpy(sf.l_desc), torch.from_numpy(sf.mask)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(
            global_desc(torch.from_numpy(desc), torch.from_numpy(mask)).numpy(), r_lc._global_desc(desc, mask), atol=1e-6
        )


def test_candidates_equal_reference(loop):
    calib, poses, feats = loop
    cfg = dataclasses.replace(CFG, min_gap=4)
    ref = r_lc.LoopCloser(calib, cfg)
    port = _port_closer(calib, cfg)
    seen = []
    for i, (sf, _) in enumerate(feats):
        pose = _drifted(poses, i, 0.3)
        for lc, cls in ((ref, r_lc.ArchivedKeyframe), (port, p_lc.ArchivedKeyframe)):
            kf = _archived(cls, i, pose, sf)
            kf.global_desc = r_lc._global_desc(sf.l_desc, sf.mask)
            lc.keyframes.append(kf)
        got = port._candidates(pose, port.keyframes[-1].global_desc)
        assert got == ref._candidates(pose, ref.keyframes[-1].global_desc)
        seen += got
    assert len(seen) > 10  # both channels proposed revisits


def test_verify_round_with_reference_triples(loop):
    """One fused round over 4 candidates: same ok / n_inliers / n_matches, pose within 1e-4."""
    calib, poses, feats = loop
    ref = r_lc.LoopCloser(calib, CFG)
    port = _port_closer(calib, CFG)
    cand_frames, cur = [0, 1, 2, 3], 18
    r_cands = [_archived(r_lc.ArchivedKeyframe, i, poses[i], feats[i][0]) for i in cand_frames]
    p_cands = [convert.archived_keyframe_from_numpy(kf, "cpu") for kf in r_cands]
    q = feats[cur][1]
    r_out, _ = ref._verify_prog(
        tuple(ref._dev_of(c) for c in r_cands), *(jnp.asarray(x) for x in q), jax.random.PRNGKey(17)
    )
    # The reference's draws: _verify_fused splits the key once, then once per candidate.
    _, sub = jax.random.split(jax.random.PRNGKey(17))
    keys = jax.random.split(sub, len(cand_frames))
    vm = dataclasses.replace(MatcherConfig(), max_ratio=CFG.verify_ratio, mutual=CFG.verify_mutual)
    triples = []
    for c, k in zip(r_cands, keys):
        m = r_match(jnp.asarray(q[1]), jnp.asarray(q[2]), jnp.asarray(c.l_desc), jnp.asarray(c.mask), vm, CFG.match_capacity)
        X = jnp.take(r_triangulate(jnp.asarray(c.l_px), jnp.asarray(c.r_px), calib), m.b_idx, axis=0)
        msk = m.mask & (X[:, 2] > 0.5) & (X[:, 2] < 150.0)
        triples.append(torch.tensor(np.asarray(r_ransac._sample_triples(k, msk, port.ransac.n_hypotheses)), dtype=torch.long))
    outs = port._dispatch_verify(p_cands, None, query_dev=tuple(torch.from_numpy(x) for x in q), triples=triples)
    ok, n_in, pose, n_m = outs.numpy()
    r_ok, r_n_in, r_pose, r_n_m = (np.asarray(x) for x in r_out)
    np.testing.assert_array_equal(ok, r_ok)
    np.testing.assert_array_equal(n_m, r_n_m)
    np.testing.assert_array_equal(n_in, r_n_in)
    assert ok.sum() >= 2 and n_in.max() >= CFG.min_inliers
    np.testing.assert_allclose(pose[ok], r_pose[r_ok], atol=1e-4)
    got = p_lc.LoopCloser._collect_verify(outs, 4, CFG.min_inliers)
    want = r_lc.LoopCloser._collect_verify(r_out, 4, CFG.min_inliers)
    assert [z is None for z in got] == [z is None for z in want]


def test_closure_fires_and_corrects_drift(loop):
    """tests/test_loop_closure.py's drift case through the port: drift grows 0.12 m per keyframe,
    a closure fires, and the corrected last keyframe is much closer to the truth."""
    calib, poses, feats = loop
    lc = _port_closer(calib, CFG)
    state = lc._gen.get_state()
    lc.warmup(CAP)
    assert torch.equal(lc._gen.get_state(), state)  # warm-up leaves the RANSAC stream where it was
    corrected = None
    for i, (sf, _) in enumerate(feats):
        res = lc.add_keyframe(_archived(p_lc.ArchivedKeyframe, i, _drifted(poses, i, 0.12), sf))
        corrected = res if res is not None else corrected
    assert corrected is not None, "no loop closure fired"
    old_k, new_k = corrected["loop"]
    assert new_k - old_k >= CFG.min_gap
    err_drift = np.linalg.norm(_drifted(poses, len(poses) - 1, 0.12)[:3, 3] - poses[-1][:3, 3])
    err_corr = np.linalg.norm(corrected["corrected"][new_k][:3, 3] - poses[new_k][:3, 3])
    assert err_corr < 0.5 * err_drift, (err_drift, err_corr)
    assert lc.n_verified >= 1 and lc.loop_edges


def test_decimation_equals_reference(loop):
    """Beyond max_keyframes both closers keep the same keyframes and re-anchor loop edges alike."""
    calib = loop[0]
    cfg = LoopConfig(max_keyframes=8, min_gap=100)
    ref = r_lc.LoopCloser(calib, cfg)
    port = _port_closer(calib, cfg)
    z2, zd, zm = np.zeros((4, 2), np.float32), np.zeros((4, 128), np.float32), np.zeros(4, bool)
    for i in range(30):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3], pose[2, 3] = float(i), 0.1 * i * i
        for lc, cls in ((ref, r_lc.ArchivedKeyframe), (port, p_lc.ArchivedKeyframe)):
            lc.add_keyframe(cls(frame_idx=i, pose_c2w=pose.copy(), l_px=z2, r_px=z2, l_desc=zd, mask=zm))
            if i == 7:  # endpoint 1 is decimated at the next keyframe
                Z = np.linalg.inv(lc.keyframes[1].pose_c2w.astype(np.float64)) @ lc.keyframes[7].pose_c2w
                lc.loop_edges.append((1, 7, Z.astype(np.float32)))
        assert port.decimations == ref.decimations
        assert [k.frame_idx for k in port.keyframes] == [k.frame_idx for k in ref.keyframes]
        assert port._path_m == ref._path_m
        assert len(port.loop_edges) == len(ref.loop_edges)
        for (a, b, Z), (ra, rb, rZ) in zip(port.loop_edges, ref.loop_edges):
            assert (a, b) == (ra, rb)
            np.testing.assert_array_equal(Z, rZ)
        if i == 8:
            assert port.decimations == 1 and len(port.loop_edges) == 1  # re-anchored, not dropped
    assert port.decimations >= 4
