"""Each frozen copy in perfbench/ equals the program's original at a small size."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from perfbench import arith, trace
from perfbench.gen import kitti, render
from perfbench.reference import frame as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CALIB = os.path.join(ROOT, "perfbench", "data", "kitti00", "calib.txt")
POSES = os.path.join(ROOT, "perfbench", "data", "kitti00", "poses.txt")


def test_data_are_the_committed_kitti00_files():
    with open(os.path.join(ROOT, "tests", "data", "kitti", "00", "calib.txt")) as f:
        assert open(CALIB).read() == f.read()
    with open(os.path.join(ROOT, "tests", "data", "kitti", "poses", "00.txt")) as f:
        assert open(POSES).read().splitlines() == f.read().splitlines()[:800]


def test_readers_equal_the_programs():
    from vo_tpu_torch.io import kitti as pk

    assert np.array_equal(kitti.read_poses(POSES), pk.read_poses(POSES))
    c, pc = kitti.read_calib(CALIB), pk.read_calib(CALIB)
    assert c.keys() == pc.keys() and all(np.array_equal(c[k], pc[k]) for k in c)


@pytest.mark.parametrize("size", [(94, 311), (376, 1241)])
def test_projections_equal_the_programs_scaled_calib(size):
    from vo_tpu_torch.geom.camera import scale_calib
    from vo_tpu_torch.io.kitti import load_stereo_calib

    P1, P2 = kitti.projections(CALIB, size)
    c = scale_calib(load_stereo_calib(os.path.dirname(CALIB)), size)
    assert np.array_equal(P1, c.P1.numpy()) and np.array_equal(P2, c.P2.numpy())


def test_renderer_equals_the_programs():
    from vo_tpu_torch.geom.camera import scale_calib
    from vo_tpu_torch.io.kitti import load_stereo_calib
    from vo_tpu_torch.io.synthetic import SyntheticSequence

    poses = kitti.read_poses(POSES)[:4]
    calib = load_stereo_calib(os.path.dirname(CALIB))
    theirs = SyntheticSequence(calib, poses, n_landmarks=200, seed=3, image_size=(94, 311), noise=0.02)
    P1, P2 = kitti.projections(CALIB, (94, 311))
    ours = render.Renderer(P1, P2, (94, 311), poses, 200, seed=3, noise=0.02)
    assert np.array_equal(ours.landmarks, theirs.landmarks)
    assert scale_calib(calib, (94, 311)).fu == theirs.calib.fu
    for i in range(4):
        for a, b in zip(ours.frame(i), theirs.frame(i)):
            assert np.array_equal(render.quantize(a), render.quantize(b))


def test_ate_equals_the_programs():
    from vo_tpu_torch.eval.metrics import ate

    rng = np.random.default_rng(0)
    gt = kitti.read_poses(POSES)[:30]
    est = gt[1:].copy()
    est[:, :3, 3] += rng.normal(0, 0.3, (29, 3))
    e = arith.ate_errors(est, gt)
    assert np.sqrt(np.mean(e**2)) == pytest.approx(ate(est, gt)["rmse"], rel=1e-12)


def test_kernel_bytes_are_the_published_counts():
    """chip_smoke.py phase 3's counts of one grouped detection call ([4, 5, H, W], 4 octaves):
    79.4 MB for K1, 89.2 MB for K2."""
    sift = dict(scales_per_octave=3, n_octaves=4)
    assert arith.octave_shapes((376, 1241), 4) == [(376, 1241), (188, 621), (94, 311), (47, 156)]
    B, L = 4, 5
    px = sum(h * w for h, w in arith.octave_shapes((376, 1241), 4))
    pooled = sum((h // 2) * (w // 2) for h, w in arith.octave_shapes((376, 1241), 4))
    assert arith.k1_bytes(sift, (376, 1241), B) == 4 * B * (2 * L - 2) * px == 79_351_040
    assert arith.k2_bytes(sift, (376, 1241), B) == 4 * B * 3 * (px + 8 * pooled) == 89_191_776
    assert arith.detection_calls(799, 2) == [4] * 399 + [2]
    assert arith.detection_calls(5, 1) == [2] * 5


def test_union_equals_the_profilers_union_ms():
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from profile_torch_step import union_ms

    class Ev:
        def __init__(self, s, e):
            self.time_range = type("R", (), dict(start=s, end=e))

    rng = np.random.default_rng(1)
    s = rng.integers(0, 10_000, 500)
    e = s + rng.integers(1, 400, 500)
    us, ue = trace.union(s, e)
    assert (ue - us).sum() / 1000.0 == pytest.approx(union_ms([Ev(a, b) for a, b in zip(s, e)]))
    assert np.all(us[1:] > ue[:-1])


def _config():
    from vo_tpu_torch.config import PipelineConfig

    c = json.loads(json.dumps(dataclasses.asdict(PipelineConfig())))
    c["sift"]["max_keypoints"] = 256
    c["max_tracks"] = 256
    c["ransac"]["n_hypotheses"] = 64
    return c


@pytest.mark.parametrize("group", [1, 2])
def test_reference_frame_equals_the_programs_step(group):
    """Frames 1..3 of a small log through the program's step (grouped as the runner groups them)
    and through the plain reference frame by frame: the same relative poses, counts and landmarks."""
    from vo_tpu_torch.geom.camera import calib_from_projections
    from vo_tpu_torch.odometry import landmarks, pipeline
    from perfbench.harness import program_config

    size = (94, 311)
    d = _config()
    cfg = program_config(d)
    P1, P2 = kitti.projections(CALIB, size)
    poses = kitti.read_poses(POSES)[:4]
    r = render.Renderer(P1, P2, size, poses, 300, seed=0, noise=0.02)
    imgs = [torch.from_numpy(np.stack([render.quantize(im) for im in r.frame(i)])) for i in range(4)]
    calib = calib_from_projections(P1, P2, image_size=size, device="cpu")
    state = pipeline.init_state(cfg, 5, "cpu")
    outs = []
    for k in range(0, 4, group):
        frames = [im for i in range(k, k + group) for im in imgs[i]]
        if group == 1:
            state, out = pipeline.vo_step(state, frames[0], frames[1], calib, cfg)
            outs.append(out)
        else:
            state, o = pipeline.vo_step_multi(state, frames, calib, cfg)
            outs += o
    rcfg = ref.pipeline_config(d)
    rcal = ref.calib(P1, P2, size, "cpu")
    feats = []
    for k in range(0, 4, group):
        f = ref.detect(torch.cat([imgs[i] for i in range(k, k + group)]), rcfg)
        feats += [(ref.image(f, 2 * j), ref.image(f, 2 * j + 1)) for j in range(group)]
    gen = torch.Generator().manual_seed(5)
    torch.rand((64, 256), generator=gen)  # frame 0's draw
    for t in (1, 2, 3):
        got = ref.frame(*feats[t - 1], *feats[t], rcal, rcfg, gen)
        o = outs[t]
        assert got.ok == bool(o.pose_ok) and got.n_tracks == int(o.n_tracks) and got.n_inliers == int(o.n_inliers)
        assert torch.equal(got.rel, o.rel_pose)
        lm = landmarks.insert(landmarks.init_map(cfg.landmarks, "cpu"), o.new_lm_l_px, o.new_lm_r_px, o.new_lm_mask,
                              torch.eye(4), calib, cfg.landmarks)
        assert torch.equal(lm.xyz[: int(lm.count)], got.new_landmarks)
