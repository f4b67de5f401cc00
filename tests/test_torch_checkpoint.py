"""The port's checkpoint/resume against vo_tpu's file format, and resume bit-exactness port to port.

Each package's ``load`` must open the other's file with every shared field
equal. Only the sample stream does not cross: a port file carries the
``torch.Generator`` state under its own names plus a placeholder ``key``; a
reference file seeds a fresh generator from its ``key``. Resumed runs (plain:
8 frames, checkpoint at 5; refined: the 34-frame out-and-back of
tests/test_runtime.py on the committed KITTI-00 geometry, checkpoint at 21,
where two window solves and a verification round are in flight) must equal
the uninterrupted non-deferred run bit for bit. Everything runs on the CPU
(``device="cpu"``).
"""
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.config import LandmarkConfig as RLandmarkConfig
from vo_tpu.frontend.track import StereoFeatures as RStereoFeatures
from vo_tpu.odometry import checkpoint as r_ckpt
from vo_tpu.odometry.landmarks import LandmarkMap as RLandmarkMap
from vo_tpu.odometry.pipeline import VOState as RVOState
from vo_tpu_torch import config as p_config
from vo_tpu_torch import convert
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import checkpoint as p_ckpt
from vo_tpu_torch.odometry import landmarks as p_lm
from vo_tpu_torch.odometry import pipeline as p_pipe
from vo_tpu_torch.odometry import runner as p_runner

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
C = 32  # feature capacity of the hand-made states
SHARED = ["prev_l_xy", "prev_r_xy", "prev_l_desc", "prev_r_desc", "prev_mask", "prev_ids", "next_id", "pose_c2w",
          "prev_rel", "state_frame_idx"]


def small_cfg():
    return p_config.PipelineConfig(
        sift=p_config.SIFTConfig(max_keypoints=256, n_octaves=3),
        ransac=p_config.RansacConfig(n_hypotheses=128),
        landmarks=p_config.LandmarkConfig(capacity=20000),
        max_tracks=256,
    )


def _state_arrays(rng):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = rng.normal(size=3)
    return dict(
        l_xy=rng.uniform(0, 200, (C, 2)).astype(np.float32),
        r_xy=rng.uniform(0, 200, (C, 2)).astype(np.float32),
        l_desc=rng.random((C, 128)).astype(np.float32),
        r_desc=rng.random((C, 128)).astype(np.float32),
        mask=rng.random(C) < 0.7,
        ids=rng.integers(-1, 900, C).astype(np.int32),
    ), pose


def _flat(state, prefix="prev_"):
    """A VOState of either package as {checkpoint field name: numpy}."""
    out = {prefix + f: np.asarray(getattr(state.prev, f)) for f in RStereoFeatures._fields}
    out.update(next_id=np.asarray(state.next_id), pose_c2w=np.asarray(state.pose_c2w),
               prev_rel=np.asarray(state.prev_rel), state_frame_idx=np.asarray(state.frame_idx))
    return out


def test_checkpoint_roundtrip_fields(tmp_path):
    """The port's mirror of tests/test_runtime.py::test_checkpoint_roundtrip_fields."""
    cfg = small_cfg()
    st = p_pipe.init_state(cfg, seed=9, device="cpu")
    torch.rand(5, generator=st.gen)  # a stream that has moved on from its seed
    lmap = p_lm.init_map(cfg.landmarks, "cpu")
    p = str(tmp_path / "c.npz")
    p_ckpt.save(p, st, lmap, np.zeros((2, 4, 4)), np.zeros((2, 4, 4)), 3)
    ck = p_ckpt.load(p, device="cpu")
    assert ck.frame_idx == 3
    assert int(ck.lmap.count) == 0 and ck.lmap.xyz.shape == (20000, 3)
    assert ck.poses.shape == (2, 4, 4)
    assert ck.key.dtype == np.uint32 and ck.key.tolist() == [0, 9]
    assert torch.equal(ck.state.gen.get_state(), st.gen.get_state())
    assert torch.equal(torch.rand(4, generator=ck.state.gen), torch.rand(4, generator=st.gen))
    assert ck.n_inliers is None and ck.refiner is None
    assert not [f for f in os.listdir(tmp_path) if f != "c.npz"]  # no temp file left behind


def test_reference_file_loads_in_the_port(tmp_path, rng):
    arrs, pose = _state_arrays(rng)
    r_state = RVOState(
        prev=RStereoFeatures(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        pose_c2w=jnp.asarray(pose), prev_rel=jnp.asarray(pose), frame_idx=jnp.int32(7), next_id=jnp.int32(901),
        key=jax.random.PRNGKey(5),
    )
    xyz = np.zeros((50, 3), np.float32)
    xyz[:7] = rng.normal(size=(7, 3))
    r_map = RLandmarkMap(xyz=jnp.asarray(xyz), count=jnp.int32(7), dropped=jnp.int32(2))
    path = str(tmp_path / "ref.npz")
    stats = ([5, 6], [9, 9], [True, False])
    r_ckpt.save(path, r_state, r_map, rng.normal(size=(2, 4, 4)), rng.normal(size=(2, 4, 4)), r_state.key, 8,
                stats=stats, refiner_state=dict(ref_D=np.eye(4)))
    ck = p_ckpt.load(path, device="cpu")
    want, got = _flat(r_state), _flat(convert.to_numpy(ck.state))
    for k in SHARED:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ck.state.prev.ids.dtype == torch.int32 and ck.state.frame_idx.dtype == torch.int64
    assert ck.frame_idx == 8 and int(ck.lmap.count) == 7 and int(ck.lmap.dropped) == 2
    np.testing.assert_array_equal(ck.lmap.xyz.numpy(), xyz)
    z = np.load(path)
    for k in ("poses", "rel_poses"):
        np.testing.assert_array_equal(getattr(ck, k), z[k])
    np.testing.assert_array_equal(ck.n_inliers, stats[0])
    np.testing.assert_array_equal(ck.pose_ok, stats[2])
    np.testing.assert_array_equal(ck.refiner["ref_D"], np.eye(4))
    # No generator state in a reference file: a fresh stream seeded from its key.
    np.testing.assert_array_equal(ck.key, np.asarray(r_state.key))
    fresh = torch.Generator().manual_seed(5)
    assert torch.equal(torch.rand(4, generator=ck.state.gen), torch.rand(4, generator=fresh))


def test_port_file_loads_in_the_reference(tmp_path, rng):
    arrs, pose = _state_arrays(rng)
    st = p_pipe.init_state(small_cfg(), seed=3, device="cpu")
    st = st._replace(
        prev=type(st.prev)(**{k: torch.from_numpy(v) for k, v in arrs.items()}), pose_c2w=torch.from_numpy(pose),
        frame_idx=torch.tensor(4), next_id=torch.tensor(77, dtype=torch.int32),
    )
    lmap = p_lm.init_map(p_config.LandmarkConfig(capacity=64), "cpu")
    lmap.xyz[:3] = torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32))
    lmap.count.fill_(3)
    path = str(tmp_path / "port.npz")
    p_ckpt.save(path, st, lmap, np.zeros((3, 4, 4), np.float32), np.zeros((3, 4, 4), np.float32), 4,
                stats=([1, 2, 3], [4, 5, 6], [True, True, False]), refiner_state=dict(ref_D=np.eye(4)))
    ck = r_ckpt.load(path)
    want, got = _flat(convert.to_numpy(st)), _flat(ck.state)
    for k in SHARED:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The placeholder key has the reference's shape and dtype.
    ref_key = np.asarray(jax.random.PRNGKey(0))
    assert np.asarray(ck.key).shape == ref_key.shape and np.asarray(ck.key).dtype == ref_key.dtype
    assert ck.frame_idx == 4 and int(ck.lmap.count) == 3 and ck.lmap.xyz.shape == (64, 3)
    np.testing.assert_array_equal(np.asarray(ck.lmap.xyz), lmap.xyz.numpy())
    np.testing.assert_array_equal(ck.n_tracks, [4, 5, 6])
    np.testing.assert_array_equal(ck.refiner["ref_D"], np.eye(4))
    z = np.load(path)
    assert "torch_gen_state" in z.files and str(z["torch_gen_device"]) == "cpu"
    # Every field the reference writes is in a port file.
    r_path = str(tmp_path / "ref.npz")
    r_ckpt.save(r_path, ck.state, ck.lmap, ck.poses, ck.rel_poses, ck.key, 4)
    assert set(np.load(r_path).files) <= set(z.files)


def test_generator_of_another_device_raises(tmp_path):
    st = p_pipe.init_state(small_cfg(), device="cpu")
    path = str(tmp_path / "c.npz")
    p_ckpt.save(path, st, None, np.zeros((0, 4, 4)), np.zeros((0, 4, 4)), 1)
    z = dict(np.load(path))
    z["torch_gen_device"] = np.asarray("cuda")  # as a run on the card would have written it
    np.savez(path, **z)
    with pytest.raises(ValueError, match="cuda generator.*cannot continue it on cpu"):
        p_ckpt.load(path, device="cpu")


def test_load_follows_the_default_device_rule(tmp_path, monkeypatch):
    st = p_pipe.init_state(small_cfg(), device="cpu")
    path = str(tmp_path / "c.npz")
    p_ckpt.save(path, st, None, np.zeros((0, 4, 4)), np.zeros((0, 4, 4)), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        p_ckpt.load(path)
    assert p_ckpt.load(path, device="cpu").state.pose_c2w.device.type == "cpu"


def test_plain_resume_is_bit_exact(tmp_path):
    """Full run == run checkpointed at frame 5 and resumed to 8 (poses, stats and the map)."""
    cfg = small_cfg()
    seq = p_syn.kitti_synthetic_sequence(n_frames=8, n_landmarks=800, seed=3, image_size=(128, 256))
    ck = str(tmp_path / "ck.npz")
    kw = dict(warmup=False, device="cpu")
    full = p_runner.run_sequence(seq, cfg, n_frames=8, progress=lambda i, s: None, **kw)
    part = p_runner.run_sequence(seq, cfg, n_frames=5, checkpoint_path=ck, checkpoint_every=5, **kw)
    assert os.path.exists(ck) and part.poses.shape == (4, 4, 4)
    resumed = p_runner.run_sequence(seq, cfg, n_frames=8, checkpoint_path=ck, resume=True, progress=lambda i, s: None, **kw)
    assert np.array_equal(resumed.poses, full.poses), np.abs(resumed.poses - full.poses).max()
    assert np.array_equal(resumed.landmarks, full.landmarks) and full.landmarks.shape[0] > 50
    for k in ("rel_poses", "n_inliers", "n_tracks", "pose_ok"):
        assert np.array_equal(getattr(resumed, k), getattr(full, k)), k
    # frames_per_sec counts the frames this run stepped, not the ones it loaded.
    assert resumed.per_frame_ms * 3 == pytest.approx(1000.0 * 3 / resumed.frames_per_sec)
    # The deferred path resumes too (frames 5-6 as a group of two, 7 alone).
    deferred = p_runner.run_sequence(seq, cfg, n_frames=8, checkpoint_path=ck, resume=True, **kw)
    assert np.abs(deferred.poses - full.poses).max() < 1e-3
    np.testing.assert_array_equal(deferred.n_inliers[:4], full.n_inliers[:4])


def test_refined_resume_is_bit_exact(tmp_path):
    """A --ba --loop-closure run interrupted at frame 21 and resumed reproduces the uninterrupted
    trajectory bit for bit: the checkpoint round-trips the refiner's ledgers, the LoopCloser's
    archive (descriptors read back from the device tensors), loop edges, the in-flight window
    solves and verification round, and the associator's rings with their shared ids arrays."""
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    half = gt[:18]
    poses = np.concatenate([half, half[::-1]])[:34]
    seq = p_syn.SyntheticSequence(
        p_kitti.load_stereo_calib(str(DATA / "00")), poses, n_landmarks=900, seed=6, image_size=(128, 256)
    )
    cfg = small_cfg()
    cfg = dataclasses.replace(
        cfg,
        ba=dataclasses.replace(cfg.ba, keyframe_every=4, window=4),
        loop=dataclasses.replace(cfg.loop, min_gap=2, verify_cooldown=1),
    )
    kw = dict(use_ba=True, use_loop_closure=True, warmup=False, device="cpu")
    # Uninterrupted run on the non-deferred path, like the resumed one.
    full = p_runner.run_sequence(seq, cfg, n_frames=34, progress=lambda i, s: None, **kw)
    ck = str(tmp_path / "ck_refined.npz")
    p_runner.run_sequence(seq, cfg, n_frames=21, checkpoint_path=ck, checkpoint_every=21, **kw)
    z = np.load(ck)
    # The checkpoint lands with window solves and a verification round in flight.
    assert "refx_ba_pend0_T" in z.files and "refx_lc_pend_ver" in z.files
    assert {"refx_runner_ring_desc", "refx_lc_torch_gen_state", "refx_lc_key", "refx_ba_win_slot"} <= set(z.files)
    assert (z["refx_ba_win_slot"] >= 0).all()
    resumed = p_runner.run_sequence(seq, cfg, n_frames=34, checkpoint_path=ck, resume=True, **kw)
    assert resumed.poses.shape == full.poses.shape
    assert np.array_equal(resumed.poses, full.poses), np.abs(resumed.poses - full.poses).max()
    assert np.array_equal(resumed.n_inliers, full.n_inliers)
    assert np.array_equal(resumed.pose_ok, full.pose_ok)
    for k in ("n_keyframes", "loops_closed", "ba_solves", "lc_verified"):
        assert resumed.refine_stats[k] == full.refine_stats[k], k
    assert full.refine_stats["ba_solves"] >= 1 and full.refine_stats["lc_verified"] >= 1
