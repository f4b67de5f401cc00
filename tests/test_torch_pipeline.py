"""The port's VO step, landmark store and runner against the reference, and its import boundary.

One ``_step_core`` starts from the reference's own state (converted) with the
reference's RANSAC triples injected: track and landmark index sets must be
identical and the pose within 1e-4. End to end, the runners draw different
RANSAC samples, so they are compared by ATE, pose_ok and per-frame position.
Each side gets the configuration in its own package's classes (``_cfg`` the
reference's, ``_pcfg`` the port's copy of it), and the port runs on the CPU
because every call names it (``device="cpu"``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.config import LandmarkConfig, PipelineConfig, RansacConfig, SIFTConfig
from vo_tpu.eval import metrics
from vo_tpu.geom.triangulate import triangulate_rectified as r_triangulate
from vo_tpu.io import synthetic as r_syn
from vo_tpu.odometry import landmarks as r_lm
from vo_tpu.odometry import pipeline as r_pipe
from vo_tpu.odometry import runner as r_runner
from vo_tpu.pose import ransac as r_ransac
from vo_tpu.frontend import sift as r_sift
from vo_tpu.frontend import track as r_track
from vo_tpu.utils.padding import gather_rows as r_gather_rows
from vo_tpu_torch import convert
from vo_tpu_torch.frontend import sift as p_sift
from vo_tpu_torch.odometry import landmarks as p_lm
from vo_tpu_torch.odometry import pipeline as p_pipe
from vo_tpu_torch.odometry import runner as p_runner
from vo_tpu_torch.io import synthetic as p_syn

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
SIZE = (188, 620)
N_FRAMES = 6


def _cfg(**kw):
    return PipelineConfig(
        sift=SIFTConfig(max_keypoints=384, n_octaves=3), ransac=RansacConfig(n_hypotheses=128), max_tracks=256, **kw
    )


def _pcfg(**kw):
    return convert.config_from_reference(_cfg(**kw))


@pytest.fixture(scope="module")
def seqs():
    kw = dict(n_frames=N_FRAMES, n_landmarks=1500, seed=2, image_size=SIZE)
    return p_syn.kitti_synthetic_sequence(**kw), r_syn.kitti_synthetic_sequence(str(DATA), **kw)


@pytest.fixture(scope="module")
def port_run(seqs):
    return p_runner.run_sequence(seqs[0], _pcfg(), warmup=False, device="cpu")


def _features(feats, i):
    return type(feats)(*(f[i] for f in feats))


def test_step_core_matches_reference(seqs):
    """Frame 0 then frame 1 through _step_core, both packages fed the same features."""
    p_seq, r_seq = seqs
    cfg, pcfg = _cfg(), _pcfg()
    imgs = np.stack([im for i in range(2) for im in p_seq.frame(i)]).astype(np.float32)
    feats = convert.to_numpy(p_sift.detect_and_describe(torch.from_numpy(imgs), pcfg.sift))
    r_f = [r_sift.Features(*(jnp.asarray(x) for x in _features(feats, i))) for i in range(4)]
    p_f = [convert.features_from_numpy(_features(feats, i), "cpu") for i in range(4)]
    r_calib, p_calib = r_seq.calib, convert.calib_from_numpy(r_seq.calib, "cpu")
    r_step = jax.jit(lambda s, fl, fr, k: r_pipe._step_core(s, fl, fr, k, k, r_calib, cfg))

    r_s1, _ = r_step(r_pipe.init_state(cfg), r_f[0], r_f[1], jax.random.PRNGKey(0))
    p_s1, _ = p_pipe._step_core(p_pipe.init_state(pcfg, device="cpu"), p_f[0], p_f[1], p_calib, pcfg)
    for k in r_track.StereoFeatures._fields:
        np.testing.assert_array_equal(getattr(p_s1.prev, k).numpy(), np.asarray(getattr(r_s1.prev, k)), err_msg=k)
    assert int(p_s1.next_id) == int(r_s1.next_id) > 20

    # Frame 1 from the reference's state, with the reference's RANSAC triples.
    key = jax.random.PRNGKey(1)
    tr = r_track.track(r_s1.prev, r_f[2], r_f[3], cfg.matcher, cfg.max_tracks)
    X_prev = r_triangulate(
        r_gather_rows(r_s1.prev.l_xy, tr.old_row, tr.mask), r_gather_rows(r_s1.prev.r_xy, tr.old_row, tr.mask), r_calib
    )
    pose_mask = tr.mask & (X_prev[:, 2] > 0.1) & (X_prev[:, 2] < 400.0)
    triples = np.asarray(r_ransac._sample_triples(key, pose_mask, cfg.ransac.n_hypotheses))
    r_s2, r_out = r_step(r_s1, r_f[2], r_f[3], key)
    p_s2, p_out = p_pipe._step_core(
        convert.state_from_numpy(convert.to_numpy(r_s1), "cpu"), p_f[2], p_f[3], p_calib, pcfg,
        triples=torch.tensor(triples, dtype=torch.long),
    )
    for k in ("tracked_mask", "tracked_cur_px", "tracked_old_px", "new_lm_mask", "new_lm_l_px", "new_lm_r_px",
              "n_tracks", "n_inliers", "pose_ok"):
        np.testing.assert_array_equal(getattr(p_out, k).numpy(), np.asarray(getattr(r_out, k)), err_msg=k)
    assert bool(p_out.pose_ok) and int(p_out.n_tracks) > 20
    for k in ("pose_c2w", "rel_pose"):
        np.testing.assert_allclose(getattr(p_out, k).numpy(), np.asarray(getattr(r_out, k)), atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(p_s2.prev.ids.numpy(), np.asarray(r_s2.prev.ids))
    assert int(p_s2.next_id) == int(r_s2.next_id)
    assert int(p_s2.frame_idx) == int(r_s2.frame_idx) == 2


@pytest.mark.parametrize("capacity", [1_000_000, 300])
def test_landmarks_insert_matches_reference(rng, seqs, capacity):
    """Four inserts; the small map overflows (its tail is dropped and counted)."""
    r_calib = seqs[1].calib
    p_calib = convert.calib_from_numpy(r_calib, "cpu")
    cfg = LandmarkConfig(capacity=capacity)
    r_map = r_lm.init_map(cfg)
    pcfg = convert.config_from_reference(cfg)
    p_map = convert.lmap_from_numpy(r_map, "cpu")  # the reference's empty map, carried across
    fresh = p_lm.init_map(pcfg, "cpu")
    for k in p_lm.LandmarkMap._fields:
        assert getattr(p_map, k).dtype == getattr(fresh, k).dtype and getattr(p_map, k).shape == getattr(fresh, k).shape, k
    for _ in range(4):
        l_px = rng.uniform([0, 0], [620, 188], (256, 2)).astype(np.float32)
        r_px = (l_px - np.stack([rng.uniform(-2, 40, 256), np.zeros(256)], -1)).astype(np.float32)
        mask = rng.random(256) < 0.9
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(0, 5, 3)
        r_map = r_lm.insert(r_map, jnp.asarray(l_px), jnp.asarray(r_px), jnp.asarray(mask), jnp.asarray(pose), r_calib, cfg)
        out = p_lm.insert(p_map, *(torch.from_numpy(x) for x in (l_px, r_px, mask, pose)), p_calib, pcfg)
        assert out is p_map  # updated in place
    assert int(p_map.count) == int(r_map.count) > 0
    assert int(p_map.dropped) == int(r_map.dropped)
    assert (int(r_map.dropped) > 0) == (capacity == 300)
    n = int(r_map.count)
    np.testing.assert_allclose(p_map.xyz[:n].numpy(), np.asarray(r_map.xyz)[:n], atol=1e-4, rtol=1e-5)


def test_run_sequence_matches_reference(seqs, port_run):
    p_seq, r_seq = seqs
    r_res = r_runner.run_sequence(r_seq, _cfg(), warmup=False)
    p_res = port_run
    gt = np.asarray(r_seq.gt_poses)
    assert p_res.poses.shape == r_res.poses.shape == (N_FRAMES - 1, 4, 4)
    assert metrics.ate(p_res.poses, gt)["rmse"] <= 0.05
    assert metrics.ate(r_res.poses, gt)["rmse"] <= 0.05
    np.testing.assert_array_equal(p_res.pose_ok, r_res.pose_ok)
    assert np.abs(p_res.poses[:, :3, 3] - r_res.poses[:, :3, 3]).max() < 0.03
    assert p_res.landmarks.shape[0] > 100 and np.isfinite(p_res.landmarks).all()


@pytest.mark.parametrize("group", [1, 4])
def test_fused_group_matches_group_2(seqs, port_run, group):
    """The single-frame step, and a 4-frame group with a single-frame tail (6 = 4 + 1 + 1),
    give the trajectory of the default 2-frame group."""
    other = p_runner.run_sequence(seqs[0], _pcfg(fused_group=group), warmup=False, device="cpu")
    assert np.abs(other.poses[:, :3, 3] - port_run.poses[:, :3, 3]).max() < 1e-3
    np.testing.assert_array_equal(other.pose_ok, port_run.pose_ok)


@pytest.mark.parametrize("opt", [dict(mesh=object())])
def test_runner_rejects_unported_options(seqs, opt):
    """No option of the reference's runner is left unported (the mesh was the last); what is
    refused is a ``mesh`` that is no DeviceMesh."""
    with pytest.raises(TypeError, match="mesh must be a torch.distributed DeviceMesh"):
        p_runner.run_sequence(seqs[0], _pcfg(), device="cpu", **opt)


def test_runner_takes_every_reference_option():
    import inspect

    ref = inspect.signature(r_runner.run_sequence).parameters
    port = inspect.signature(p_runner.run_sequence).parameters
    assert list(port)[: len(ref)] == list(ref) and set(port) - set(ref) == {"device"}
    for k in ref:
        assert port[k].default == ref[k].default, k
    assert p_runner.KITTI_DT == r_runner.KITTI_DT


def test_port_never_imports_jax():
    """Importing EVERY vo_tpu_torch module (the command line's ``__main__`` and the figures
    included), chip_smoke and the profiling tool leaves jax and every module of vo_tpu out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import vo_tpu_torch, chip_smoke, profile_torch_step\n"
        "for m in pkgutil.walk_packages(vo_tpu_torch.__path__, 'vo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "ref = sorted(k for k in sys.modules if k == 'vo_tpu' or k.startswith('vo_tpu.'))\n"
        "assert not ref, ref\n"
        "for m in ('__main__', 'viz.figures', 'odometry.checkpoint', 'io.undistort', 'io.native_loader', 'utils.debug', 'utils.profiling',\n"
        "          'dist.mesh', 'dist.ransac_sharded', 'dist.ba_sharded', 'dist.pose_graph_sharded', 'dist.frontend_batch',\n"
        "          'dist.multihost_smoke', 'dist.scaling'):\n"
        "    assert 'vo_tpu_torch.' + m in sys.modules, m\n"
        "print('ok', len([k for k in sys.modules if k.startswith('vo_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
