"""One order of collectives on every rank of a mesh with window BA (odometry.refiner), and the launcher's
hang report (dist.mesh.launch).

Under a mesh whose "model" axis is larger than one, the frame loop's RANSAC
all-gathers and the landmark-sharded window solve's all-reduces go over the
same ranks. NCCL kernels wait for their peers, so every rank must issue them
in one order, whatever its refiner worker's host work costs: the frame
loop's thread launches every solve, at a fixed keyframe. A gloo world of two
ranks (real processes, the CPU) records, per rank, every collective as it is
issued (the thread that issued it, the group's ranks, the kind), with rank
1's worker slowed down in its window assembly; the lists must be equal and
come from the main thread alone, through a run, and through a run that
checkpoints mid-way and then closes (both drains of the worker). The same
world holds that two BA runs leave no process group behind. Sizes: 160x320
images, 2 octaves, 256 keypoints, 128 hypotheses, a window of 6 keyframes of
256 landmarks, a keyframe every 2 frames, 16 frames.

A launched rank that outlives ``launch``'s time limit is killed, and the
``TimeoutError`` shows its threads' Python stacks (faulthandler).

The ``gpu`` case runs the mesh (1, 4) with window BA at the default config
over the 199-frame out-and-back feed with a card per rank, graphed and
eager; it skips below four cards.
"""
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vo_tpu_torch import config as p_config
from vo_tpu_torch.dist import ba_sharded as p_ba_sharded
from vo_tpu_torch.dist import mesh as p_mesh
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.odometry import ba_runner as p_bar
from vo_tpu_torch.odometry import runner as p_runner

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).parents[1]
DATA = ROOT / "tests" / "data" / "kitti"
N_FRAMES = 16
CHECKPOINT_EVERY = 8  # a checkpoint after frame 7 (mid-run) and after frame 15 (the last), then close
ASSEMBLY_DELAY_S = 0.3  # rank 1's worker takes this much longer over each window assembly
FIELDS = ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")
WORLD_TIMEOUT_S = 300.0
AT_LENGTH_TIMEOUT_S = 300.0  # the gpu case: a hung world fails in minutes, not at NCCL's 10-minute watchdog


def _cfg():
    c = p_config
    return c.PipelineConfig(
        sift=c.SIFTConfig(max_keypoints=256, n_octaves=2),
        ransac=c.RansacConfig(n_hypotheses=128),
        landmarks=c.LandmarkConfig(capacity=20000),
        ba=c.BAConfig(keyframe_every=2, window=6, max_points=256),
        max_tracks=256,
    )


def _feed():
    return p_syn.kitti_synthetic_sequence(n_frames=N_FRAMES, n_landmarks=1200, seed=4, image_size=(160, 320))


def _record_collectives(log: list) -> None:
    """Append (issuing thread, group's ranks, kind) to ``log`` at every collective this process issues."""
    lock = threading.Lock()

    def recorded(kind, fn):
        def call(t, group):
            role = "main" if threading.current_thread() is threading.main_thread() else "worker"
            with lock:
                log.append((role, tuple(dist.get_process_group_ranks(group)), kind))
            return fn(t, group)

        return call

    p_mesh.all_gather = recorded("all_gather", p_mesh.all_gather)
    p_mesh.all_reduce_sum_ = recorded("all_reduce", p_mesh.all_reduce_sum_)
    p_ba_sharded.all_gather = p_mesh.all_gather  # imported there by name


def _order_rank(mesh, device, checkpoint_path):
    """Two BA runs on this rank, the second with checkpoints; rank 1's worker is the slow one, and the
    interpreter switches threads far more often than by default."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        return _two_ba_runs(checkpoint_path, mesh, device)
    finally:
        sys.setswitchinterval(interval)


def _two_ba_runs(checkpoint_path, mesh, device):
    log: list = []
    _record_collectives(log)
    if dist.get_rank() == 1:
        assemble = p_bar.WindowedBA._assemble

        def slow(self):
            time.sleep(ASSEMBLY_DELAY_S)
            return assemble(self)

        p_bar.WindowedBA._assemble = slow
    groups_before = len(dist.distributed_c10d._world.pg_map)
    seq, cfg = _feed(), _cfg()
    kw = dict(warmup=False, mesh=mesh, device=device, use_ba=True)
    out = {}
    res = p_runner.run_sequence(seq, cfg, **kw)
    out["run"] = dict(order=list(log), poses=res.poses, ba_solves=res.refine_stats["ba_solves"])
    log.clear()
    res = p_runner.run_sequence(seq, cfg, checkpoint_path=checkpoint_path, checkpoint_every=CHECKPOINT_EVERY, **kw)
    out["checkpoint"] = dict(order=list(log), poses=res.poses, ba_solves=res.refine_stats["ba_solves"])
    out["process_groups"] = (groups_before, len(dist.distributed_c10d._world.pg_map))
    return out


@pytest.fixture(scope="module")
def order_world(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("order") / "checkpoint.npz")
    return p_mesh.launch(_order_rank, (1, 2), "cpu", args=(path,), timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("run", ["run", "checkpoint"])
def test_every_rank_issues_the_collectives_in_one_order(order_world, run):
    """The same list of collectives on both ranks, all from the frame loop's thread, though rank 1's worker
    assembles each window later than rank 0's; ``checkpoint`` drains the worker mid-run and at close."""
    lists = [out[run]["order"] for out in order_world]
    kinds = {k for _, _, k in lists[0]}
    assert kinds == {"all_gather", "all_reduce"}, kinds  # the step's gathers and the solves' reductions
    assert lists[0] == lists[1], "the ranks issued their collectives in different orders"
    by_thread = {role for role, _, _ in lists[0] + lists[1]}
    assert by_thread == {"main"}, f"collectives issued from {by_thread}"
    for out in order_world:
        assert out[run]["ba_solves"] >= 1
        np.testing.assert_array_equal(out[run]["poses"], order_world[0][run]["poses"])
    # The checkpoints change nothing of what is computed.
    np.testing.assert_array_equal(order_world[0]["checkpoint"]["poses"], order_world[0]["run"]["poses"])


def test_ba_runs_leave_no_process_group(order_world):
    for out in order_world:
        before, after = out["process_groups"]
        assert after == before, f"two BA runs left {after - before} process groups"


def _sleeping_rank(mesh, device):
    time.sleep(120.0)


def test_a_hung_rank_shows_its_threads_stacks():
    with pytest.raises(TimeoutError) as err:
        p_mesh.launch(_sleeping_rank, (1, 2), "cpu", timeout=5.0)
    text = str(err.value)
    assert "still running after 5 s" in text
    for r in (0, 1):
        assert f"stderr of rank {r}" in text
    assert text.count("most recent call first") >= 2 and text.count("in _sleeping_rank") >= 2, text


# ---- on the card: four cards, the 199-frame feed at the default config ---------------------------


def _cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, have {torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in range(n)]


def _at_length_rank(mesh, device, frames_path, gt_poses):
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ArrayFeed

    seq = ArrayFeed(frames_path, p_kitti.load_stereo_calib(str(DATA / "00")), gt_poses)
    feed = p_runner.StagedSequence(seq, len(seq), device)
    cfg = p_config.PipelineConfig()
    runs = {}
    for name, graph in (("graphed", None), ("eager", False)):
        res = p_runner.run_sequence(feed, cfg, mesh=mesh, device=device, use_ba=True, graph=graph)
        runs[name] = {k: getattr(res, k) for k in FIELDS}
        runs[name]["refine"] = [res.refine_stats[k] for k in ("n_keyframes", "ba_solves")]
    return runs


@pytest.mark.gpu
def test_ba_mesh_at_length_with_a_card_per_rank(tmp_path):
    devices = _cards(4)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import MESH_POSE_TOL_M, OUT_FRAMES, OutAndBackFeed, save_frames

    feed = OutAndBackFeed(OUT_FRAMES, devices[0])
    path = str(tmp_path / "frames.npy")
    save_frames(feed, len(feed), path)
    one = p_runner.run_sequence(feed, p_config.PipelineConfig(), use_ba=True, device=devices[0])
    per_rank = p_mesh.launch(_at_length_rank, (1, 4), devices, args=(path, feed.gt_poses), timeout=AT_LENGTH_TIMEOUT_S, threads=2)
    first = per_rank[0]["graphed"]
    assert first["refine"][1] >= 1, first["refine"]
    for r, runs in enumerate(per_rank):
        for name, got in runs.items():
            for k in FIELDS + ("refine",):
                np.testing.assert_array_equal(got[k], first[k], err_msg=f"rank {r}, {name}: {k}")
    d = float(np.linalg.norm(first["poses"][:, :3, 3] - one.poses[:, :3, 3], axis=1).max())
    assert d < MESH_POSE_TOL_M, d
