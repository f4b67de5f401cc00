"""Mesh harness: the sharded components at increasing rank counts, and the integrated run
(port of vo_tpu.dist.scaling).

  python -m vo_tpu_torch.dist.scaling --cpu

``run`` times the two production shardings at each rank count: the
frame-parallel front-end (data axis: B frames detect + describe per call) and
hypothesis-parallel RANSAC (model axis: a fixed hypothesis budget split
across ranks, all-gather winner reduction). ``run_integrated`` runs the
production runner under a mesh against the identical single-process run and
reports both times and whether the trajectories are equivalent.

What the times mean depends on the machine. Ranks on the CPU, or sharing one
card, TIMESHARE it: their times measure the overhead of the integration
(process start-up is excluded; collectives, staging and contention are in),
and say nothing about how the system behaves with a card per rank.
"""
from __future__ import annotations

import json
import time

import numpy as np


def _bench(fn, device, iters=5):
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def _components_rank(mesh, device, axis, frame_batch, image_size, n_hyp):
    """One rank of ``run``: times the component sharded over ``axis`` ("data": detection;
    "model": RANSAC) -> seconds per call."""
    import torch

    from ..config import RansacConfig, SIFTConfig
    from ..geom.triangulate import triangulate_rectified
    from ..io import synthetic
    from . import frontend_batch, ransac_sharded
    from .mesh import axis_size

    seq = synthetic.kitti_synthetic_sequence(n_frames=frame_batch, n_landmarks=1000, seed=0, image_size=image_size)
    if axis == "data":
        nd = axis_size(mesh, "data")
        frames = np.stack([seq.frame(i)[0] for i in range(frame_batch)]).astype(np.float32)
        reps = -(-frames.shape[0] // nd) * nd  # pad the batch to a multiple of the axis
        imgs = torch.from_numpy(np.resize(frames, (reps,) + frames.shape[1:])).to(device)
        cfg = SIFTConfig(max_keypoints=256, n_octaves=2)
        return _bench(lambda: frontend_batch.detect_batch(imgs, cfg, mesh), device) / reps
    rng = np.random.default_rng(0)
    tr = synthetic.make_tracks(rng, seq.calib, seq.gt_poses[0], seq.gt_poses[1], seq.landmarks, noise_px=0.3)
    calib = seq.calib.to(device)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    px = dev(tr.px_cur_l)
    X = triangulate_rectified(dev(tr.px_prev_l), dev(tr.px_prev_r), calib)
    msk = torch.ones(px.shape[0], dtype=torch.bool, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cfg_r = RansacConfig(n_hypotheses=n_hyp)
    return _bench(lambda: ransac_sharded.estimate_world_pose_sharded(px, X, msk, calib, cfg_r, gen, mesh), device)


def run(device_counts=(1, 2, 4), frame_batch=8, image_size=(128, 256), n_hyp=2048, device=None, backend=None, timeout=300.0):
    """Per rank count: front-end ms per frame (data axis) and RANSAC ms per call (model axis).

    ``device`` None is the current card, which the ranks then share
    (``backend="gloo"``); ``"cpu"`` runs on gloo.
    """
    from ..utils.device import resolve
    from .mesh import launch

    device = resolve(device)
    rows = []
    for nd in device_counts:
        common = (frame_batch, image_size, n_hyp)
        t_front = launch(_components_rank, (nd, 1), device, backend, args=("data",) + common, timeout=timeout)[0]
        t_ransac = launch(_components_rank, (1, nd), device, backend, args=("model",) + common, timeout=timeout)[0]
        rows.append(dict(ranks=nd, frontend_ms_per_frame=round(1000 * t_front, 2), ransac_ms=round(1000 * t_ransac, 2)))
    return rows


def _integrated_rank(mesh, device, n_frames, image_size):
    from ..config import PipelineConfig
    from ..io import synthetic
    from ..odometry import runner

    seq = synthetic.kitti_synthetic_sequence(n_frames=n_frames, n_landmarks=3000, seed=1, image_size=image_size)
    res = runner.run_sequence(seq, PipelineConfig(), n_frames=n_frames, mesh=mesh, device=device)
    return res.poses, res.per_frame_ms


def run_integrated(mesh_shape=(2, 2), n_frames=48, image_size=(188, 620), device=None, backend=None, timeout=1200.0):
    """End-to-end PRODUCTION runner on a mesh (the --mesh CLI mode): the per-frame step with
    detection sharded on "data" and RANSAC hypothesis-sharded on "model", against the
    identical single-process run. Trajectory equivalence (max pose deviation < 2e-2) is
    reported as ``equivalent``; the two ms-per-frame figures are to be read as the module
    docstring says."""
    from ..config import PipelineConfig
    from ..io import synthetic
    from ..odometry import runner
    from ..utils.device import resolve
    from .mesh import launch

    device = resolve(device)
    seq = synthetic.kitti_synthetic_sequence(n_frames=n_frames, n_landmarks=3000, seed=1, image_size=image_size)
    res1 = runner.run_sequence(seq, PipelineConfig(), n_frames=n_frames, progress=lambda i, s: None, device=device)
    per_rank = launch(_integrated_rank, mesh_shape, device, backend, args=(n_frames, image_size), timeout=timeout, threads=None)
    posesM, msM = per_rank[0]
    pose_dev = float(np.abs(posesM - res1.poses).max()) if res1.poses.size else 0.0
    return dict(
        integrated_mesh=list(mesh_shape),
        n_frames=n_frames,
        single_process_ms_per_frame=round(res1.per_frame_ms, 2),
        meshed_ms_per_frame=round(msM, 2),
        max_pose_deviation_m=round(pose_dev, 6),
        equivalent=pose_dev < 2e-2,
        ranks_bit_equal=all(np.array_equal(p, posesM) for p, _ in per_rank),
        note="ranks timeshare the device: the ratio is integration overhead on shared hardware",
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU over gloo (default: ranks share the current CUDA card over gloo)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    for row in run(device=device, backend="gloo"):
        print(json.dumps(row))
    print(json.dumps(run_integrated(device=device, backend="gloo")))


if __name__ == "__main__":
    main()
