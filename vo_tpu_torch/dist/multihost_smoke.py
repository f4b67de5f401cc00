"""Multi-process bring-up smoke: init_distributed + one sharded solve (port of vo_tpu.dist.multihost_smoke).

Every process joins the ``torch.distributed`` world, the mesh spans all of
them, and one hypothesis-sharded RANSAC solve runs with its all-gather winner
reduction crossing the process boundary. Each process prints one JSON line
with the resulting pose translation; a launcher asserts that the lines agree
bit for bit: the collectives' contract is that every rank ends with the SAME
winner. The geometry is the committed KITTI-00 calibration and poses.

Run by hand (two shells or one line; add ``--cpu`` where there is no card per process):

  python -m vo_tpu_torch.dist.multihost_smoke --cpu --processes 2 --process-id 0 --port 12631 &
  python -m vo_tpu_torch.dist.multihost_smoke --cpu --processes 2 --process-id 1 --port 12631

``--coordinator`` may also be a full init method (``file:///tmp/rdv``), which needs no port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--port", type=int, default=12631)
    ap.add_argument("--coordinator", default="127.0.0.1")
    ap.add_argument("--hypotheses", type=int, default=256)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU over gloo (default: this process's CUDA card, NCCL)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..config import MeshConfig, RansacConfig
    from ..geom.triangulate import triangulate_rectified
    from ..io import kitti, synthetic
    from ..utils.device import resolve
    from . import ransac_sharded
    from .mesh import init_distributed, make_mesh

    device = resolve("cpu" if args.cpu else None)
    coordinator = args.coordinator if "://" in args.coordinator else f"{args.coordinator}:{args.port}"
    init_distributed(coordinator, args.processes, args.process_id, device=device)
    mesh = make_mesh(MeshConfig(data=1, model=args.processes), device=device)

    # Identical replicated inputs on every process (same seed).
    root = synthetic.DEFAULT_KITTI_ROOT
    calib = kitti.load_stereo_calib(os.path.join(root, "00"))
    gt = kitti.read_poses(os.path.join(root, "poses", "00.txt"))
    rng = np.random.default_rng(0)
    lms = synthetic.scatter_landmarks(rng, gt[:2], 400)
    tr = synthetic.make_tracks(rng, calib, gt[0], gt[1], lms, noise_px=0.3)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    calib = calib.to(device)
    px = dev(tr.px_cur_l)
    X = triangulate_rectified(dev(tr.px_prev_l), dev(tr.px_prev_r), calib)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    est = ransac_sharded.estimate_world_pose_sharded(
        px, X, torch.ones(px.shape[0], dtype=torch.bool, device=device), calib,
        RansacConfig(n_hypotheses=args.hypotheses), gen, mesh,
    )
    pose = est.pose_c2w.cpu().numpy()
    print(
        json.dumps(
            dict(
                process=args.process_id,
                n_global_devices=torch.distributed.get_world_size() if args.processes > 1 else 1,
                ok=bool(est.ok),
                n_inliers=int(est.n_inliers),
                t=[float(v) for v in pose[:3, 3]],
            )
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
