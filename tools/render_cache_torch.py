"""Parallel rendering of the synthetic-feed frame cache for the port (counterpart of tools/render_cache.py).

The synthetic renderer (``vo_tpu_torch.io.synthetic``) is host-side numpy and renders each frame
on its own, so a long feed's cache (``vo_tpu_torch.bench.preload_cached``'s file) is rendered in
parallel. Either in one command, ``--workers N`` (spawned processes through
``preload_cached(workers=N)``), or as the reference does it: each worker renders a strided slice
of the frames into a part file (``idx``, ``l``, ``r``), and ``--merge`` assembles the cache at
the path ``preload_cached`` reads (``bench.cache_path``), after which ``tools/bigrun_torch.py``
and ``tools/severity_sweep_torch.py`` find it. Frames are quantized to uint8 as the
reference quantizes them (``bench._q``). The poses are the committed
``tests/data/kitti/poses/00.txt`` (4,500 poses; ``--traj outback`` takes
``tools/longrun_torch.out_and_back_poses``). A cache of the same name rendered from other
poses is never overwritten, and a merge that misses a frame writes nothing.

One command, all the machine's cores:
  python tools/render_cache_torch.py --frames 4500 --landmarks 54000 --noise 0.02 --workers 8
Parts and merge (as the reference):
  python tools/render_cache_torch.py --frames 4500 --landmarks 54000 --noise 0.02 \\
      --offset 0 --stride 2 --part part0.npz &
  python tools/render_cache_torch.py --frames 4500 --landmarks 54000 --noise 0.02 \\
      --offset 1 --stride 2 --part part1.npz &
  wait
  python tools/render_cache_torch.py --frames 4500 --landmarks 54000 --noise 0.02 --merge part0.npz part1.npz

``--cache-dir`` (default: the temporary directory) and ``--image-size H,W`` name another cache,
as ``preload_cached``'s arguments do (tests use them).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def build_seq(args):
    """(the synthetic sequence, its poses) that ``args`` name."""
    from vo_tpu_torch.io import kitti, synthetic

    root = synthetic.DEFAULT_KITTI_ROOT
    calib = kitti.load_stereo_calib(os.path.join(root, "00"))
    if args.traj == "full":
        poses = kitti.read_poses(os.path.join(root, "poses", "00.txt"))[: args.frames]
    else:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from longrun_torch import out_and_back_poses

        poses = out_and_back_poses(args.frames)
    seq = synthetic.SyntheticSequence(
        calib, poses, n_landmarks=args.landmarks, seed=args.seed, image_size=args.image_size, noise=args.noise
    )
    return seq, poses


def refuse_other_poses(cache: str, poses: np.ndarray) -> None:
    """SystemExit where ``cache`` exists and was rendered from other poses (the name does not
    encode ``--traj``: a full-trajectory render and an out-and-back of the same counts collide)."""
    if os.path.exists(cache):
        z = np.load(cache)
        if "poses" in z and (z["poses"].shape != poses.shape or not np.allclose(z["poses"], poses)):
            raise SystemExit(
                f"refusing to overwrite {cache}: existing cache was rendered "
                "from different poses (--traj mismatch?); delete it explicitly"
            )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--landmarks", type=int, required=True)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traj", choices=("full", "outback"), default="full")
    ap.add_argument("--offset", type=int, default=0)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--part", default=None, help="write this worker's strided slice here")
    ap.add_argument("--merge", nargs="*", default=None, help="part files to merge into the cache")
    ap.add_argument("--workers", type=int, default=0, help="render the whole cache in one command, in N processes")
    ap.add_argument("--cache-dir", default=None, help="directory of the cache (default: the temporary directory)")
    ap.add_argument("--image-size", default=None, metavar="H,W", help="render at H,W (tests)")
    args = ap.parse_args(argv)
    args.image_size = tuple(int(x) for x in args.image_size.split(",")) if args.image_size else None
    if sum(bool(x) for x in (args.part, args.merge, args.workers)) != 1:
        ap.error("give exactly one of --part, --merge and --workers")

    from vo_tpu_torch.bench import _q, cache_path, preload_cached

    seq, poses = build_seq(args)
    if len(poses) < args.frames:
        ap.error(f"--frames {args.frames}: the trajectory has {len(poses)} poses")
    cache = cache_path(args.frames, args.landmarks, args.seed, args.image_size, args.noise, args.cache_dir)

    if args.workers:
        refuse_other_poses(cache, poses)
        if os.path.exists(cache):
            print("cache already there:", cache, flush=True)
            return 0
        preload_cached(
            seq.calib, poses, args.frames, args.landmarks, args.seed, image_size=args.image_size, noise=args.noise,
            cache_dir=os.path.dirname(cache), workers=args.workers,
        )
        print(f"rendered with {args.workers} workers ->", cache, flush=True)
        return 0

    if args.merge:
        refuse_other_poses(cache, poses)
        H, W = seq.H, seq.W
        L = np.zeros((args.frames, H, W), np.uint8)
        R = np.zeros((args.frames, H, W), np.uint8)
        seen = np.zeros(args.frames, bool)
        for p in args.merge:
            z = np.load(p)
            idx = z["idx"]
            L[idx] = z["l"]
            R[idx] = z["r"]
            seen[idx] = True
        if not seen.all():
            raise SystemExit(f"the parts miss frames {np.flatnonzero(~seen)[:10].tolist()}")
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, l=L, r=R, poses=poses)
        print("merged ->", cache, flush=True)
        return 0

    idx = np.arange(args.offset, args.frames, args.stride)
    Ls, Rs = [], []
    t0 = time.perf_counter()
    for j, i in enumerate(idx):
        l, r = seq.frame(int(i))
        Ls.append(_q(l))
        Rs.append(_q(r))
        if j % 200 == 199:
            dt = time.perf_counter() - t0
            print(f"# worker {args.offset}: {j + 1}/{idx.size} frames, {dt:.0f}s", flush=True)
    np.savez(args.part, idx=idx, l=np.stack(Ls), r=np.stack(Rs))
    print(f"# worker {args.offset}: done {idx.size} frames in {time.perf_counter() - t0:.0f}s -> {args.part}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
