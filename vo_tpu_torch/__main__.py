"""Command-line interface: run / evaluate the VO engine (port of vo_tpu.__main__).

Every constant the reference hard-codes is a flag, plus checkpoint/resume and
figure dumps. ``run`` uses the current CUDA device unless ``--cpu`` is given.

  python -m vo_tpu_torch run --synthetic --frames 50 --out /tmp/vo
  python -m vo_tpu_torch run --data kitti/00 --poses kitti/poses/00.txt --out out/
  python -m vo_tpu_torch run --data kitti/00 --out out/ --checkpoint-every 500 [--resume]
  python -m vo_tpu_torch eval --trajectory out/trajectory.npz --poses kitti/poses/00.txt
  python -m vo_tpu_torch run --synthetic --frames 50 --out /tmp/vo --cpu --mesh 1,2

``--mesh DATA,MODEL`` runs the same command on DATA * MODEL ranks, one process
each, which this process launches (dist.mesh.launch): on the card that needs
DATA * MODEL cards (NCCL), with ``--cpu`` it runs on gloo. Rank 0 prints and
writes the results. Where an outer launcher has set ``RANK`` and
``WORLD_SIZE`` the process joins that world instead of launching one.

Not ported yet: ``bench`` (the port has no benchmark); it exits with code 2 and
says so.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# Launched ranks of ``run --mesh`` still running after this long are killed (a dead rank ends the
# run at once; this only bounds a hang).
MESH_TIMEOUT_S = 24 * 3600.0


def _add_run(sub):
    p = sub.add_parser("run", help="run VO over a KITTI sequence or the synthetic feed")
    p.add_argument("--data", help="KITTI sequence dir with calib.txt + image_0/ image_1/")
    p.add_argument("--poses", help="ground-truth pose file (for evaluation + figures)")
    p.add_argument("--synthetic", action="store_true", help="use the synthetic KITTI-geometry feed")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--out", default="out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-view-3d", action="store_true", help="disable the landmark map (VO.m:6)")
    p.add_argument("--viz-every", type=int, default=0, help="figure dump period (VO.m:168 used 100)")
    p.add_argument("--progress", action="store_true", help="per-frame console progress (syncs every frame)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-keypoints", type=int, default=None)
    p.add_argument("--hypotheses", type=int, default=None)
    p.add_argument(
        "--multi-orientation",
        action="store_true",
        help="(default) duplicate keypoints for secondary orientation peaks (MATLAB >=80%% rule)",
    )
    p.add_argument(
        "--single-orientation",
        action="store_true",
        help="dominant orientation peak only (disables the MATLAB multi-peak rule)",
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    p.add_argument(
        "--mesh",
        default=None,
        metavar="DATA,MODEL",
        help="device-mesh shape, e.g. 2,4: detection sharded over DATA (1 or 2, the stereo pair), "
        "RANSAC hypotheses + BA landmarks sharded over MODEL. One process per rank; needs "
        "DATA*MODEL cards, or --cpu (gloo)",
    )
    p.add_argument("--ba", action="store_true", help="enable sliding-window bundle adjustment")
    p.add_argument("--loop-closure", action="store_true", help="enable loop detection + pose-graph correction")
    p.add_argument("--loop-radius", type=float, default=None, help="loop candidate proximity gate (m)")
    p.add_argument("--loop-min-inliers", type=int, default=None, help="geometric verification threshold")
    p.add_argument("--loop-max-keyframes", type=int, default=None, help="pose-graph node capacity")
    p.add_argument(
        "--no-loop-appearance",
        action="store_true",
        help="disable the appearance-retrieval candidate channel (proximity only)",
    )
    p.add_argument(
        "--loop-drift-frac",
        type=float,
        default=None,
        help="closure benefit-gate slope per meter traveled since the candidate",
    )
    p.add_argument(
        "--precision",
        choices=("default", "float32"),
        default=None,
        help="accepted for the reference's command lines; the port's step is float32 either way",
    )
    return p


def _build_cfg(args):
    import dataclasses

    from .config import PipelineConfig

    cfg = PipelineConfig(view_3d=not args.no_view_3d)
    if args.max_keypoints:
        cfg = dataclasses.replace(cfg, sift=dataclasses.replace(cfg.sift, max_keypoints=args.max_keypoints))
    if args.single_orientation:
        cfg = dataclasses.replace(cfg, sift=dataclasses.replace(cfg.sift, n_orientations=1))
    elif args.multi_orientation:
        cfg = dataclasses.replace(cfg, sift=dataclasses.replace(cfg.sift, n_orientations=2))
    if args.hypotheses:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac, n_hypotheses=args.hypotheses))
    loop_kw = {}
    if args.loop_radius is not None:
        loop_kw["radius"] = args.loop_radius
    if args.loop_min_inliers is not None:
        loop_kw["min_inliers"] = args.loop_min_inliers
    if args.loop_max_keyframes is not None:
        loop_kw["max_keyframes"] = args.loop_max_keyframes
    if args.no_loop_appearance:
        loop_kw["appearance"] = False
    if args.loop_drift_frac is not None:
        loop_kw["drift_frac"] = args.loop_drift_frac
    if loop_kw:
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, **loop_kw))
    if args.precision:
        cfg = dataclasses.replace(cfg, matmul_precision=args.precision)
    return cfg


def _write_figures(res, gt, err, times, out_dir: str) -> None:
    from .viz import figures

    figures.trajectory_map(res.poses, np.asarray(gt), path=os.path.join(out_dir, "map.png"))
    figures.error_curve(err, times, path=os.path.join(out_dir, "error.png"))
    if res.landmarks.shape[0]:
        figures.map_3d(res.landmarks, res.poses, path=os.path.join(out_dir, "3d_map.png"))


def _mesh_rank(mesh, device, args) -> int:
    """One launched rank of ``run --mesh``: the run itself, on the rank's mesh."""
    return _run(args, device, mesh)


def cmd_run(args) -> int:
    import torch

    from .utils.device import resolve

    try:
        device = resolve("cpu" if args.cpu else None)  # the card unless --cpu; never the CPU unasked
    except RuntimeError as e:
        print(f"error: {e} (on the command line: --cpu)", file=sys.stderr)
        return 2
    if not args.mesh:
        return _run(args, device, None)

    from .config import MeshConfig
    from .dist import mesh as mesh_mod

    try:
        data, model = (int(x) for x in args.mesh.split(","))
    except ValueError:
        print("error: --mesh expects DATA,MODEL (e.g. 2,4)", file=sys.stderr)
        return 2
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # An outer launcher started this process as one rank of its world: join it.
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        mesh_mod.init_distributed("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device=device)
        return _run_and_leave(args, device, mesh_mod.make_mesh(MeshConfig(data=data, model=model), device=device))
    n_dev = torch.cuda.device_count() if device.type == "cuda" else data * model
    if data * model > n_dev:
        print(
            f"error: --mesh {data}x{model} needs {data * model} devices, have {n_dev} "
            "(one CUDA card per rank; on the CPU: --cpu)",
            file=sys.stderr,
        )
        return 2
    if data * model == 1:
        return _run_and_leave(args, device, mesh_mod.make_mesh(MeshConfig(data=1, model=1), device=device))
    # One rank per card (NCCL), or all on the CPU (gloo).
    devices = [f"cuda:{r}" for r in range(data * model)] if device.type == "cuda" else device
    # The ranks unpickle their function by module name, and a process started with ``-m``
    # knows this module only as ``__main__``: hand them the function under its importable name.
    import importlib

    rank_fn = importlib.import_module("vo_tpu_torch.__main__")._mesh_rank
    return mesh_mod.launch(rank_fn, (data, model), devices, args=(args,), timeout=MESH_TIMEOUT_S, threads=max(1, (os.cpu_count() or 1) // (data * model)))[0]


def _run_and_leave(args, device, mesh) -> int:
    """``_run`` in a world this process joined itself, which it leaves before it exits."""
    import torch.distributed as dist

    try:
        return _run(args, device, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device, mesh) -> int:
    """``run`` on ``device``; under ``mesh`` every rank computes and rank 0 prints and writes."""
    import torch.distributed as dist

    from .eval import metrics
    from .io import kitti, synthetic
    from .odometry import runner

    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    if args.synthetic:
        seq = synthetic.kitti_synthetic_sequence(n_frames=args.frames or 50, seed=args.seed)
    elif args.data:
        if not os.path.exists(os.path.join(args.data, "calib.txt")):
            print(f"error: no calib.txt under {args.data}", file=sys.stderr)
            return 2
        seq = kitti.StereoSequence(args.data, poses_path=args.poses)
        if len(seq) == 0:
            print(
                f"error: no frames under {args.data}/image_0 — KITTI images are "
                "git-ignored upstream; download them or use --synthetic",
                file=sys.stderr,
            )
            return 2
        say(f"image decoder: {seq.decoder}")
    else:
        print("error: need --data or --synthetic", file=sys.stderr)
        return 2
    gt = seq.gt_poses

    say(f"device: {device}")
    cfg = _build_cfg(args)
    if mesh is not None:
        import dataclasses

        from .config import MeshConfig
        from .dist.mesh import mesh_shape

        shape = mesh_shape(mesh)
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(data=shape["data"], model=shape["model"]))
        platform = "gpu" if device.type == "cuda" else "cpu"
        say(f"mesh: {shape} over {dist.get_world_size()} {platform} devices")
    if args.precision == "default":
        say("note: --precision default: the port's step is float32 throughout; the option changes nothing")
    os.makedirs(args.out, exist_ok=True)

    def progress(i, info):
        if i % 10 == 0:
            say(f"frame {i}: tracks={info['n_tracks']} inliers={info['n_inliers']} ok={info['pose_ok']}")

    res = runner.run_sequence(
        seq,
        cfg,
        n_frames=args.frames,
        seed=args.seed,
        # per-frame progress makes the host wait for the device each frame; only
        # wire it when asked — the every-N telemetry (--viz-every) keeps the deferred path
        progress=progress if args.progress else None,
        checkpoint_path=os.path.join(args.out, "checkpoint.npz"),
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        use_ba=args.ba,
        use_loop_closure=args.loop_closure,
        viz_every=args.viz_every,
        viz_dir=os.path.join(args.out, "img") if args.viz_every else None,
        device=device,
        mesh=mesh,
    )
    if not rank0:
        return 0
    runner.save_result(res, args.out)
    print(f"{res.poses.shape[0] + 1} frames  {res.frames_per_sec:.2f} fps  {res.per_frame_ms:.1f} ms/frame")

    if gt is not None and res.poses.shape[0]:
        a = metrics.ate(res.poses, np.asarray(gt))
        err = metrics.xz_error(res.poses, np.asarray(gt))
        print(f"ATE rmse {a['rmse']:.3f} m  mean {a['mean']:.3f} m  max {a['max']:.3f} m")
        with open(os.path.join(args.out, "metrics.json"), "w") as f:
            json.dump(dict(ate=a, xz_mean=float(err.mean()), xz_max=float(err.max())), f, indent=2)
        try:
            _write_figures(res, gt, err, getattr(seq, "times", None), args.out)
        except ModuleNotFoundError as e:
            if e.name != "matplotlib":
                raise
            print("figures skipped: matplotlib is not installed")
    return 0


def cmd_eval(args) -> int:
    from .eval import metrics
    from .io import kitti

    z = np.load(args.trajectory)
    est = z["poses"]
    gt = kitti.read_poses(args.poses)
    a = metrics.ate(est, gt)
    r = metrics.rpe(est, gt)
    err = metrics.xz_error(est, gt)
    print(json.dumps(dict(ate=a, rpe=r, xz_mean=float(err.mean()), xz_max=float(err.max())), indent=2))
    return 0


def cmd_bench(args) -> int:
    print("error: bench: vo_tpu_torch has no benchmark yet", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vo_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_run(sub)
    pe = sub.add_parser("eval", help="evaluate a saved trajectory against GT poses")
    pe.add_argument("--trajectory", required=True)
    pe.add_argument("--poses", required=True)
    sub.add_parser("bench", help="not ported yet: the port has no benchmark")
    args = ap.parse_args(argv)
    return {"run": cmd_run, "eval": cmd_eval, "bench": cmd_bench}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
