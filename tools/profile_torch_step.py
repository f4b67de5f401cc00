"""Where the PyTorch/CUDA port's main path spends its time on one CUDA card.

    python tools/profile_torch_step.py [--frames 30] [--eager]
    python tools/profile_torch_step.py --refined [--eager]
    python tools/profile_torch_step.py --exact
    python tools/profile_torch_step.py --mesh 1,2 [--ba]

Renders the synthetic KITTI-00 feed (30 frames, 6000 landmarks, seed 0, as
chip_smoke.py), stages it on the card and runs odometry.runner.run_sequence at
the default PipelineConfig. Prints, with the card's name and power limit:

- the untraced run: ms/frame and fps (host clock around a synchronised run);
- the same run under torch.profiler: device busy ms/frame (sum of kernel and
  copy times on the card; one stream, so they do not overlap), the device's
  idle share (1 - busy / untraced wall), device launches per frame (kernels,
  copies and fills that ran on the card), host launches per frame (the
  launching calls the host made: ``cudaLaunchKernel``, ``cudaGraphLaunch``,
  ``cudaMemcpyAsync`` and the like; one replay of a captured step is one
  ``cudaGraphLaunch`` however many kernels it runs), and the kernels
  that take the most device time, with the two hand-written kernels named
  (K1 extrema_scores, K2 bin_maps) whatever their rank;
- per stage of one 2-frame group (batched detection, each frame's _step_core,
  each landmark insert): host time to enqueue, wall time to a synchronise,
  device busy time and launches. Enqueue close to wall with little device time
  means the stage is bound by launches from the host;
- what detection's device time is made of: K1 (one launch over the pyramid),
  the per-octave torch.topk over [4, 3*H*W] that follows K1, and K2 (one
  launch), each run alone on the detection batch's pyramid.

On the card the runner steps through captured CUDA graphs (utils.graphs);
``--eager`` profiles the eager step (``graph=False``) instead.

With ``--refined`` it profiles the refined path instead
(run_sequence(use_ba=True, use_loop_closure=True) over chip_smoke.py's
199-frame out-and-back feed): untraced ms/frame and fps, the refiner's stats
(main-thread wait, worker phase seconds), and under torch.profiler the device
busy time (the union of kernel and copy intervals over both streams: the
frame loop's and the refiner's) and idle share.

With ``--exact`` it profiles one detection call (4 images) on the exact-SIFT
oracle path (``fast_descriptor=False``) beside the fast path's: host time to
enqueue, wall time, device busy time, launches and the launches of the two
hand-written kernels (the exact path launches K1 once and K2 never), the
kernels that take the most device time, and peak device memory.

With ``--mesh DATA,MODEL`` it profiles ``run_sequence(mesh=)`` on DATA * MODEL
ranks that SHARE the card over gloo (dist.mesh.launch; every collective is
staged through pinned host memory): on rank 0 the untraced ms/frame beside the
single-process run frame by frame, and under torch.profiler that process's
device busy time and idle share, the number of collectives per frame, the host
time spent inside them (the stream wait, the host round trip and the wait for
the peers), and the device time of NCCL kernels (none under gloo) and of all
device copies (the staging among them). ``--ba`` adds window BA. The ratio of
the two ms/frame figures is the overhead of the integration on one shared
card and says nothing about a card per rank.

The summary is also written as JSON to chiprun_out/profile_torch_step.json
(``_eager`` before ``.json`` with ``--eager``; profile_torch_step_refined.json with ``--refined``, profile_torch_step_exact.json
with ``--exact``, profile_torch_step_mesh.json with ``--mesh``).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vo_tpu_torch.config import PipelineConfig  # noqa: E402
from vo_tpu_torch.frontend import kernels  # noqa: E402
from vo_tpu_torch.frontend.pyramid import build_pyramid  # noqa: E402
from vo_tpu_torch.frontend.sift import _octave_caps, detect_and_describe  # noqa: E402
from vo_tpu_torch.io import synthetic  # noqa: E402
from vo_tpu_torch.odometry import landmarks, pipeline, runner  # noqa: E402


# Device kernel names of the hand-written kernels (csrc/*.cu), as the profiler reports them.
HAND_WRITTEN = {"extrema_scores_kernel": "K1 extrema_scores", "bin_maps_kernel": "K2 bin_maps"}
# The host's launching calls, as the profiler names the CUDA runtime and driver calls.
HOST_LAUNCH_CALLS = {
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
    "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset",
}


def hand_written_ms(by_name) -> dict:
    """{K1 ..., K2 ...: device ms} summed over the profiler's kernel names."""
    return {label: sum(v for k, v in by_name.items() if key in k) for key, label in HAND_WRITTEN.items()}


def device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def traced(fn, reps: int):
    """(device busy ms, launches, {kernel name: ms}) per call of fn, from torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = device_events(prof)
    by_name = collections.Counter()
    for e in evs:
        by_name[e.name] += e.time_range.elapsed_us() / 1000.0 / reps
    return union_ms(evs) / reps, len(evs) / reps, by_name


def frame_loop_trace(run, n_frames: int):
    """run() (a run_sequence call) under torch.profiler -> (its result, per-frame figures of its frame
    loop: device busy ms (the union over streams), device launches, host launches and the calls
    among them). Only the span ``runner.FRAME_LOOP`` counts: the warm-up and the capture before it
    are left out, and so is the device work queued before the span began."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    evs = prof.events()
    span = next(e.time_range for e in evs if e.name == runner.FRAME_LOOP and e.device_type != torch.autograd.DeviceType.CUDA)
    dev = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA and e.name != runner.FRAME_LOOP
           and e.time_range.start >= span.start]
    host = collections.Counter(e.name for e in evs if e.name in HOST_LAUNCH_CALLS and span.start <= e.time_range.start <= span.end)
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us() / 1000.0 / n_frames
    return res, dict(
        device_busy_ms_per_frame=union_ms(dev) / n_frames,
        device_launches_per_frame=len(dev) / n_frames,
        host_launches_per_frame=sum(host.values()) / n_frames,
        host_launch_calls_per_frame={k: v / n_frames for k, v in sorted(host.items())},
        kernel_ms_per_frame=by_name,
    )


def union_ms(evs) -> float:
    """Device busy ms: the union of the events' intervals (streams may overlap)."""
    busy, end = 0.0, -float("inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1000.0


def host_times(fn, reps: int):
    """(ms to enqueue, ms to a synchronise) per call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    return 1000.0 * t_enq / reps, 1000.0 * t_all / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--refined", action="store_true", help="profile the refined path (BA + loop closure)")
    ap.add_argument("--exact", action="store_true", help="profile a detection call on the exact-SIFT path")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL", help="profile run_sequence(mesh=) on ranks sharing the card over gloo")
    ap.add_argument("--ba", action="store_true", help="with --mesh: window BA on (the worker's collectives too)")
    ap.add_argument("--eager", action="store_true", help="profile the eager step (graph=False), not the captured graphs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    cfg = PipelineConfig()
    graph = False if args.eager else None
    if args.refined:
        return profile_refined(cfg, dev, card, graph)
    if args.exact:
        return profile_exact(cfg, dev, card, args.reps)
    if args.mesh:
        return profile_mesh(cfg, dev, card, tuple(int(x) for x in args.mesh.split(",")), args.frames, args.ba)
    seq = synthetic.kitti_synthetic_sequence(n_frames=args.frames, n_landmarks=6000, seed=0)
    feed = runner.StagedSequence(seq, args.frames, dev)

    runner.run_sequence(feed, cfg, device=dev, graph=graph)  # warm: build, allocator, library handles
    res = runner.run_sequence(feed, cfg, device=dev, warmup=False, graph=graph)
    n = args.frames
    _, loop = frame_loop_trace(lambda: runner.run_sequence(feed, cfg, device=dev, warmup=False, graph=graph), n)
    by_name = loop.pop("kernel_ms_per_frame")
    summary = dict(
        card=card,
        frames=n,
        graphed=graph is None,
        wall_ms_per_frame=res.per_frame_ms,
        fps=res.frames_per_sec,
        device_idle_share=1.0 - loop["device_busy_ms_per_frame"] / res.per_frame_ms,
        **loop,
        top_kernels_ms_per_frame=dict(by_name.most_common(12)),
        hand_written_ms_per_frame=hand_written_ms(by_name),
    )
    print(
        f"main path ({'graphed' if graph is None else 'eager'}): {res.per_frame_ms:.3f} ms/frame ({res.frames_per_sec:.2f} fps) "
        f"untraced; device busy {loop['device_busy_ms_per_frame']:.3f} ms/frame, idle share {summary['device_idle_share']:.3f}, "
        f"{loop['device_launches_per_frame']:.0f} device launches/frame, {loop['host_launches_per_frame']:.1f} host "
        f"launches/frame {loop['host_launch_calls_per_frame']}"
    )
    for k, v in by_name.most_common(12):
        print(f"  {v:8.4f} ms/frame  {k[:110]}")
    for k, v in summary["hand_written_ms_per_frame"].items():
        print(f"  {v:8.4f} ms/frame  {k} (hand-written)")

    # --- stages of one 2-frame group, from the state after frame 1 ---
    calib = seq.calib.to(dev)
    imgs = torch.stack([pipeline._normalize(im) for i in (2, 3) for im in feed.frame(i)])
    state = pipeline.init_state(cfg, 0, dev)
    for i in (0, 1):
        state, _ = pipeline.vo_step(state, *feed.frame(i), calib, cfg)
    feats = detect_and_describe(imgs, cfg.sift)
    fl, fr = (pipeline._image_features(feats, k) for k in (0, 1))
    _, out = pipeline._step_core(state, fl, fr, calib, cfg)
    lmap = landmarks.init_map(cfg.landmarks, dev)
    # The pieces of detection that the hand-written kernels and the top-k after K1 account for.
    s = cfg.sift
    pyr = build_pyramid(imgs, s)
    dogs = pyr.dog[: s.n_octaves]
    levels = [G[:, 1 : s.scales_per_octave + 1] for G in pyr.gauss[: s.n_octaves]]
    scores = kernels.extrema_scores_octaves(dogs, s.contrast_threshold)
    caps = _octave_caps(s)
    stages = {
        "detect_and_describe (4 images)": lambda: detect_and_describe(imgs, cfg.sift),
        "  K1 extrema_scores_octaves (1 launch)": lambda: kernels.extrema_scores_octaves(dogs, s.contrast_threshold),
        "  topk after K1 (4 octaves, [4, 3*H*W] each)": lambda: [
            torch.topk(sc.reshape(sc.shape[0], -1), k, dim=1) for sc, k in zip(scores, caps)
        ],
        "  K2 bin_maps_octaves (1 launch)": lambda: kernels.bin_maps_octaves(levels),
        "_step_core (1 frame)": lambda: pipeline._step_core(state, fl, fr, calib, cfg),
        "landmarks.insert (1 frame)": lambda: landmarks.insert(
            lmap, out.new_lm_l_px, out.new_lm_r_px, out.new_lm_mask, out.pose_c2w, calib, cfg.landmarks
        ),
    }
    summary["stages"] = {}
    for name, fn in stages.items():
        enq, wall = host_times(fn, args.reps)
        busy, launches, by = traced(fn, args.reps)
        summary["stages"][name] = dict(enqueue_ms=enq, wall_ms=wall, device_ms=busy, launches=launches)
        print(f"stage {name}: enqueue {enq:.3f} ms, wall {wall:.3f} ms, device {busy:.3f} ms, {launches:.0f} launches")
        for k, v in by.most_common(4):
            print(f"    {v:8.4f} ms  {k[:100]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_step" + ("_eager" if args.eager else "") + ".json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


def profile_exact(cfg: PipelineConfig, dev, card: str, reps: int) -> int:
    seq = synthetic.kitti_synthetic_sequence(n_frames=2, n_landmarks=6000, seed=0)
    feed = runner.StagedSequence(seq, 2, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    imgs = torch.stack([pipeline._normalize(im) for i in (0, 1) for im in feed.frame(i)])
    summary = dict(card=card, images=int(imgs.shape[0]), paths={})
    for name, fast in (("exact", False), ("fast", True)):
        sift = dataclasses.replace(cfg.sift, fast_descriptor=fast)
        fn = lambda: detect_and_describe(imgs, sift)  # noqa: E731
        fn()  # warm
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        fn()
        hand = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        enq, wall = host_times(fn, reps)
        busy, launches, by = traced(fn, reps)
        summary["paths"][name] = dict(
            enqueue_ms=enq, wall_ms=wall, device_ms=busy, launches=launches, hand_written_launches=hand,
            peak_memory_bytes=peak, top_kernels_ms={k: v for k, v in by.most_common(8)},
            hand_written_ms=hand_written_ms(by),
        )
        print(
            f"detect_and_describe ({imgs.shape[0]} images), {name} path: enqueue {enq:.3f} ms, wall {wall:.3f} ms, "
            f"device {busy:.3f} ms, {launches:.0f} launches, hand-written launches {hand}, peak memory {peak / 1e6:.1f} MB"
        )
        for k, v in by.most_common(8):
            print(f"    {v:8.4f} ms  {k[:100]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_step_exact.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


def mesh_rank(mesh, device, frames_path: str, gt_poses, use_ba: bool):
    """One rank of ``--mesh``: a warm run, an untraced run and (traced on rank 0) a third."""
    from chip_smoke import ArrayFeed

    from vo_tpu_torch.dist import mesh as mesh_mod
    from vo_tpu_torch.io import kitti

    calib = kitti.load_stereo_calib(os.path.join(synthetic.DEFAULT_KITTI_ROOT, "00"))
    seq = ArrayFeed(frames_path, calib, gt_poses)
    n = len(seq)
    feed = runner.StagedSequence(seq, n, device)
    cfg = PipelineConfig()

    def run(warmup=True):
        return runner.run_sequence(feed, cfg, mesh=mesh, device=device, use_ba=use_ba, warmup=warmup)

    run()  # warm
    res = run()
    mesh_mod.reset_collectives()
    if torch.distributed.get_rank() != 0:
        run(warmup=False)
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(warmup=False)
        torch.cuda.synchronize()
    evs = device_events(prof)
    ranges = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("vo_tpu_torch.dist.")]
    busy = union_ms(evs)
    summary = dict(
        mesh=mesh_mod.mesh_shape(mesh),
        backend=torch.distributed.get_backend(),
        frames=n,
        use_ba=use_ba,
        wall_ms_per_frame=res.per_frame_ms,
        device_busy_ms_per_frame=busy / n,
        device_idle_share=1.0 - (busy / n) / res.per_frame_ms,
        launches_per_frame=len(evs) / n,
        collectives=dict(mesh_mod.COLLECTIVES),
        collectives_per_frame=sum(mesh_mod.COLLECTIVES.values()) / n,
        collective_host_ms_per_frame=sum(e.time_range.elapsed_us() for e in ranges) / 1000.0 / n,
        collective_ranges_traced=len(ranges),
        nccl_device_ms_per_frame=sum(e.time_range.elapsed_us() for e in evs if "nccl" in e.name.lower()) / 1000.0 / n,
        copies_device_ms_per_frame=sum(e.time_range.elapsed_us() for e in evs if "memcpy" in e.name.lower()) / 1000.0 / n,
        refine_stats={k: v for k, v in res.refine_stats.items() if k in ("n_keyframes", "ba_solves", "main_wait_s")},
    )
    return summary


def profile_mesh(cfg: PipelineConfig, dev, card: str, shape, n: int, use_ba: bool) -> int:
    import tempfile

    from chip_smoke import save_frames

    from vo_tpu_torch.dist import mesh as mesh_mod

    seq = synthetic.kitti_synthetic_sequence(n_frames=n, n_landmarks=6000, seed=0)
    feed = runner.StagedSequence(seq, n, dev)
    kw = dict(device=dev, use_ba=use_ba)
    one_cfg = dataclasses.replace(cfg, fused_group=1)  # the mesh steps frame by frame: compare like with like
    runner.run_sequence(feed, one_cfg, **kw)  # warm
    single = runner.run_sequence(feed, one_cfg, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        save_frames(feed, n, path)
        summary = mesh_mod.launch(
            mesh_rank, shape, dev, backend="gloo", args=(path, np.asarray(seq.gt_poses), use_ba), timeout=600.0, threads=2
        )[0]
    summary.update(card=card, single_process_frame_by_frame_ms_per_frame=single.per_frame_ms)
    print(
        f"mesh {summary['mesh']} over {summary['backend']}, ranks sharing the card, {n} frames"
        + (", window BA" if use_ba else "")
        + f": {summary['wall_ms_per_frame']:.3f} ms/frame on rank 0 against {single.per_frame_ms:.3f} ms/frame single-process "
        f"frame by frame (overhead of the integration on one shared card, not scaling); rank 0's device busy "
        f"{summary['device_busy_ms_per_frame']:.3f} ms/frame, idle share {summary['device_idle_share']:.3f}, "
        f"{summary['launches_per_frame']:.0f} launches/frame; collectives {summary['collectives']} "
        f"({summary['collectives_per_frame']:.2f} per frame), {summary['collective_host_ms_per_frame']:.3f} ms/frame of host "
        f"time inside them; device time of NCCL kernels {summary['nccl_device_ms_per_frame']:.4f} ms/frame, of all device "
        f"copies {summary['copies_device_ms_per_frame']:.4f} ms/frame; refine_stats {summary['refine_stats']}"
    )
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_step_mesh.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


def profile_refined(cfg: PipelineConfig, dev, card: str, graph) -> int:
    from chip_smoke import OUT_FRAMES, OutAndBackFeed

    feed = OutAndBackFeed(OUT_FRAMES, dev)
    n = len(feed)

    def run(warmup=True):
        return runner.run_sequence(feed, cfg, use_ba=True, use_loop_closure=True, device=dev, warmup=warmup, graph=graph)

    run()  # warm
    res = run()
    _, loop = frame_loop_trace(lambda: run(warmup=False), n)
    by_name = loop.pop("kernel_ms_per_frame")
    summary = dict(
        card=card,
        frames=n,
        graphed=graph is None,
        wall_ms_per_frame=res.per_frame_ms,
        fps=res.frames_per_sec,
        refine_stats=res.refine_stats,
        device_idle_share=1.0 - loop["device_busy_ms_per_frame"] / res.per_frame_ms,
        **loop,
        top_kernels_ms_per_frame=dict(by_name.most_common(12)),
        hand_written_ms_per_frame=hand_written_ms(by_name),
    )
    print(
        f"refined path ({'graphed' if graph is None else 'eager'}): {res.per_frame_ms:.3f} ms/frame ({res.frames_per_sec:.2f} fps) "
        f"untraced; device busy {loop['device_busy_ms_per_frame']:.3f} ms/frame (both streams), idle share "
        f"{summary['device_idle_share']:.3f}, {loop['device_launches_per_frame']:.0f} device launches/frame, "
        f"{loop['host_launches_per_frame']:.1f} host launches/frame (both threads) {loop['host_launch_calls_per_frame']}"
    )
    print(f"refine_stats {json.dumps(res.refine_stats, sort_keys=True)}")
    for k, v in by_name.most_common(12):
        print(f"  {v:8.4f} ms/frame  {k[:110]}")
    for k, v in summary["hand_written_ms_per_frame"].items():
        print(f"  {v:8.4f} ms/frame  {k} (hand-written)")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_step_refined" + ("" if graph is None else "_eager") + ".json"), "w") as f:
        json.dump(summary, f, indent=1)
    # After tracing the refiner's second thread and stream, the interpreter's
    # exit hung until the call's time limit on the H100 (torch 2.11): leave
    # without the profiler's teardown, everything is written.
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
