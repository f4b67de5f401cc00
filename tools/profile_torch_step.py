"""Where the PyTorch/CUDA port's main path spends its time on one CUDA card.

    python tools/profile_torch_step.py [--frames 30] [--eager]
    python tools/profile_torch_step.py --refined [--eager]
    python tools/profile_torch_step.py --exact
    python tools/profile_torch_step.py --mesh 1,2 [--ba] [--eager]
    python tools/profile_torch_step.py --mesh 2,2 --cards [--ba] [--repeats 5] [--runs graphed,eager] [--timeout 900]

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
  that take the most device time, with the hand-written kernels named
  (K1 extrema_scores, K2 bin_maps, K3 pose_refine) whatever their rank;
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
frame loop's and the refiner's), idle share, and the host launches per frame
apart for the main thread and the refiner's worker thread (by the profiler's
thread ids). On the card the refiner's window solve and verification round
and the keyframe association and global descriptor are CUDA graphs too;
``--eager`` runs all of it eagerly.

With ``--exact`` it profiles one detection call (4 images) on the exact-SIFT
oracle path (``fast_descriptor=False``) beside the fast path's: host time to
enqueue, wall time, device busy time, launches and the launches of the two
hand-written kernels (the exact path launches K1 once and K2 never), the
kernels that take the most device time, and peak device memory.

With ``--mesh DATA,MODEL`` it profiles ``run_sequence(mesh=)`` on DATA * MODEL
ranks (dist.mesh.launch) that SHARE the card over gloo (every collective is
staged through pinned host memory, so the step and a sharded solve stay
eager and only the programs without a collective are graphs), or, with
``--cards``, that have a card each over NCCL (DATA * MODEL cards; every
program a graph, its collectives inside it), once graphed and once with
``graph=False``, whose results must equal bit for bit on every rank (exit 1
otherwise); ``--runs`` names the launches in order (``graphed,eager`` by
default; a name may repeat, and every launch must equal the first), and
``--timeout`` is each launch's time limit (dist.mesh.launch: a rank still
running then is killed, and its threads' Python stacks are shown). ``--ba``
adds window BA over the 199-frame out-and-back feed (the plain mesh runs
``--frames`` of the synthetic feed), and then also exits 1 unless rank 0 is
within 2e-2 m of the one-card BA run and its ATE within plain VO's + 0.02 m;
beside it, the one-card refined run (BA and loop closure) and plain VO on the
same feed. Per rank: a warm run,
``--repeats`` untraced runs (ms/frame: median and spread), and one run under
torch.profiler (graphed the whole feed, eager its first EAGER_TRACE_FRAMES
frames): over the frame loop, device busy ms and idle share, host
launches per frame (by thread), collectives per frame, the device time of
NCCL kernels (none under gloo) and of device copies; and the seconds of each
capture and the bytes of the graph pools. Beside them the single-process run
frame by frame on the first card (median of the same repeats). Under gloo
the ratio of the ms/frame figures is the overhead of the integration on one
shared card; with ``--cards`` each rank has its card, and every figure names
the card count.

The summary is also written as JSON to chiprun_out/profile_torch_step.json
(``_eager`` before ``.json`` with ``--eager``; profile_torch_step_refined.json with ``--refined``, profile_torch_step_exact.json
with ``--exact``, profile_torch_step_mesh_<D>x<M>[_ba][_cards].json with ``--mesh``).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import HOST_LAUNCH_CALLS  # noqa: E402  (the host's launching calls, as the profiler names them)
from vo_tpu_torch.config import PipelineConfig  # noqa: E402
from vo_tpu_torch.frontend import kernels  # noqa: E402
from vo_tpu_torch.frontend.pyramid import build_pyramid  # noqa: E402
from vo_tpu_torch.frontend.sift import _octave_caps, detect_and_describe  # noqa: E402
from vo_tpu_torch.io import synthetic  # noqa: E402
from vo_tpu_torch.odometry import landmarks, pipeline, runner  # noqa: E402
from vo_tpu_torch.utils import cuda_lib, profiling  # noqa: E402
from vo_tpu_torch.utils.profiling import union_ms  # noqa: E402


# An eager meshed run is traced over its first frames only: the profiler's Python post-processing of
# its ~4,000 launches a frame outlasts the launch's time limit over the 199-frame feed.
EAGER_TRACE_FRAMES = 30

# Device kernel names of the hand-written kernels (csrc/*.cu), as the profiler reports them.
HAND_WRITTEN = {
    "extrema_scores_kernel": "K1 extrema_scores", "bin_maps_kernel": "K2 bin_maps", "pose_refine_kernel": "K3 pose_refine",
    "gauss_stack_kernel": "K4 gauss_blur pyramid", "gauss_rows_kernel": "K4 gauss_blur map rows",
}


def hand_written_ms(by_name) -> dict:
    """{K1 ..., K2 ..., K3 ..., K4 ...: device ms} summed over the profiler's kernel names."""
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


def frame_loop_trace(run, n_frames: int, trace_path: str | None = None):
    """run() (a run_sequence call) under torch.profiler -> (its result, per-frame figures of its frame
    loop: device busy ms (the union over streams), device launches, host launches and the calls
    among them, and the host launches by thread: ``main`` the thread that ran the frame loop,
    ``worker`` every other one, the refiner's). Only the span ``runner.FRAME_LOOP`` counts: the
    warm-up and the captures before it are left out, and so is the device work queued before the
    span began; ``worker_host_launches_after_loop`` counts the launches other threads made after it
    (the refiner draining its last keyframes). ``trace_path`` also writes the chrome trace there."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    evs = prof.events()
    loop = next(e for e in evs if e.name == runner.FRAME_LOOP and e.device_type != torch.autograd.DeviceType.CUDA)
    span = loop.time_range
    # (a span's device-side annotation is no device work, and the tracer's stage stamps, which a run
    # under the profiler writes, are no work of the step's: the port's spans are named vo_tpu_torch.*)
    dev = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("vo_tpu_torch.")
           and profiling.STAMP_KERNEL not in e.name and e.time_range.start >= span.start]
    launches = [e for e in evs if e.name in HOST_LAUNCH_CALLS and e.time_range.start >= span.start]
    inside = [e for e in launches if e.time_range.start <= span.end]
    host = collections.Counter(e.name for e in inside)
    # The main thread is this one, the caller of run(); any other (the refiner's worker) goes on after
    # the span until the run drains it. A CUDA runtime call's resource id is the system id of the
    # thread that made it (its ``thread`` is the id of a parent op's thread, or of the thread that
    # read the profile where the call had none).
    main_tid = threading.get_native_id()
    main = [e for e in inside if e.device_resource_id == main_tid]
    worker_after = sum(1 for e in launches if e.device_resource_id != main_tid and e.time_range.start > span.end)
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us() / 1000.0 / n_frames
    return res, dict(
        device_busy_ms_per_frame=union_ms(dev) / n_frames,
        device_launches_per_frame=len(dev) / n_frames,
        host_launches_per_frame=sum(host.values()) / n_frames,
        host_launches_per_frame_by_thread=dict(main=len(main) / n_frames, worker=(len(inside) - len(main)) / n_frames),
        worker_host_launches_after_loop=worker_after,
        host_launch_calls_per_frame={k: v / n_frames for k, v in sorted(host.items())},
        kernel_ms_per_frame=by_name,
    )


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
    ap.add_argument("--ba", action="store_true", help="with --mesh: window BA on (the worker's collectives too), over the 199-frame out-and-back feed")
    ap.add_argument("--cards", action="store_true", help="with --mesh: one NCCL rank per card (DATA * MODEL cards), graphed and eager")
    ap.add_argument("--repeats", type=int, default=5, help="with --mesh: timed runs after the warm run")
    ap.add_argument("--runs", default="graphed,eager", help="with --mesh --cards: the launches in order, each graphed or eager")
    ap.add_argument("--timeout", type=float, default=900.0, help="with --mesh: each launch's time limit in seconds")
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
        shape = tuple(int(x) for x in args.mesh.split(","))
        runs = args.runs.split(",") if args.cards else ["eager" if args.eager else "graphed"]
        if not set(runs) <= {"graphed", "eager"}:
            ap.error(f"--runs: each launch is graphed or eager, not {args.runs}")
        return profile_mesh(cfg, dev, card, shape, args.frames, args.ba, args.cards, runs, args.repeats, args.timeout)
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
        cuda_lib.LAUNCHES.reset()
        fn()
        hand = dict(cuda_lib.LAUNCHES)
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


def mesh_rank(mesh, device, frames_path: str, gt_poses, use_ba: bool, graph, repeats: int):
    """One rank of ``--mesh``: a warm run, ``repeats`` untraced runs and one traced run, over the whole feed
    graphed and its first EAGER_TRACE_FRAMES frames eager (every rank runs all of them: a rank that
    skipped a run holding a collective would leave its peers waiting). The result and the refiner's
    figures are the last untraced run's."""
    import tempfile

    from chip_smoke import ArrayFeed, launched_by

    from vo_tpu_torch.dist import mesh as mesh_mod
    from vo_tpu_torch.io import kitti
    from vo_tpu_torch.utils import graphs

    calib = kitti.load_stereo_calib(os.path.join(synthetic.DEFAULT_KITTI_ROOT, "00"))
    seq = ArrayFeed(frames_path, calib, gt_poses)
    n = len(seq)
    feed = runner.StagedSequence(seq, n, device)
    cfg = PipelineConfig()
    # Each capture's seconds (warm-up run, capture, instantiation) and the bytes of every graph pool after it.
    captures, pool_bytes = [], [0]
    capture = graphs.capture

    def timed_capture(*a, **k):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        c = capture(*a, **k)
        torch.cuda.synchronize(device)
        captures.append(time.perf_counter() - t)
        pool_bytes[0] = max(pool_bytes[0], graphs.pools_bytes())
        return c

    graphs.capture = timed_capture

    def run(warmup=True, n_frames=None):
        return runner.run_sequence(feed, cfg, n_frames=n_frames, mesh=mesh, device=device, use_ba=use_ba, warmup=warmup,
                                   graph=graph)

    run()  # warm
    timed = [run() for _ in range(repeats)]
    ms = sorted(r.per_frame_ms for r in timed)
    res = timed[-1]
    n_traced = n if graph is None else min(n, EAGER_TRACE_FRAMES)
    mesh_mod.COLLECTIVES.reset()
    with tempfile.TemporaryDirectory() as tmp:
        # Which host call launched each NCCL kernel, read from the chrome trace of a graphed run (an
        # eager run's trace, thousands of launches a frame, is not written).
        trace = os.path.join(tmp, "trace.json") if graph is None else None
        _, loop = frame_loop_trace(lambda: run(warmup=False, n_frames=n_traced), n_traced, trace)
        nccl_launched_by = {} if trace is None else {
            k[:80]: sorted(v) for k, v in launched_by(trace).items() if "nccl" in k.lower()}
    by_name = loop.pop("kernel_ms_per_frame")
    busy = loop["device_busy_ms_per_frame"]
    median = ms[len(ms) // 2]
    return dict(
        rank=torch.distributed.get_rank(),
        device=str(device),
        mesh=mesh_mod.mesh_shape(mesh),
        backend=torch.distributed.get_backend(),
        frames=n,
        traced_frames=n_traced,
        use_ba=use_ba,
        graphed=graph is None,
        wall_ms_per_frame_runs=ms,
        wall_ms_per_frame=median,
        wall_ms_per_frame_spread=ms[-1] - ms[0],
        device_idle_share=1.0 - busy / median,
        **loop,
        collectives=dict(mesh_mod.COLLECTIVES),
        collectives_per_frame=sum(mesh_mod.COLLECTIVES.values()) / n_traced,
        nccl_device_ms_per_frame=sum(v for k, v in by_name.items() if "nccl" in k.lower()),
        nccl_kernels_launched_by=nccl_launched_by,
        copies_device_ms_per_frame=sum(v for k, v in by_name.items() if "memcpy" in k.lower()),
        capture_s=captures,
        pool_bytes=pool_bytes[0],
        refine_stats={k: v for k, v in res.refine_stats.items() if k in ("n_keyframes", "ba_solves", "main_wait_s")},
        result={k: getattr(res, k) for k in ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")},
    )


def profile_mesh(cfg: PipelineConfig, dev, card: str, shape, n: int, use_ba: bool, cards: bool, runs: list, repeats: int,
                 timeout: float) -> int:
    """``--mesh``: the ranks share the card over gloo, or (``cards``) each has a card of its own (NCCL);
    ``runs`` names the launches, graphed or eager (``graph=False``), whose results must all be equal."""
    import tempfile

    from chip_smoke import MESH_POSE_TOL_M, OUT_FRAMES, REFINED_ATE_SLACK_M, OutAndBackFeed, save_frames

    from vo_tpu_torch.dist import mesh as mesh_mod
    from vo_tpu_torch.eval import metrics

    world = shape[0] * shape[1]
    if cards and torch.cuda.device_count() < world:
        print(f"profile_torch_step: --mesh {shape[0]},{shape[1]} --cards needs {world} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if use_ba:  # the refined feed: the 199-frame out-and-back
        feed = OutAndBackFeed(OUT_FRAMES, dev)
        gt = feed.gt_poses
    else:
        seq = synthetic.kitti_synthetic_sequence(n_frames=n, n_landmarks=6000, seed=0)
        feed, gt = runner.StagedSequence(seq, n, dev), np.asarray(seq.gt_poses)
    n = len(feed)
    kw = dict(device=dev, use_ba=use_ba)
    one_cfg = dataclasses.replace(cfg, fused_group=1)  # the mesh steps frame by frame: compare like with like
    runner.run_sequence(feed, one_cfg, **kw)  # warm
    singles = [runner.run_sequence(feed, one_cfg, **kw) for _ in range(repeats)]
    single = sorted(r.per_frame_ms for r in singles)
    devices = [torch.device("cuda", i) for i in range(world)] if cards else dev
    backend = None if cards else "gloo"
    summary = dict(card=card, cards=world if cards else 1, frames=n, use_ba=use_ba,
                   single_process_frame_by_frame_ms_per_frame_runs=single, runs={})
    if use_ba:
        # Beside the meshed BA run: the one-card refined run (BA and loop closure) and plain VO on the same feed.
        refined = [runner.run_sequence(feed, cfg, device=dev, use_ba=True, use_loop_closure=True) for _ in range(repeats + 1)][1:]
        plain = runner.run_sequence(feed, one_cfg, device=dev)
        summary["single_process_refined_ms_per_frame_runs"] = sorted(r.per_frame_ms for r in refined)
        summary["ate_rmse_m"] = dict(single_process_ba=metrics.ate(singles[-1].poses, gt)["rmse"],
                                     single_process_refined=metrics.ate(refined[-1].poses, gt)["rmse"],
                                     single_process_plain=metrics.ate(plain.poses, gt)["rmse"])
    fields = ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")
    first = None  # rank 0's result of the first run: every rank of every run must equal it
    os.makedirs("chiprun_out", exist_ok=True)
    out = f"profile_torch_step_mesh_{shape[0]}x{shape[1]}" + ("_ba" if use_ba else "") + ("_cards" if cards else "") + ".json"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        save_frames(feed, n, path)
        # Each run's figures are printed and written as they land: a later run that fails or hangs
        # (its launch's time limit names the rank) leaves the earlier ones.
        for j, kind in enumerate(runs):
            g = None if kind == "graphed" else False
            name = kind if runs.index(kind) == j else f"{kind}_{runs[: j + 1].count(kind)}"
            per_rank = mesh_mod.launch(mesh_rank, shape, devices, backend=backend, args=(path, gt, use_ba, g, repeats),
                                       timeout=timeout, threads=2)
            first = per_rank[0]["result"] if first is None else first
            for r in per_rank:
                print(
                    f"mesh {r['mesh']} over {r['backend']}, rank {r['rank']} on {r['device']} ({summary['cards']} card(s)), "
                    f"{name}, {n} frames" + (", window BA" if use_ba else "") + f": {r['wall_ms_per_frame']:.3f} ms/frame "
                    f"(median of {repeats}, spread {r['wall_ms_per_frame_spread']:.3f}; single process frame by frame on one "
                    f"card {single[len(single) // 2]:.3f}); traced over {r['traced_frames']} frames: device busy "
                    f"{r['device_busy_ms_per_frame']:.3f} ms/frame, idle "
                    f"share {r['device_idle_share']:.3f}; host launches/frame {r['host_launches_per_frame']:.1f} "
                    f"{r['host_launches_per_frame_by_thread']}; collectives/frame {r['collectives_per_frame']:.2f} "
                    f"{r['collectives']}; NCCL device ms/frame {r['nccl_device_ms_per_frame']:.4f}, its kernels launched by "
                    f"{r['nccl_kernels_launched_by']}; captures {len(r['capture_s'])} ({sum(r['capture_s']):.3f} s), pool "
                    f"bytes {r['pool_bytes']}; refine_stats {r['refine_stats']}"
                )
                got = r.pop("result")
                r["equal_to_the_first"] = all(np.array_equal(got[k], first[k]) for k in fields)
            summary["runs"][name] = per_rank
            summary["ranks_and_runs_bit_equal"] = all(r["equal_to_the_first"] for v in summary["runs"].values() for r in v)
            if use_ba and j == 0:
                # Rank 0 against the one-card run with the same options, and the BA mesh's ATE against plain VO's.
                ate = summary["ate_rmse_m"]
                ate["mesh_rank0"] = metrics.ate(first["poses"], gt)["rmse"]
                d = float(np.linalg.norm(first["poses"][:, :3, 3] - singles[-1].poses[:, :3, 3], axis=1).max())
                summary["mesh_rank0_max_dt_to_single_process_m"] = d
                summary["within_bounds"] = d < MESH_POSE_TOL_M and ate["mesh_rank0"] <= ate["single_process_plain"] + REFINED_ATE_SLACK_M
                refined_ms = summary["single_process_refined_ms_per_frame_runs"]
                print(f"rank 0 against the one-card BA run: max |dt| {d:.3e} m (bound {MESH_POSE_TOL_M}); ATE rmse {ate} m "
                      f"(the mesh's bound: plain + {REFINED_ATE_SLACK_M}); within bounds: {summary['within_bounds']}; one-card "
                      f"refined (BA and loop closure) {refined_ms[len(refined_ms) // 2]:.3f} ms/frame (median of {repeats})")
            print(f"every rank's result so far ({', '.join(summary['runs'])}) equal bit for bit: "
                  f"{summary['ranks_and_runs_bit_equal']}")
            with open(os.path.join("chiprun_out", out), "w") as f:
                json.dump(summary, f, indent=1)
    return 0 if summary["ranks_and_runs_bit_equal"] and summary.get("within_bounds", True) else 1


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
        f"{loop['host_launches_per_frame']:.1f} host launches/frame (both threads) {loop['host_launch_calls_per_frame']}, "
        f"by thread {loop['host_launches_per_frame_by_thread']}, worker after the loop {loop['worker_host_launches_after_loop']}"
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
