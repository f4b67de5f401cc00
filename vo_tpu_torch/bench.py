"""Headline benchmark: end-to-end VO frames/s on KITTI-resolution stereo (port of the root ``bench.py``).

    python -m vo_tpu_torch bench [--repeats 5] [--stages] [--precision float32|default] [--eager] [--cpu]
    python bench_torch.py ...            (the same, from the repo's root)

Runs ``odometry.runner.run_sequence`` at the default ``PipelineConfig`` (full
width, 376x1241, ``fused_group`` 2) over the synthetic KITTI-00 feed (the
committed calib and GT poses, rendered textures, 30 frames, 6000 landmarks,
seed 0) staged on the device as uint8, on the current CUDA card unless
``--cpu`` is given. On the card each step is a captured CUDA graph
(utils.graphs); ``--eager`` runs the eager step (``graph=False``) (no card and no ``--cpu``: the ``RuntimeError`` of
``utils.device.default_device``). One warm run, then ``--repeats`` timed runs;
then the sustained pass, one timed run over ``--sustained-frames`` fresh
frames (KITTI-00 GT poses 0..N-1, 9000 landmarks, through the
``preload_cached`` cache), which the reference skips where its dataset is
missing and the port runs from the committed poses. Prints ONE JSON line:

  metric, value (median frames/s of the timed runs), unit, vs_baseline,
  vs_realtime (against the 9.6 Hz KITTI camera), sustained_fps,
  sustained_frames, cpu_baseline_fps, ate_rmse_m, n_frames, per_frame_ms
  (median) -- the reference's keys; and the port's:
  per_frame_ms_runs (every timed run), per_frame_ms_min, per_frame_ms_max,
  sustained_ate_rmse_m, pose_ok_frac, matmul_precision, graphed (whether the
  steps ran as CUDA graphs), device, device_kind, power_limit_w
  (``nvidia-smi``; null where there is none).

``--stages`` prints a second line, ``{"stage_breakdown": {...}}``: the
reference's four stages called apart on frame 1 (``stage_breakdown``).

The precision is ``cfg.matmul_precision`` (``--precision``), applied by the
runner (``utils.precision``); nothing here sets the TF32 flags.

``cpu_baseline_fps`` and ``vs_baseline`` are the reference's: where
``CPU_BASELINE_TORCH.json`` (``tools/measure_cpu_baseline_torch.py``: the same
pipeline on the CPU) is at the repo's root, its ``cpu_fps`` and ``value`` over
it; without the file null and ``value / CAMERA_HZ``, as the reference falls
back. The reference's ``CPU_BASELINE.json`` (a JAX figure) is never read.

Keys of the reference with no counterpart here: ``est_flops_per_frame``,
``achieved_tflops`` and ``est_mfu_bf16_peak`` (``_step_flops`` reads XLA's
cost analysis of one compiled step, and ``_PEAK_FLOPS`` holds TPU peaks);
``hbm_staged_feed`` (the feed is always staged: ``stage_frames``).

``--image-size``, ``--max-keypoints`` and ``--hypotheses`` shrink the run for
tests on the CPU; the benchmark's figures use none of them.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from .utils.device import sync
from .utils.profiling import union_ms

CAMERA_HZ = 9.6  # KITTI capture rate (kitti/00/times.txt): the real-time bound
N_FRAMES = 30
N_LANDMARKS = 6000
SUSTAINED_FRAMES = 200
SUSTAINED_LANDMARKS = 9000
REPEATS = 5
STAGE_ITERS = 20
PROFILE_GAP_S = 0.05  # idle gap between the profiled calls of a stage
PROFILE_SESSIONS = 3  # profiler sessions a stage gets for its two counted calls to agree
# record_function names of a session's four calls: the middle two are counted
_MARKS = ("vo_stage_first", "vo_stage_counted_a", "vo_stage_counted_b", "vo_stage_last")
CPU_BASELINE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "CPU_BASELINE_TORCH.json")


def _q(img) -> np.ndarray:
    """A frame as uint8 (floats in [0, 1] quantized as the camera and the PNG loader give them)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return a


class Preloaded:
    """Pre-rendered uint8 frames, so a timed loop measures the pipeline, not host rasterization."""

    def __init__(self, seq, n: int):
        self.calib = seq.calib
        self.gt_poses = seq.gt_poses
        self.frames = [tuple(_q(im) for im in seq.frame(i)) for i in range(n)]

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int):
        return self.frames[i]


def _render_rows(calib, poses, n_landmarks: int, seed: int, image_size, noise: float, rows) -> list:
    """Frames ``rows`` of a synthetic sequence, quantized (one worker's share of ``preload_cached``)."""
    from .io import synthetic

    seq = synthetic.SyntheticSequence(calib, poses, n_landmarks=n_landmarks, seed=seed, image_size=image_size, noise=noise)
    return [tuple(_q(im) for im in seq.frame(i)) for i in rows]


def cache_path(
    n_frames: int, n_landmarks: int, seed: int = 0, image_size=None, noise: float = 0.0, cache_dir: str | None = None
) -> str:
    """The file ``preload_cached`` reads and writes for a render (the reference's name, in
    ``cache_dir``; default: the temporary directory). The name does not encode the poses."""
    sz = "" if image_size is None else f"_{image_size[0]}x{image_size[1]}"
    nz = "" if noise == 0.0 else f"_n{noise:g}"
    cache_dir = tempfile.gettempdir() if cache_dir is None else cache_dir
    return os.path.join(cache_dir, f"longrun_frames_v4_{n_frames}_{n_landmarks}_{seed}{sz}{nz}.npz")


def add_noise(frames: list, extra_noise: float, seed: int = 0) -> list:
    """Deterministic load-time sensor noise on uint8 (left, right) pairs, in place: Gaussian of
    stddev ``extra_noise`` (in [0, 1] units) from ``np.random.default_rng((seed, i, 2|3))`` for
    frame ``i``'s left and right image, clipped and rounded back to uint8 (the reference's streams)."""
    if extra_noise <= 0.0:
        return frames
    s = 255.0 * extra_noise
    for i, (l, r) in enumerate(frames):
        rl = np.random.default_rng((seed, i, 2))
        rr = np.random.default_rng((seed, i, 3))
        ln = np.clip(l.astype(np.float32) + rl.normal(0.0, s, l.shape), 0.0, 255.0)
        rn = np.clip(r.astype(np.float32) + rr.normal(0.0, s, r.shape), 0.0, 255.0)
        frames[i] = ((ln + 0.5).astype(np.uint8), (rn + 0.5).astype(np.uint8))
    return frames


def preload_cached(
    calib, poses, n_frames: int, n_landmarks: int, seed: int = 0, image_size=None,
    noise: float = 0.0, extra_noise: float = 0.0, cache_dir: str | None = None, workers: int = 1,
) -> Preloaded:
    """Render (or reload) a synthetic sequence, cached in ``cache_dir`` (default: the temporary
    directory, ``/tmp`` where the reference writes its cache, unless ``TMPDIR`` names another).

    The cache is the reference's: the same file name and keys (``l``, ``r``, ``poses``), so a file
    written by either package is read by the other. It stores the GT poses it was rendered with
    and is re-rendered when they differ. ``extra_noise`` adds deterministic Gaussian sensor noise
    on top of the frames at load time (``np.random.default_rng((seed, i, 2|3))``; the reference
    adds it only when the cache was already there, the port on a fresh render too). ``workers``
    renders strided slices of the frames in that many processes: the frames are the same.
    """
    from .io import synthetic

    seq = synthetic.SyntheticSequence(calib, poses, n_landmarks=n_landmarks, seed=seed, image_size=image_size, noise=noise)
    cache = cache_path(n_frames, n_landmarks, seed, image_size, noise, cache_dir)
    cache_dir = os.path.dirname(cache)

    pre = Preloaded.__new__(Preloaded)
    pre.calib, pre.gt_poses = seq.calib, seq.gt_poses
    if os.path.exists(cache):
        z = np.load(cache)
        if "poses" in z and z["poses"].shape == poses.shape and np.allclose(z["poses"], poses):
            # Each npz member is read once: every z["l"] loads a fresh full copy.
            L, R = z["l"], z["r"]
            pre.frames = add_noise([(L[i], R[i]) for i in range(n_frames)], extra_noise, seed)
            return pre
    t0 = time.perf_counter()
    if workers <= 1:
        pre.frames = Preloaded(seq, n_frames).frames
    else:
        # Spawned, not forked: the caller may already hold a CUDA context.
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            shares = list(pool.map(
                _render_rows, *zip(*[(calib, poses, n_landmarks, seed, image_size, noise, range(k, n_frames, workers))
                                     for k in range(workers)])
            ))
        pre.frames = [shares[i % workers][i // workers] for i in range(n_frames)]
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(cache, l=np.stack([f[0] for f in pre.frames]), r=np.stack([f[1] for f in pre.frames]), poses=poses)
    print(f"# rendered {n_frames} frames in {time.perf_counter() - t0:.1f}s", flush=True)
    add_noise(pre.frames, extra_noise, seed)
    return pre


def stage_frames(pre, device):
    """``pre``'s frames staged on ``device`` as uint8 (runner.StagedSequence), outside every timed loop."""
    from .odometry.runner import StagedSequence

    return StagedSequence(pre, len(pre), device)


def _time_stage(fn, device: torch.device, n_iter: int):
    """One warm call, then ``n_iter`` calls, each ended by a synchronise -> (medians {wall, enqueue,
    device (CUDA events) ms}, device busy ms and launches of one call under torch.profiler, last output)."""
    cuda = device.type == "cuda"
    out = fn()
    sync(device)
    wall, enq, dev = [], [], []
    for _ in range(n_iter):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        if cuda:
            b.record()
        sync(device)
        t2 = time.perf_counter()
        wall.append(1e3 * (t2 - t0))
        enq.append(1e3 * (t1 - t0))
        if cuda:
            dev.append(a.elapsed_time(b))
    busy, launches = _profile_call(fn, device) if cuda else (None, None)
    med = lambda v: float(np.median(v)) if v else None  # noqa: E731
    return dict(ms=med(wall), enqueue_ms=med(enq), device_ms=med(dev), busy_ms=busy, launches=launches), out


def _device_events_in(events, mark: str):
    """(device busy ms, kernel/copy launches) of the device events inside ``mark``'s span (a
    ``record_function`` range, widened by half a gap) among the profiler's ``events``."""
    # The range is recorded on the host and, as a user annotation, on the device timeline too.
    spans = [e.time_range for e in events if e.name == mark]
    half_gap_us = 5e5 * PROFILE_GAP_S
    lo, hi = min(r.start for r in spans) - half_gap_us, max(r.end for r in spans) + half_gap_us
    evs = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in _MARKS
           and lo <= e.time_range.start <= hi]
    return union_ms(evs), len(evs)


def _profile_call(fn, device: torch.device):
    """(device busy ms, kernel/copy launches) of one call of ``fn`` under torch.profiler.

    A session can leave launches unrecorded (seen on an H100 late in ``chip_smoke.py``'s process:
    at a session's start or end, 18-20 of a call's launches, once all 62). So a session runs four
    calls, each followed by a synchronise and an idle gap, and counts the two middle calls apart.
    A count stands only where both agree; after ``PROFILE_SESSIONS`` sessions without agreement
    this raises rather than report a count that may have lost launches.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    counts = []
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for mark in _MARKS:
                with record_function(mark):
                    fn()
                    sync(device)
                time.sleep(PROFILE_GAP_S)
        events = prof.events()
        (busy, a), (_, b) = (_device_events_in(events, mark) for mark in _MARKS[1:3])
        if a == b:
            return busy, a
        counts.append((a, b))
    raise RuntimeError(f"torch.profiler lost launches: the two counted calls of each session gave {counts}")


def stage_breakdown(pre, cfg, device=None, n_iter: int = STAGE_ITERS) -> dict:
    """The reference's four stages called apart on frame 1 of ``pre``, at ``cfg.matmul_precision``.

    detect + describe of the stereo pair (ONE call on 2 images), ``stereo_features_with_matches``,
    ``track`` (frame 1 against its own stereo features) and triangulate + RANSAC (triples drawn from
    a generator seeded 0 at every call, as the reference passes ``PRNGKey(0)``). Per stage:
    ``<stage>_ms`` wall per call to a synchronise, median of ``n_iter`` after one warm call (the
    reference's figure); ``_enqueue_ms`` until the call returns; ``_device_ms`` between CUDA events
    around the call (the host's time where it enqueues slower than the card runs); ``_busy_ms`` and
    ``_launches``, the device's busy time and kernel/copy launches of one call under
    ``torch.profiler``, held to a second call's count (``_profile_call``). The last three are null
    on the CPU. Stages called apart add their own dispatch; in the step they follow one another on
    one stream.
    """
    from .frontend.sift import detect_and_describe
    from .frontend.track import stereo_features_with_matches, track
    from .geom.triangulate import triangulate_rectified
    from .pose.ransac import estimate_world_pose
    from .utils import graphs
    from .utils.device import resolve
    from .utils.padding import gather_rows
    from .utils.precision import matmul_precision
    from .odometry.runner import to_device

    device = resolve(device)
    calib = pre.calib.to(device)
    imgs = torch.stack([to_device(im, device) for im in pre.frame(1)]).float() / 255.0
    gen = torch.Generator(device=device)
    stages = {}
    with matmul_precision(cfg.matmul_precision):
        stages["detect_describe_x2"], feats = _time_stage(lambda: detect_and_describe(imgs, cfg.sift), device, n_iter)
        fl, fr = (type(feats)(*(x[j] for x in feats)) for j in (0, 1))
        stages["stereo_match"], (stereo, _) = _time_stage(
            lambda: stereo_features_with_matches(fl, fr, cfg.matcher, cfg.max_tracks), device, n_iter
        )
        stages["temporal_track"], tr = _time_stage(lambda: track(stereo, fl, fr, cfg.matcher, cfg.max_tracks), device, n_iter)

        def pose_stage():
            cur_l_px = gather_rows(fl.xy, tr.cur_l_idx, tr.mask)
            old_l_px = gather_rows(stereo.l_xy, tr.old_row, tr.mask)
            old_r_px = gather_rows(stereo.r_xy, tr.old_row, tr.mask)
            X_prev = triangulate_rectified(old_l_px, old_r_px, calib)
            mask = tr.mask & (X_prev[:, 2] > 0.1) & (X_prev[:, 2] < 400.0)
            gen.manual_seed(0)
            return estimate_world_pose(cur_l_px, X_prev, mask, calib, cfg.ransac, gen=gen)

        stages["triangulate_ransac"], _ = _time_stage(pose_stage, device, n_iter)
    out = {f"{name}_{k}": v for name, st in stages.items() for k, v in st.items()}
    out["sum_ms"] = sum(st["ms"] for st in stages.values())
    out["note"] = "stages called apart, each ended by a synchronise; the step runs them back to back on one stream"
    return out


def load_cpu_baseline() -> dict | None:
    """``CPU_BASELINE_PATH``'s payload (tools/measure_cpu_baseline_torch.py), or None where it is missing."""
    if os.path.exists(CPU_BASELINE_PATH):
        with open(CPU_BASELINE_PATH) as f:
            return json.load(f)
    return None


def power_limit_w(device: torch.device):
    """The card's power limit in W as ``nvidia-smi`` reports it; None on the CPU or without nvidia-smi."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60,
        )
        return float(out.stdout.split()[0]) if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vo_tpu_torch bench", description="end-to-end VO frames/s; prints one JSON line")
    ap.add_argument("--stages", action="store_true", help="print the per-stage breakdown too")
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument(
        "--sustained-frames", type=int, default=SUSTAINED_FRAMES,
        help="fresh (non-repeated) frames for the sustained-fps pass; 0 disables",
    )
    ap.add_argument("--repeats", type=int, default=REPEATS, help="timed runs after the warm run (median reported)")
    ap.add_argument("--precision", choices=("default", "float32"), default=None, help="cfg.matmul_precision (utils.precision)")
    ap.add_argument("--eager", action="store_true", help="run the eager step, not the captured CUDA graphs")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    ap.add_argument("--image-size", default=None, metavar="H,W", help="render the feeds at H,W (CPU tests)")
    ap.add_argument("--max-keypoints", type=int, default=None, help="SIFT capacity (CPU tests)")
    ap.add_argument("--hypotheses", type=int, default=None, help="RANSAC hypotheses (CPU tests)")
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")

    from .config import PipelineConfig
    from .eval import metrics
    from .io import kitti, synthetic
    from .odometry import runner
    from .utils import graphs
    from .utils.device import resolve

    device = resolve("cpu" if args.cpu else None)  # the card unless --cpu; never the CPU unasked
    size = tuple(int(x) for x in args.image_size.split(",")) if args.image_size else None
    cfg = PipelineConfig()
    if args.max_keypoints:
        cfg = dataclasses.replace(cfg, sift=dataclasses.replace(cfg.sift, max_keypoints=args.max_keypoints))
    if args.hypotheses:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac, n_hypotheses=args.hypotheses))
    if args.precision:
        cfg = dataclasses.replace(cfg, matmul_precision=args.precision)

    n = args.frames
    seq = synthetic.kitti_synthetic_sequence(n_frames=n, n_landmarks=N_LANDMARKS, seed=0, image_size=size)
    pre = Preloaded(seq, n)
    feed = stage_frames(pre, device)
    gt = np.asarray(seq.gt_poses)
    graph = False if args.eager else None
    # Warm run: first-use costs (kernel build, library handles, allocator growth) land here.
    runner.run_sequence(feed, cfg, n_frames=n, device=device, graph=graph)
    runs = [runner.run_sequence(feed, cfg, n_frames=n, device=device, graph=graph) for _ in range(args.repeats)]
    res = runs[0]
    ms = [r.per_frame_ms for r in runs]
    fps = float(np.median([r.frames_per_sec for r in runs]))

    sustained = sustained_ate = None
    if args.sustained_frames:
        root = synthetic.DEFAULT_KITTI_ROOT
        gt_s = kitti.read_poses(os.path.join(root, "poses", "00.txt"))[: args.sustained_frames]
        pre_s = preload_cached(
            kitti.load_stereo_calib(os.path.join(root, "00")), gt_s, args.sustained_frames, SUSTAINED_LANDMARKS,
            seed=0, image_size=size, workers=min(8, os.cpu_count() or 1),
        )
        res_s = runner.run_sequence(stage_frames(pre_s, device), cfg, n_frames=args.sustained_frames, device=device, graph=graph)
        sustained = res_s.frames_per_sec
        sustained_ate = metrics.ate(res_s.poses, gt_s)["rmse"]

    cpu_base = load_cpu_baseline()
    out = {
        "metric": "frames_per_sec",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / cpu_base["cpu_fps"] if cpu_base else fps / CAMERA_HZ,
        "vs_realtime": fps / CAMERA_HZ,
        "sustained_fps": sustained,
        "sustained_frames": args.sustained_frames or None,
        "cpu_baseline_fps": cpu_base["cpu_fps"] if cpu_base else None,
        "ate_rmse_m": metrics.ate(res.poses, gt)["rmse"],
        "n_frames": n,
        "per_frame_ms": float(np.median(ms)),
        "per_frame_ms_runs": ms,
        "per_frame_ms_min": min(ms),
        "per_frame_ms_max": max(ms),
        "sustained_ate_rmse_m": sustained_ate,
        "pose_ok_frac": float(res.pose_ok.mean()) if res.pose_ok.size else None,
        "matmul_precision": cfg.matmul_precision,
        "graphed": graphs.wanted(graph, device),
        "device": device.type,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "power_limit_w": power_limit_w(device),
    }
    print(json.dumps(out), flush=True)
    if args.stages:
        print(json.dumps({"stage_breakdown": stage_breakdown(pre, cfg, device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
