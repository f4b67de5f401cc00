#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (vo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Every run_sequence call below steps through CUDA graphs (utils.graphs: the
factories of odometry.pipeline, captured in each run's warm-up), and on the
refined path also solves, verifies, associates and describes through them
(the refiner's window solve and verification round, the keyframe association
and global descriptor, captured in the refiner's warm-up), except where
``graph=False`` is named. Under a mesh each rank captures its own: over NCCL
(phase 11) the sharded entry points and the step, their collectives inside
the graph; over gloo (phase 12) the step and the sharded solve stay eager by
rule and the programs without a collective are graphs.

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the card's name and power limit (needs CUDA);
  2. build the hand-written kernels from vo_tpu_torch/csrc with nvcc;
  3. K1 (extrema_scores) and K2 (bin_maps) against their plain PyTorch versions
     on the pyramids of rendered full-size frames, at the shapes the driven
     paths give them, for every detection batch: 1 image (what a rank of a
     mesh with a "data" axis of 2 detects: phase 12), 2 images (one frame's
     left and right: the refined, resumed and per-frame host paths step frame
     by frame) and 4 images (one group of the deferred plain path, and the
     exact-SIFT call). Octave by octave (K1 must be exact, K2 within 1e-5,
     reading the level slice G[:, 1:4] in place), then the whole detection
     call in one launch per kernel, which must equal the per-octave results
     bit for bit. At 4 images the one-launch call is timed with a 1 GiB
     buffer cleared before each launch (inputs cold in L2; the events are queued while the clear still runs, so
     the reading is the kernel's and not the host's launch latency), median
     of 25; the same way octave 0 alone, the four per-octave launches, and a
     device copy that moves the kernel's bytes (what the memory system gives a
     plain copy of that size). 20 launches back to back between one pair of
     events are reported too: where the host needs longer to enqueue a launch
     than the card to run it, that reading is the host's. Each kernel's bound
     is the larger of its bytes (inputs read once, outputs written once) over
     3.35 TB/s and its float operations over 67 TFLOP/s. Then K3 (pose_refine,
     RANSAC-P3P's consensus refinement) against its plain version at the main
     path's shapes (cfg.max_tracks correspondences, the winner of
     cfg.ransac.n_hypotheses hypotheses): ok and n_inliers equal, the pose
     within 3e-5 m and 1.5e-6 rad, two launches bit-equal and counted; its time
     (the clear before each launch as above, median of 25) beside the plain
     version's, eager and as a replayed CUDA graph, and beside the latency floor
     that bounds it: a one-thread launch (the tracer's stage stamp) timed the
     same way. Then K4 (gauss_blur, the detector's separable blurs) against the
     band products on the card at every detection batch (1, 2, 4 images): the
     whole pyramid, each octave's levels and DoG from the same base, and the
     bin-map rows of every level from the same maps, within 2e-7 (the largest
     difference and the count of values that differ printed); at 4 images the
     detection call's blurs (the base, one launch per octave, the map rows:
     2 + octaves launches) timed as K1 and K2 are, beside their bound (bytes:
     each source sample read once, every level, DoG and map row written once;
     two operations a tap) and the band products' time;
  4. the plain-VO main path, odometry.runner.run_sequence, over the 30-frame
     synthetic KITTI-00 feed at the default PipelineConfig: one warm run, then
     a timed run with the kernels' launch counters reset just before it. Fails
     on ATE > 0.05 m, fewer than 28 of 29 pose_ok, a non-finite pose or a
     kernel that the run never launched;
  5. the refined path, run_sequence(use_ba=True, use_loop_closure=True), at the
     default PipelineConfig over a 199-frame out-and-back feed (KITTI-00 GT
     poses 0..99 then 98..0, 376x1241, 6000 landmarks, seed 0, noise 0): plain
     VO once, then the refined path once, timed, with the launch counters
     reset (the refiner's own warm-ups run before its timed loop). Fails on a non-finite pose, a wrong pose count, keyframes
     != 39, no window solve, no verified loop candidate, refined ATE > plain
     ATE + 0.02 m, plain ATE > 0.15 m, or a kernel the timed run never launched,
     on step rows (``step_poses``) missing or not chaining, and on refiner
     records (``refine_log``) missing or fewer or more than ``refine_stats``
     counts (checked again on phase 15's eager refined run);
     and unless each of the refined path's four programs (``window_solve``,
     ``verification_round``, ``global_descriptor``, ``keyframe_association``:
     ``graphs.PROGRAMS``, set to 0 just before the run) was captured once per
     shape and replayed in the run (the association and the descriptor once
     per keyframe, the solve at least once per accepted solve), printed per
     program;
  6. a loop closure that fires on the card: every 5th frame of the phase-5 feed
     from frame 5 on, detected and stereo-matched on the card, archived in a
     default-config LoopCloser with its GT pose drifted +0.1 m in x per
     keyframe. Fails unless a closure fires and the newest keyframe of the loop
     ends closer to its GT pose than half its drifted error;
  7. resume on the card. On the phase-5 feed: an uninterrupted refined run on
     the non-deferred path (``progress`` given) against phase 5's refined run
     tells whether the card repeats a run bit for bit (the refined path steps
     frame by frame either way; a host read per frame must change nothing);
     then a run to frame 100 with a checkpoint there and a
     resumed run to 199. Where the card repeats itself the resumed run must
     equal the uninterrupted one exactly (poses, n_inliers, pose_ok, keyframes,
     window solves, verified candidates); where it does not, within ten times
     the measured run-to-run difference, and both are printed. The checkpoint's
     bytes and the seconds ``save`` and ``load`` take are printed. The same for
     plain VO on the 30-frame feed (checkpoint at 15, two non-deferred
     uninterrupted runs);
  8. the per-frame host paths: the 30-frame feed with ``progress`` and
     ``metrics_path``. Fails unless there are 30 JSONL rows with the reference's
     keys, the callback's values equal the result's rows, and the poses equal
     those of the deferred single-frame run (exactly where the card repeats
     itself) and phase 4's grouped run within 1e-3. Prints fps beside both
     (the ratio is the cost of one host read per frame) and the percentiles of
     ``frame_ms``, which include that wait; then ``utils.debug`` on the card:
     the launches per frame of a short deferred run (the replays and the
     capture's one eager warm-up run), a graphed run under ``nan_debug``, which
     must raise the ``ValueError`` that names ``graph=False``, and the same run
     with ``graph=False``, which must stay finite;
  9. the exact-SIFT oracle path (``fast_descriptor=False``): one detection call
     on phase 3's four images must launch K1 once and K2 never, return the fast
     path's keypoints (same masks, xy within 1e-4, one orientation each) and
     agree with the same call on the CPU (>= 95% of the keypoints shared within
     0.01 px and 0.01 rad, their descriptors within 2e-3); then the 30-frame run
     on that path (ATE <= 0.05 m, pose_ok >= 28/29), with fps and ms per detection
     call between CUDA events beside the fast path's (where the host needs
     longer to enqueue the call than the card to run it, that reading is the
     host's; tools/profile_torch_step.py --exact reads the device time);
 10. the shell surface, as subprocesses that pick the card themselves:
     ``python -m vo_tpu_torch run --synthetic --frames 12 --ba --loop-closure
     --checkpoint-every 8``, the same with ``--resume`` (steps frames 8-11) and
     ``eval`` on the result; a 10-frame KITTI directory (the committed calib,
     times.txt, 8-bit PNGs of rendered frames) through ``StereoSequence`` and
     ``run --data``, whose poses must equal the same frames fed from memory;
     and ``Undistorter`` on a staged frame against the CPU (1e-5; the identity
     model returns its input), its warp a CUDA graph (``undistort_warp``)
     equal to ``graph=False`` bit for bit. Figures are asserted only where
     matplotlib is installed. Also ``run --mesh 1,1`` (passes, in process) and ``run --mesh
     2,2`` (exits 2 and names the number of cards);
 11. the mesh over NCCL, one rank (NCCL refuses two ranks on one card): a
     world of one on the card, a (1, 1) mesh, and the four sharded entry points
     called directly (the runner skips them at axis size 1):
     ``estimate_world_pose_sharded``, ``solve_window_sharded``,
     ``optimize_sharded`` and ``detect_batch``. Each must equal its
     single-device function bit for bit, with its collectives real NCCL calls on
     the current stream, and under ``torch.cuda.set_sync_debug_mode("error")``
     none may make the host wait. Prints the collectives per call and the ms
     between CUDA events of each sharded call beside the unsharded one. Then
     each of the four captured as a ``graphs.StaticCall``: its replay equal to
     the eager sharded call bit for bit, the collectives each replay accounts
     equal to the eager call's and to what the capture recorded, no host wait
     in a replay, and in the profiler's trace of one replay no host launch but
     the one ``cudaGraphLaunch`` (and a registered generator's two fills before
     it), every kernel launched by it; capture seconds and ms per replay beside
     the eager call's. (NCCL runs a world of one without a kernel of its own;
     NCCL's kernels under ``cudaGraphLaunch`` are read with a card per rank,
     ``tools/profile_torch_step.py --mesh D,M --cards``.) Last, ``run_sequence`` over the
     30-frame feed on the (1, 1) NCCL mesh, its step captured, bit-equal to
     the single-process graphed run at ``fused_group=1`` (a mesh steps frame
     by frame; a 2-frame group's batched detection differs in the last bits);
 12. the mesh as four ranks that SHARE the card over gloo (dist.mesh.launch,
     ``backend="gloo"``: every collective is staged through pinned host memory):
     ``run_sequence(mesh=)`` on a (2, 2) mesh over the 30-frame feed at the
     default config, then on a (1, 2) mesh with ``use_ba=True`` over the first
     60 frames of the phase-5 feed. Fails unless every rank's result equals rank
     0's bit for bit, the meshed plain run is within 2e-2 m of phase 4's run
     with equal pose_ok and ATE within 0.02 m, K1 and K2 were launched on every
     rank at a detection batch of ONE image, and the BA run has the
     single-process run's keyframes and at least one accepted solve, captured
     and replayed its keyframe association on every rank (``graphs.PROGRAMS``:
     no collective in it, so a graph under gloo too, while the step and the
     sharded solve stay eager), and equals the same run with ``graph=False``
     bit for bit on every rank. Every rank records each collective it issues in
     the counted runs (the issuing thread, the mesh axis, the kind): every
     rank's list must equal rank 0's, and all of it must come from the frame
     loop's thread (odometry.refiner launches the sharded solves there). A
     rank that dies or hangs fails the phase with its stderr (and its threads'
     stacks). The ms per frame printed beside the single-process run's are the
     overhead of the integration on one shared card, not scaling.
 13. the benchmark surface, in process (so the launch counters see it):
     ``vo_tpu_torch.bench.main(["--repeats", "3", "--sustained-frames", "0",
     "--stages"])`` renders phase 4's feed anew and must print one JSON line with
     every key of the port's bench line and a second with the four-stage split;
     fails unless ATE <= 0.05 m and within 1e-6 m of phase 4's run (the same
     feed, config and precision), every stage time is finite, every stage
     launched on the card, and the bench launched K1 and K2. Then
     ``tools/longrun_torch.run_matrix`` over the first 40 frames of the phase-5
     feed: the four configurations (vo, vo_lc, vo_ba, vo_ba_lc) with finite
     metrics, and vo_ba and vo_ba_lc with the same keyframe count, 7, which no
     draw changes. The phase adds about a minute (its own render of 30 frames
     included) and prints the seconds of both halves;
 14. the reference-scale tools at a small scale: phase 5's feed written as a frame
     cache, loaded through ``tools/severity_sweep_torch.load_prefix`` with
     load-time extra noise 0.08 (the full run's feed severity), staged, and run
     through ``tools/bigrun_torch.run_configs`` for ``vo`` and ``vo_lc`` with a
     loop-closer capacity of 16 keyframes (``LoopConfig(max_keyframes=16)``), so
     the graph is decimated as the full run's is at 512. Fails unless ``vo_lc``
     archived 39 keyframes and decimated 3 times (the reference LoopCloser's count
     for 39 keyframes at capacity 16: tests/test_torch_bigrun.py), both runs have
     finite poses and metrics and pose_ok >= 0.95, and K1 and K2 were launched. A
     capacity at or under ``min_gap`` (20) leaves no keyframe old enough to be a
     candidate, so no loop can close here: the phase fails unless ``vo_lc``
     verified none and equals ``vo``'s ATE within 0.02 m (it steps frame by frame);
     the full run is where closures fire. Then the same decimating ``vo_lc`` run with
     ``graph=False`` (``bigrun_torch.run_one``) must equal the graphed one bit for bit
     (``require_bit_equal``, keyframes, decimations, verified candidates and closures, and
     ``bigrun_torch.first_difference`` finds nothing); ``tools/diag_ba_torch.py``'s hook over
     the first 60 frames of the phase-5 feed (graphed) must log a solve with cost <= cost0 and
     ``last_result.n_obs`` > 30; ``tools/diag_lc_torch.py``'s hook over phase 6's closure feed
     must log a closure that brings the keyframes nearer the truth. It prints the seconds the
     additions took;
 15. the captured steps against the eager ones: phase 4's 30-frame run and
     phase 5's 199-frame refined run (both graphed) against the same runs with
     ``graph=False``, bit for bit (poses, relative poses, n_inliers, n_tracks,
     pose_ok, landmarks; the refined keyframes (39), solves and verified
     candidates equal), ``make_jitted_step`` captured and eager frame by frame
     (track ids and poses), and phase 7's graphed resumes 0.0 m from the
     uninterrupted graphed runs. Then one replay of the group step: it must
     account one launch of K1 and K2, one of K3 a frame and one detection
     call's of K4 in ``kernels.LAUNCHES``, and in the profiler trace of two
     more replays K1-K4 must have been launched by ``cudaGraphLaunch``;
     it prints the solver kernels of RANSAC's 6x6 solve, the seconds of the
     first call of each step (warm-up, capture, instantiation, one replay) and
     the bytes of the graph pools; then, for a refiner and keyframe
     association built anew, each of the four programs' capture seconds and
     the bytes of its own pool. Last, per frame of the frame loop, graphed
     and eager: host launches (both threads, and apart for the main thread and
     the refiner's worker), device busy ms and launches, idle share, and on
     the refined path ``main_wait_s`` and the worker's dispatch seconds (the
     first 10 frames of the plain feed and the first 20 of the refined one;
     tools/profile_torch_step.frame_loop_trace);
The line before the last is a JSON summary of the kernels: ``launches`` summed
over the counted runs of phases 4, 5, 7, 8, 9, rank 0 of phase 12, 13, 14 (the graphed runs, the eager one and the two
diagnostics' runs) and 15's one replay (``launches_by_path`` has each;
the counters are reset just before each path and read just after), ``max_abs_err`` the largest of the three batches' (``max_abs_err_by_batch`` has
each), ``ms`` the one-launch detection call of 4 images with cold inputs, ``octave0_ms``, ``per_octave_launches_ms`` and
``copy_same_bytes_ms`` timed the same way, ``back_to_back_ms``, ``plain_ms``
the plain version over the four octaves, ``bound_ms`` / ``bound_by`` /
``share_of_bound`` (bound over ``ms``), ``launches_per_detect_call`` counted
over one detect_and_describe, and ``library_ms`` null: no single PyTorch call
computes either function; K3's row has its own fields (``ms``, ``back_to_back_ms``,
``plain_ms``, ``plain_graph_ms``, ``floor_ms``, the bounds, ``launches``), and so has K4's
(``ms``, ``pyramid_ms``, ``map_rows_ms``, ``plain_ms`` the band products, ``differ_by_batch``). The last line
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from vo_tpu_torch.ba import pose_graph, window
from vo_tpu_torch.config import MeshConfig, PipelineConfig
from vo_tpu_torch.dist import ba_sharded, frontend_batch, pose_graph_sharded, ransac_sharded
from vo_tpu_torch.dist import mesh as mesh_mod
from vo_tpu_torch.eval import metrics
from vo_tpu_torch.frontend import kernels
from vo_tpu_torch.frontend import dense_desc, pyramid
from vo_tpu_torch.frontend.pyramid import build_pyramid
from vo_tpu_torch.frontend.sift import detect_and_describe
from vo_tpu_torch.frontend.track import stereo_features_with_matches
from vo_tpu_torch.geom.triangulate import triangulate_rectified
from vo_tpu_torch.io import kitti, synthetic, undistort
from vo_tpu_torch.odometry import checkpoint, runner
from vo_tpu_torch.odometry.refiner import global_desc
from vo_tpu_torch.pose import ransac
from vo_tpu_torch.slam.loop_closure import ArchivedKeyframe, LoopCloser
from vo_tpu_torch.utils import debug, graphs, profiling
from vo_tpu_torch.utils.precision import matmul_precision

N_FRAMES = 30
N_LANDMARKS = 6000
REPS = 25
BACK_TO_BACK = 20
K2_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores, published peak
# Float operations per element, counted from the plain versions' formulas. K1, per output: 27 max
# and 27 min compares, |v|, two compares with the extrema, one with the threshold. K2, per pixel:
# gradients 4, magnitude 4, angle about 20 (a division, an odd polynomial of degree 15, octant
# fix-ups), bin coordinate and the two weights 8, accumulation into the pooled sums 4.
K1_FLOP_PER_OUTPUT = 58
K2_FLOP_PER_PIXEL = 40
# K3, per point: a projection and gate about 20, and per iteration the gate, Huber weight, Jacobian and
# its 27 products into H and g about 150 (counted from csrc/pose_refine.cu).
K3_FLOP_PER_POINT, K3_FLOP_PER_POINT_ITER = 60, 150
K3_T_TOL_M, K3_R_TOL_RAD = 3e-5, 1.5e-6  # tests/test_torch_pose_refine.py
ATE_MAX_M = 0.05
OUT_FRAMES = 100  # phase 5: GT poses 0..99 out, 98..0 back
PLAIN_ATE_MAX_M = 0.15
REFINED_ATE_SLACK_M = 0.02
DRIFT_PER_KF_M = 0.1  # phase 6
GROUPED_POSE_TOL = 1e-3  # phase 8: a 2-frame group's batched detection against single frames
EXACT_XY_TOL = 1e-4  # phase 9: exact against fast keypoints (tests/test_fast_frontend.py)
EXACT_CPU_XY, EXACT_CPU_ORI, EXACT_CPU_DESC, EXACT_CPU_SHARED = 1e-2, 1e-2, 2e-3, 0.95  # phase 9: card against CPU
UNDISTORT_TOL = 1e-5  # phase 10
MESH_POSE_TOL_M, MESH_ATE_TOL_M = 2e-2, 0.02  # phase 12: meshed against single-process
MESH_BA_FRAMES = 60  # phase 12: the first frames of the phase-5 feed, enough to solve windows
MESH_TIMEOUT_S = 300.0  # phase 12: a launched world still running after this long is killed
SUBPROCESS_TIMEOUT_S = 400
METRICS_KEYS = {"frame", "n_tracks", "n_inliers", "inlier_ratio", "pose_ok", "mean_reproj_err", "frame_ms"}
BENCH_KEYS = {  # phase 13: the port's bench line (vo_tpu_torch/bench.py)
    "metric", "value", "unit", "vs_baseline", "vs_realtime", "sustained_fps", "sustained_frames", "cpu_baseline_fps",
    "ate_rmse_m", "n_frames", "per_frame_ms", "device", "device_kind", "per_frame_ms_runs", "per_frame_ms_min",
    "per_frame_ms_max", "sustained_ate_rmse_m", "pose_ok_frac", "matmul_precision", "power_limit_w", "graphed",
}
BENCH_STAGES = ("detect_describe_x2", "stereo_match", "temporal_track", "triangulate_ransac")
BENCH_ATE_TOL_M = 1e-6  # phase 13: the bench's run against phase 4's
LONGRUN_FRAMES = 40  # phase 13: the first frames of the phase-5 feed
SWEEP_EXTRA_NOISE = 0.08  # phase 14: load-time noise on the phase-5 feed (the full run's severity)
SMALL_CAPACITY = 16  # phase 14: LoopConfig.max_keyframes
SMALL_CAPACITY_DECIMATIONS = 3  # phase 14: the reference LoopCloser's for 39 keyframes at capacity 16
DIAG_BA_FRAMES = 60  # phase 14: diag_ba_torch's hook over the first frames of the phase-5 feed
POSE_OK_FRAC_MIN = 0.95  # phase 14
PROFILE_PLAIN_FRAMES, PROFILE_REFINED_FRAMES = 10, 20  # phase 15: the profiles' first frames of the two feeds
# The refined path's programs captured apart from the step (utils.graphs.StaticCall names): phase 5 and 15.
REFINER_PROGRAMS = ("window_solve", "verification_round", "global_descriptor", "keyframe_association")
REPO = os.path.dirname(os.path.abspath(__file__))
# The host's launching calls, as the profiler names the CUDA runtime and driver calls.
HOST_LAUNCH_CALLS = {
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
    "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset",
}

KERNELS = {
    "extrema_scores": dict(
        source="vo_tpu_torch/csrc/extrema_scores.cu", replaces="vo_tpu/frontend/pallas_kernels.py:180"
    ),
    "bin_maps": dict(source="vo_tpu_torch/csrc/bin_maps.cu", replaces="vo_tpu/frontend/pallas_kernels.py:213"),
}
K3 = "pose_refine"  # csrc/pose_refine.cu, one launch per frame a step processes; replaces no TPU kernel
K4 = "gauss_blur"  # csrc/gauss_blur.cu, 2 + n_octaves launches per fast detection call; replaces no TPU kernel
K4_TOL = 2e-7  # tests/test_torch_gauss_blur.py: K4 against the card's band products


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call, from CUDA events around each of ``reps`` calls after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def back_to_back_ms(fn, n: int = BACK_TO_BACK) -> float:
    """Time of one call: ``n`` calls between one pair of CUDA events, over ``n``. Inputs stay in L2 as far
    as it holds them; where the host enqueues slower than the card runs, this is the host's time per call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def cold_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Median device time of one call whose inputs are not in L2: ``flush`` (far larger than L2) is
    cleared before each call, and the events around the call are queued while the clear runs."""
    fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(n_bytes: int, n_flop: int) -> dict:
    """The least time the card could take: the larger of bytes over the memory rate and operations over the peak rate."""
    by_bytes, by_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_flop / FP32_FLOP_PER_S
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations", bytes=n_bytes, flop=n_flop)


def against_plain(imgs: torch.Tensor, cfg: PipelineConfig, time_plain: bool) -> dict:
    """Both kernels against their plain versions on the pyramid of ``imgs`` ([B, H, W]), octave by
    octave (K1 exact, K2 within K2_TOL), then the whole detection call in one launch per kernel,
    which must equal the per-octave results bit for bit -> the pyramid views, the errors and,
    with ``time_plain``, the plain versions' times summed over the octaves."""
    s = cfg.sift
    thr = s.contrast_threshold
    pyr = build_pyramid(imgs, s)
    dogs = pyr.dog[: s.n_octaves]
    levels = [G[:, 1 : s.scales_per_octave + 1] for G in pyr.gauss[: s.n_octaves]]  # views, read in place
    stats = {k: dict(max_abs_err=0.0, plain_ms=0.0) for k in KERNELS}
    per_octave = {k: [] for k in KERNELS}
    for o in range(s.n_octaves):
        dog, lev = dogs[o], levels[o]
        cases = {
            "extrema_scores": (lambda: kernels.extrema_scores(dog, thr), lambda: kernels.extrema_scores_plain(dog, thr), dog),
            "bin_maps": (lambda: kernels.bin_maps(lev), lambda: kernels.bin_maps_plain(lev), lev),
        }
        for name, (kern, plain, x) in cases.items():
            got = kern()
            torch.cuda.synchronize()
            err = float((got - plain()).abs().max())
            plain_ms = median_ms(plain) if time_plain else 0.0
            per_octave[name].append(got)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            stats[name]["plain_ms"] += plain_ms
            print(f"  {name} octave {o} in {tuple(x.shape)} strides {x.stride()}: max|kernel-plain| {err:.3e}"
                  + (f"  plain {plain_ms:.4f} ms" if time_plain else ""))
    if stats["extrema_scores"]["max_abs_err"] != 0.0:
        raise AssertionError(f"K1 extrema_scores differs from its plain version at batch {imgs.shape[0]}: {stats['extrema_scores']}")
    if not stats["bin_maps"]["max_abs_err"] <= K2_TOL:
        raise AssertionError(f"K2 bin_maps exceeds {K2_TOL} at batch {imgs.shape[0]}: {stats['bin_maps']}")
    one_launch = {"extrema_scores": kernels.extrema_scores_octaves(dogs, thr), "bin_maps": kernels.bin_maps_octaves(levels)}
    torch.cuda.synchronize()
    for name, got in one_launch.items():
        if not all(torch.equal(a, b) for a, b in zip(got, per_octave[name])):
            raise AssertionError(f"{name}: the one-launch detection call differs from the per-octave launches at batch {imgs.shape[0]}")
    return dict(dogs=dogs, levels=levels, stats=stats)


def check_kernels(feed: runner.StagedSequence, cfg: PipelineConfig) -> dict:
    """Phase 3: each kernel against its plain version at every detection batch the driven paths
    produce, octave by octave and as the one launch per detection call; at the group's batch also
    times, bounds and launches per detection call."""
    s = cfg.sift
    thr = s.contrast_threshold
    # The frame-by-frame paths (refined, resumed, per-frame host) detect on one frame's left and
    # right image; the deferred plain path on the images of fused_group frames.
    pair = torch.stack(list(feed.frame(0))).float() / 255.0
    one = pair[:1]
    print(f"  detection batch of {one.shape[0]} image (a rank of a mesh whose \"data\" axis is 2):")
    by_one = against_plain(one, cfg, time_plain=False)["stats"]
    print(f"  detection batch of {pair.shape[0]} images (the frame-by-frame paths):")
    by_pair = against_plain(pair, cfg, time_plain=False)["stats"]
    imgs = torch.stack([im for i in range(cfg.fused_group) for im in feed.frame(i)]).float() / 255.0
    print(f"  detection batch of {imgs.shape[0]} images (one group of the deferred path):")
    found = against_plain(imgs, cfg, time_plain=True)
    dogs, levels, stats = found["dogs"], found["levels"], found["stats"]
    for name in KERNELS:
        stats[name]["max_abs_err_by_batch"] = {
            str(one.shape[0]): by_one[name]["max_abs_err"],
            str(pair.shape[0]): by_pair[name]["max_abs_err"],
            str(imgs.shape[0]): stats[name]["max_abs_err"],
        }
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err_by_batch"].values())

    # (the detection call in one launch, the same work as one launch per octave)
    calls = {
        "extrema_scores": (
            lambda: kernels.extrema_scores_octaves(dogs, thr),
            lambda: [kernels.extrema_scores(d, thr) for d in dogs],
        ),
        "bin_maps": (lambda: kernels.bin_maps_octaves(levels), lambda: [kernels.bin_maps(g) for g in levels]),
    }
    octave0 = {"extrema_scores": lambda: kernels.extrema_scores(dogs[0], thr), "bin_maps": lambda: kernels.bin_maps(levels[0])}
    px = sum(d.shape[2] * d.shape[3] for d in dogs)
    B, L = dogs[0].shape[:2]
    n_lev = levels[0].shape[1]
    pooled = sum((g.shape[2] // 2) * (g.shape[3] // 2) for g in levels)
    bounds = {
        "extrema_scores": bound(4 * B * (2 * L - 2) * px, K1_FLOP_PER_OUTPUT * B * (L - 2) * px),
        "bin_maps": bound(4 * B * n_lev * (px + kernels.NB * pooled), K2_FLOP_PER_PIXEL * B * n_lev * px),
    }
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=imgs.device)
    for name, (call, octave_by_octave) in calls.items():
        st = stats[name]
        st["back_to_back_ms"] = back_to_back_ms(call)
        st["ms"] = cold_ms(call, flush)
        st["per_octave_launches_ms"] = cold_ms(octave_by_octave, flush)
        st["octave0_ms"] = cold_ms(octave0[name], flush)
        half = torch.empty(bounds[name]["bytes"] // 2, dtype=torch.uint8, device=imgs.device)
        other = torch.empty_like(half)
        st["copy_same_bytes_ms"] = cold_ms(lambda: other.copy_(half), flush)
        del half, other
        st.update(bounds[name])
        st["share_of_bound"] = st["bound_ms"] / st["ms"]
        print(
            f"  {name}, the detection call ({B} images, {s.n_octaves} octaves) in one launch: equal to the per-octave "
            f"launches; {st['ms']:.4f} ms cold (octave 0 alone {st['octave0_ms']:.4f} ms, four launches "
            f"{st['per_octave_launches_ms']:.4f} ms, a copy of the same bytes {st['copy_same_bytes_ms']:.4f} ms), "
            f"{st['back_to_back_ms']:.4f} ms back to back, plain {st['plain_ms']:.4f} ms; bound {st['bound_ms']:.4f} ms "
            f"by {st['bound_by']} ({st['bytes'] / 1e6:.1f} MB, {st['flop'] / 1e6:.0f} Mflop), share of bound {st['share_of_bound']:.3f}"
        )
    del flush
    for batch in (one, pair, imgs):
        kernels.reset_launches()
        detect_and_describe(batch, s)
        for name in KERNELS:
            stats[name]["launches_per_detect_call"] = kernels.LAUNCHES[name]
            if kernels.LAUNCHES[name] != 1:
                raise AssertionError(
                    f"{name}: {kernels.LAUNCHES[name]} launches in one detection call on {batch.shape[0]} images, expected 1"
                )
    return stats


def k4_launches(cfg: PipelineConfig, fast: bool = True) -> int:
    """K4's launches in one detection call: the base blur, one per octave, and on the fast path the map rows."""
    return 1 + cfg.sift.n_octaves + int(fast)


def k4_against_band_products(imgs: torch.Tensor, cfg: PipelineConfig) -> dict:
    """K4 against the band products on the card, launch by launch from the same inputs (the base blur, each
    octave's levels and DoG, the map rows of every level) and along the whole pyramid -> {part: (max
    |difference|, values that differ, the band products' own spread)}. The spread is how far cuBLAS's
    product of the same inputs moves when the batch is doubled (it picks its GEMM, and so its order of
    summation, by shape): where it exceeds K4_TOL it is the bound. The whole pyramid compounds it, and is
    reported only."""
    s = cfg.sift
    sig = pyramid.sigma_schedule(s)[0]
    plain_cfg = dataclasses.replace(s, use_pallas=False)
    base_k = pyramid.gaussian_kernel_1d(float(np.sqrt(max(s.sigma0**2 - 0.25, 0.01))))
    levels_k = pyramid._level_kernels(sig)
    B = imgs.shape[0]

    def doubled(fn, x):
        return fn(torch.cat([x, x]))[:B]

    pyr, want = build_pyramid(imgs, s), build_pyramid(imgs, plain_cfg)
    parts = {}
    cur = pyramid.blur_separable(imgs, base_k)
    parts["base"] = (pyramid.gauss_stack(imgs, (base_k,), decimate=False, dog=False)[0][:, 0], cur,
                     doubled(lambda x: pyramid.blur_separable(x, base_k), imgs))
    for o in range(s.n_octaves):
        src = cur if o == 0 else pyr.gauss[o - 1][:, s.scales_per_octave]
        band = pyramid._blur_stack_from_base(src, sig, decimate=o > 0)
        band2 = doubled(lambda x: pyramid._blur_stack_from_base(x, sig, decimate=o > 0), src)
        G, D = pyramid.gauss_stack(src, levels_k, decimate=o > 0, dog=True)
        parts[f"octave {o}"] = (G, band, band2)
        parts[f"dog {o}"] = (D, band[:, 1:] - band[:, :-1], band2[:, 1:] - band2[:, :-1])
        parts[f"pyramid gauss {o}"] = (pyr.gauss[o], want.gauss[o], None)
        parts[f"pyramid dog {o}"] = (pyr.dog[o], want.dog[o], None)
    raws = kernels.bin_maps_octaves([G[:, 1 : s.scales_per_octave + 1] for G in pyr.gauss])
    sig_maps = sig[1 : s.scales_per_octave + 1]
    raws2 = [torch.cat([r, r]) for r in raws]
    parts["map rows"] = (dense_desc.bin_map_rows(raws, sig_maps), dense_desc.bin_map_rows(raws, sig_maps, use_pallas=False),
                         dense_desc.bin_map_rows(raws2, sig_maps, use_pallas=False)[:B])
    torch.cuda.synchronize()
    return {k: (float((a - b).abs().max()), int((a != b).sum()), None if c is None else float((b - c).abs().max()))
            for k, (a, b, c) in parts.items()}


def time_gauss_blur(imgs: torch.Tensor, cfg: PipelineConfig) -> dict:
    """The detection call's blurs through K4 (the base, one launch per octave, the map rows) and through
    the band products, each replayed as a CUDA graph with cold inputs, beside K4's bound."""
    s = cfg.sift
    pyr = build_pyramid(imgs, s)
    raws = kernels.bin_maps_octaves([G[:, 1 : s.scales_per_octave + 1] for G in pyr.gauss])
    sig = pyramid.sigma_schedule(s)[0]
    sig_maps = sig[1 : s.scales_per_octave + 1]
    plain_cfg = dataclasses.replace(s, use_pallas=False)

    def call():
        return build_pyramid(imgs, s), dense_desc.bin_map_rows(raws, sig_maps)

    def plain():
        return build_pyramid(imgs, plain_cfg), dense_desc.bin_map_rows(raws, sig_maps, use_pallas=False)

    # Bytes: every source sample read once (the image, each octave's base samples, the pooled maps), every
    # level, DoG plane and map row written once (the base blur's output too: octave 0 reads it). Operations:
    # a multiply and an add per tap of each pass, one subtraction per DoG value.
    B, (H, W) = imgs.shape[0], imgs.shape[1:]
    L = len(pyramid._level_kernels(sig))
    base_t = 2 * pyramid.tap_table(pyramid.gaussian_kernel_1d(float(np.sqrt(max(s.sigma0**2 - 0.25, 0.01)))))[0] + 1
    level_t = sum(2 * pyramid.tap_table(k)[0] + 1 for k in pyramid._level_kernels(sig))
    map_t = sum(2 * pyramid.tap_table(dense_desc._map_kernel(float(x)))[0] + 1 for x in sig_maps)
    px = [G.shape[2] * G.shape[3] for G in pyr.gauss]
    pooled = [r.shape[3] * r.shape[4] for r in raws]
    n_bytes = 4 * B * (2 * H * W + sum(p * (1 + L + L - 1) for p in px) + 2 * kernels.NB * len(sig_maps) * sum(pooled))
    n_flop = B * (4 * base_t * H * W + sum(p * (4 * level_t + L - 1) for p in px) + 4 * kernels.NB * map_t * sum(pooled))
    st = bound(n_bytes, n_flop)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=imgs.device)
    def graphed(fn):  # the device work alone, as the step's graphs run it: the host enqueues slower
        return graphs.capture(fn, imgs.device).replay

    replay = graphed(call)
    st["back_to_back_ms"] = back_to_back_ms(replay)
    st["ms"] = cold_ms(replay, flush)
    st["pyramid_ms"] = cold_ms(graphed(lambda: build_pyramid(imgs, s)), flush)
    st["map_rows_ms"] = cold_ms(graphed(lambda: dense_desc.bin_map_rows(raws, sig_maps)), flush)
    st["plain_ms"] = cold_ms(graphed(plain), flush)
    st["share_of_bound"] = st["bound_ms"] / st["ms"]
    del flush
    return st


def check_gauss_blur(feed: runner.StagedSequence, cfg: PipelineConfig) -> dict:
    """Phase 3, K4: the blurs against the band products at every detection batch, then at 4 images the
    detection call's blurs timed beside their bound and the band products."""
    s = cfg.sift
    pair = torch.stack(list(feed.frame(0))).float() / 255.0
    imgs = torch.stack([im for i in range(cfg.fused_group) for im in feed.frame(i)]).float() / 255.0
    st: dict = {"max_abs_err_by_batch": {}, "differ_by_batch": {}}
    for batch in (pair[:1], pair, imgs):
        found = k4_against_band_products(batch, cfg)
        err = max(v[0] for v in found.values() if v[2] is not None)
        st["max_abs_err_by_batch"][str(batch.shape[0])] = err
        st["differ_by_batch"][str(batch.shape[0])] = {k: v[:2] for k, v in found.items()}
        print(f"  {K4}, {batch.shape[0]} image(s), against the band products (max |difference|, values that differ, "
              f"the band products' own spread): " + ", ".join(f"{k} {v[0]:.3e} {v[1]} {v[2]}" for k, v in found.items()))
        over = {k: v for k, v in found.items() if v[2] is not None and v[0] > max(K4_TOL, v[2])}
        if over:
            raise AssertionError(f"K4 {K4} exceeds {K4_TOL} (or the band products' own spread) at batch {batch.shape[0]}: {over}")
    st["max_abs_err"] = max(st["max_abs_err_by_batch"].values())

    st.update(time_gauss_blur(imgs, cfg))
    kernels.reset_launches()
    detect_and_describe(imgs, s)
    st["launches_per_detect_call"] = kernels.LAUNCHES[K4]
    if kernels.LAUNCHES[K4] != k4_launches(cfg):
        raise AssertionError(f"{K4}: {kernels.LAUNCHES[K4]} launches in one detection call, expected {k4_launches(cfg)}")
    print(
        f"  {K4}, the detection call's blurs ({imgs.shape[0]} images, {s.n_octaves} octaves, {k4_launches(cfg)} launches): "
        f"{st['ms']:.4f} ms cold as a replayed graph (pyramid {st['pyramid_ms']:.4f} ms, map rows {st['map_rows_ms']:.4f} "
        f"ms), {st['back_to_back_ms']:.4f} ms back to back; the band products {st['plain_ms']:.4f} ms; bound "
        f"{st['bound_ms']:.4f} ms by {st['bound_by']} ({st['bytes'] / 1e6:.1f} MB, {st['flop'] / 1e6:.0f} Mflop), "
        f"share of bound {st['share_of_bound']:.3f}"
    )
    return st


def pose_gaps(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(translation m, rotation rad) of the relative pose between two [4, 4] poses, in float64."""
    d = np.linalg.inv(a.double().cpu().numpy()) @ b.double().cpu().numpy()
    w = 0.5 * np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.linalg.norm(d[:3, 3])), float(np.arcsin(min(1.0, np.linalg.norm(w))))


def check_pose_refine(cfg: PipelineConfig, device) -> dict:
    """Phase 3, K3: the consensus refinement against its plain version at the main path's shapes, then
    its times beside the plain version's and the latency floor."""
    px, X, mask, calib, _ = ransac_problem(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    triples = ransac._sample_triples(gen, mask, cfg.ransac.n_hypotheses)
    R, t, _, any_valid = ransac.best_hypothesis(px, X, mask, calib, cfg.ransac, triples)
    args = (R, t, any_valid, px, X, mask, calib, cfg.ransac)
    plain = matmul_precision("float32")(ransac._finalize_plain)
    n0 = kernels.LAUNCHES[K3]
    got, again, want = ransac.finalize_pose(*args), ransac.finalize_pose(*args), plain(*args)
    torch.cuda.synchronize()
    if kernels.LAUNCHES[K3] != n0 + 2:
        raise AssertionError(f"{K3}: {kernels.LAUNCHES[K3] - n0} launches counted for 2 calls")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{K3}: two launches on the same input differ")
    dt, dr = pose_gaps(want.pose_c2w, got.pose_c2w)
    n_in, n_in_plain = int(got.n_inliers), int(want.n_inliers)
    if bool(got.ok) != bool(want.ok) or n_in != n_in_plain or not (dt <= K3_T_TOL_M and dr <= K3_R_TOL_RAD):
        raise AssertionError(f"{K3} against its plain version: ok {bool(got.ok)} / {bool(want.ok)}, n_inliers {n_in} / "
                             f"{n_in_plain}, pose gap {dt:.3e} m {dr:.3e} rad")
    st = dict(n=int(px.shape[0]), iters=cfg.ransac.refine_iters, n_inliers=n_in, pose_gap_m=dt, pose_gap_rad=dr,
              inliers_differ=int((got.inliers != want.inliers).sum()),
              mean_err_gap=abs(float(got.mean_err) - float(want.mean_err)))
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=device)
    st["ms"] = cold_ms(lambda: ransac.finalize_pose(*args), flush)
    st["back_to_back_ms"] = back_to_back_ms(lambda: ransac.finalize_pose(*args))
    st["plain_ms"] = median_ms(lambda: plain(*args))
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        plain(*args)  # warm-up before the capture, as utils.graphs does
    torch.cuda.current_stream(device).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        plain(*args)
    st["plain_graph_ms"] = cold_ms(g.replay, flush)
    stamp_buf = torch.zeros((1, 1), dtype=torch.int64, device=device)
    stamp_row = torch.zeros(1, dtype=torch.int64, device=device)
    st["floor_ms"] = cold_ms(lambda: profiling.write_stamp(stamp_buf, stamp_row, 0), flush)
    del flush, g
    n = st["n"]
    # in: pixels, points, mask, the winner's pose and any_valid; out: the pose, inliers, n_inliers, ok, mean_err
    n_bytes = n * (4 * 5 + 1) + 4 * 12 + 1 + 4 * 16 + n + 8 + 1 + 4
    st.update(bound(n_bytes, n * (K3_FLOP_PER_POINT + K3_FLOP_PER_POINT_ITER * st["iters"])))
    st["floor_share"] = st["floor_ms"] / st["ms"]
    print(
        f"  {K3} ({n} points, {st['iters']} iterations): against its plain version ok {bool(got.ok)}, n_inliers {n_in} "
        f"equal, {st['inliers_differ']} inliers differ, pose gap {dt:.3e} m {dr:.3e} rad, mean_err gap "
        f"{st['mean_err_gap']:.3e} px; two launches bit-equal; {st['ms']:.4f} ms a launch ({st['back_to_back_ms']:.4f} "
        f"ms back to back), plain {st['plain_ms']:.4f} ms eager and {st['plain_graph_ms']:.4f} ms as a replayed graph; "
        f"floor (a one-thread launch) {st['floor_ms']:.4f} ms, share {st['floor_share']:.3f}; bound by "
        f"{st['bound_by']} {st['bound_ms']:.6f} ms ({n_bytes} bytes, {st['flop'] / 1e6:.2f} Mflop)"
    )
    return st


class OutAndBackFeed:
    """GT poses 0..n-1 then n-2..0, staged on ``device``. The way back revisits every pose of the
    way out, so its frames are the outbound frames of the same poses (rendered and staged once)."""

    def __init__(self, n_out: int, device):
        root = synthetic.DEFAULT_KITTI_ROOT
        gt = kitti.read_poses(f"{root}/poses/00.txt")[:n_out]
        self.gt_poses = np.concatenate([gt, gt[-2::-1]])
        seq = synthetic.SyntheticSequence(
            kitti.load_stereo_calib(f"{root}/00"), self.gt_poses, n_landmarks=N_LANDMARKS, seed=0
        )
        self.calib = seq.calib
        out = [tuple(runner.to_device(im, device) for im in seq.frame(i)) for i in range(n_out)]
        self.frames = out + out[-2::-1]
        self.H, self.W = seq.H, seq.W

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int):
        return self.frames[i]


def require_refine_records(res, what: str) -> None:
    """A refined ``RunResult`` carries the frame loop's rows (``step_poses``, which chain) and the
    refiner's records, as many as ``refine_stats`` counts."""
    if res.step_poses is None or res.step_poses.shape != res.poses.shape or res.refine_log is None:
        raise AssertionError(f"{what}: no step rows or no refine_log")
    P, R = (np.asarray(a, np.float64) for a in (res.step_poses, res.step_rel_poses))
    prev = np.concatenate([np.eye(4)[None], P[:-1]])
    gap = np.linalg.norm(np.einsum("tij,tjl->til", prev, R)[:, :3, 3] - P[:, :3, 3], axis=1)
    if not gap.max() <= 1e-5 * (1.0 + np.abs(P[:, :3, 3]).max()):
        raise AssertionError(f"{what}: the step rows do not chain ({gap.max()} m)")
    st, log = res.refine_stats, res.refine_log
    verdicts = [w.verdict for w in log.window_solves]
    got = dict(
        records_window=len(log.window_solves), ba_solves=verdicts.count("accepted"), ba_rejected=verdicts.count("rejected"),
        records_graph=len(log.graph_solves), loops_closed=sum(g.T is not None for g in log.graph_solves),
        records_rounds=len(log.rounds), lc_verified=sum(int(r.verdict.sum()) for r in log.rounds),
        n_keyframes=int(log.kf_frame_idx.size),
    )
    want = {k: st.get(k) for k in got}
    if got != want:
        raise AssertionError(f"{what}: records {got} against refine_stats {want}")
    print(f"    {what}: records {got}")


def refined_path(feed: OutAndBackFeed, cfg: PipelineConfig, device):
    """Phase 5: plain VO and the refined path over the out-and-back feed -> (launches, the refined result)."""
    n = len(feed)
    gt = feed.gt_poses
    plain = runner.run_sequence(feed, cfg, device=device)
    kernels.reset_launches()
    graphs.reset_programs()
    res = runner.run_sequence(feed, cfg, use_ba=True, use_loop_closure=True, device=device)
    launches = dict(kernels.LAUNCHES)
    programs = {k: dict(v) for k, v in graphs.PROGRAMS.items()}
    ate_plain = metrics.ate(plain.poses, gt)["rmse"]
    ate = metrics.ate(res.poses, gt)["rmse"]
    st = res.refine_stats
    print(
        f"[5] refined path, {n} out-and-back frames at the default config: {res.frames_per_sec:.3f} fps, "
        f"{res.per_frame_ms:.3f} ms/frame, ATE rmse {ate:.5f} m; plain VO {plain.frames_per_sec:.3f} fps, "
        f"{plain.per_frame_ms:.3f} ms/frame, ATE rmse {ate_plain:.5f} m; launches {launches}"
    )
    print(f"    refine_stats {json.dumps(st, sort_keys=True)}")
    if not (np.isfinite(res.poses).all() and np.isfinite(plain.poses).all()):
        raise AssertionError("non-finite pose in phase 5")
    if res.poses.shape != (n - 1, 4, 4):
        raise AssertionError(f"expected {n - 1} refined poses, got {res.poses.shape}")
    want_kf = (n - 1) // cfg.ba.keyframe_every
    if st.get("n_keyframes") != want_kf:
        raise AssertionError(f"n_keyframes {st.get('n_keyframes')} != {want_kf}")
    if st.get("ba_solves", 0) < 1:
        raise AssertionError("no window BA solve was accepted")
    if st.get("lc_verified", 0) < 1:
        raise AssertionError("no loop candidate was verified")
    require_refine_records(res, "phase 5, refined")
    if not ate_plain <= PLAIN_ATE_MAX_M:
        raise AssertionError(f"plain ATE {ate_plain} m > {PLAIN_ATE_MAX_M} m")
    if not ate <= ate_plain + REFINED_ATE_SLACK_M:
        raise AssertionError(f"refined ATE {ate} m > plain ATE {ate_plain} m + {REFINED_ATE_SLACK_M} m")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the refined path")
    # Each of the four programs captured once per shape it is called at (the query of a verification
    # round and the global descriptor's input: max_keypoints rows, and max_tracks where that differs),
    # and replayed in the run: the association and the descriptor once per keyframe.
    n_shapes = len({cfg.sift.max_keypoints, cfg.max_tracks})
    want_captures = dict(window_solve=1, verification_round=n_shapes, global_descriptor=n_shapes, keyframe_association=1)
    got_captures = {k: programs.get(k, {}).get("captures", 0) for k in REFINER_PROGRAMS}
    replays = {k: programs.get(k, {}).get("replays", 0) for k in REFINER_PROGRAMS}
    print(f"    programs captured {json.dumps(got_captures)}, replayed {json.dumps(replays)}")
    if got_captures != want_captures:
        raise AssertionError(f"refined run captured {got_captures}, expected {want_captures}")
    if not (replays["keyframe_association"] == replays["global_descriptor"] == want_kf
            and replays["window_solve"] >= st["ba_solves"] and replays["verification_round"] >= 1):
        raise AssertionError(f"refined run replayed {replays} for {want_kf} keyframes and {st['ba_solves']} solves")
    return launches, res


def closure_fires(feed: OutAndBackFeed, cfg: PipelineConfig, device, tag: str = "[6]") -> None:
    """Phase 6: keyframes with growing drift through a default-config LoopCloser on the card."""
    calib = feed.calib.to(device)
    lc = LoopCloser(feed.calib, cfg.loop, matcher=cfg.matcher, device=device)
    gt = feed.gt_poses
    fired = None
    kf_frames = list(range(cfg.ba.keyframe_every, len(feed), cfg.ba.keyframe_every))
    for k, i in enumerate(kf_frames):
        imgs = torch.stack(feed.frame(i)).float() / 255.0
        f = detect_and_describe(imgs, cfg.sift)
        fl, fr = (type(f)(*(x[j] for x in f)) for j in (0, 1))
        sf, _ = stereo_features_with_matches(fl, fr, cfg.matcher, cfg.max_tracks)
        pose = gt[i].astype(np.float32).copy()
        pose[0, 3] += DRIFT_PER_KF_M * k
        res = lc.add_keyframe(
            ArchivedKeyframe(
                frame_idx=i, pose_c2w=pose, l_px=None, r_px=None, l_desc=None, mask=None,
                global_desc=global_desc(fl.desc, fl.mask).cpu().numpy(),
                dev=(sf.l_xy, sf.r_xy, sf.l_desc, sf.mask),
            ),
            query_dev=(fl.xy, fl.desc, fl.mask),
        )
        fired = res if res is not None else fired
    fired = lc.flush() or fired
    if fired is None:
        raise AssertionError(f"no loop closure fired ({lc.n_verified} candidates verified)")
    old_k, new_k = fired["loop"]
    fi = lc.keyframes[new_k].frame_idx
    err_drift = DRIFT_PER_KF_M * kf_frames.index(fi)
    err = float(np.linalg.norm(fired["corrected"][new_k][:3, 3] - gt[fi][:3, 3]))
    print(
        f"{tag} loop closure on the card: {len(kf_frames)} keyframes, {lc.n_verified} candidates verified, "
        f"loop {old_k}->{new_k} (frames {lc.keyframes[old_k].frame_idx}->{fi}), newest loop keyframe error "
        f"{err:.4f} m against {err_drift:.4f} m drifted, {lc.skipped_small} skipped as small, "
        f"phase seconds {json.dumps({k: round(v, 4) for k, v in lc.phase_s.items()})}"
    )
    if not err < 0.5 * err_drift:
        raise AssertionError(f"closure left the newest loop keyframe {err} m off, not under half of {err_drift} m")


def no_progress(i, info) -> None:
    """A per-frame consumer that does nothing: it only takes a run off the deferred path."""


def counted(launches_by_path: dict, path: str, fn):
    """fn() with the kernels' launch counters set to 0 just before and read just after."""
    kernels.reset_launches()
    out = fn()
    launches_by_path[path] = dict(kernels.LAUNCHES)
    return out


def max_diff(a: runner.RunResult, b: runner.RunResult) -> float:
    return float(np.abs(a.poses.astype(np.float64) - b.poses.astype(np.float64)).max()) if a.poses.size else 0.0


def require_same_run(a: runner.RunResult, b: runner.RunResult, run_to_run: float, what: str) -> float:
    """``a`` against ``b``: equal bit for bit where the card repeats a run (``run_to_run`` 0), else
    poses within ten times the run-to-run difference. Returns the difference."""
    d = max_diff(a, b)
    if a.poses.shape != b.poses.shape:
        raise AssertionError(f"{what}: pose counts differ, {a.poses.shape} against {b.poses.shape}")
    if run_to_run == 0.0:
        for k in ("poses", "n_inliers", "pose_ok"):
            if not np.array_equal(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"{what}: {k} differs (max |pose difference| {d})")
    elif not d <= 10.0 * run_to_run:
        raise AssertionError(f"{what}: poses differ by {d}, over ten times the run-to-run difference {run_to_run}")
    return d


def resume_on_the_card(feed, cfg: PipelineConfig, device, at: int, tmp: str, launches_by_path: dict, refined: bool,
                       again: runner.RunResult = None) -> dict:
    """Phase 7, one path: is an uninterrupted run repeatable, and does a run resumed from the
    checkpoint of frame ``at`` reproduce it? ``again`` is an earlier uninterrupted run of the same
    path over ``feed`` to stand for the second one (it is made here when None)."""
    n = len(feed)
    name = "refined" if refined else "plain"
    kw = dict(use_ba=refined, use_loop_closure=refined, device=device, progress=no_progress)
    t = time.perf_counter()
    full = runner.run_sequence(feed, cfg, **kw)
    two_runs = "both non-deferred" if again is None else "this non-deferred one and the earlier deferred one"
    if again is None:
        again = runner.run_sequence(feed, cfg, **kw)
    run_to_run = max_diff(full, again)
    if full.poses.shape != again.poses.shape:
        raise AssertionError(f"two uninterrupted {name} runs: {full.poses.shape} against {again.poses.shape} poses")
    ck = os.path.join(tmp, f"ck_{name}.npz")
    runner.run_sequence(feed, cfg, n_frames=at, checkpoint_path=ck, checkpoint_every=at, **kw)
    size = os.path.getsize(ck)
    t_load = time.perf_counter()
    loaded = checkpoint.load(ck, device)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t_load
    t_save = time.perf_counter()
    checkpoint.save(
        os.path.join(tmp, f"ck_{name}_again.npz"), loaded.state, loaded.lmap, loaded.poses, loaded.rel_poses,
        loaded.frame_idx, stats=(loaded.n_inliers, loaded.n_tracks, loaded.pose_ok), refiner_state=loaded.refiner,
    )
    t_save = time.perf_counter() - t_save
    resumed = counted(
        launches_by_path, f"resumed_{name}",
        lambda: runner.run_sequence(feed, cfg, checkpoint_path=ck, resume=True, **kw),
    )
    d = require_same_run(resumed, full, run_to_run, f"{name} run resumed at frame {at}")
    stats_equal = True
    if refined:
        keys = ("n_keyframes", "ba_solves", "lc_verified", "loops_closed")
        got, want = ([r.refine_stats.get(k) for k in keys] for r in (resumed, full))
        stats_equal = got == want
        if run_to_run == 0.0 and not stats_equal:
            raise AssertionError(f"resumed refined run: {dict(zip(keys, got))} against {dict(zip(keys, want))}")
        pend = sorted(k for k in np.load(ck).files if k in ("refx_ba_pend0_T", "refx_lc_pend_ver"))
        print(f"    in flight in the checkpoint: {pend}; refine stats equal: {stats_equal} ({dict(zip(keys, got))})")
    print(
        f"[7] {name} path, {n} frames, checkpoint at {at}: two uninterrupted runs ({two_runs}) differ by {run_to_run:.3e} m "
        f"({'bit-equal' if run_to_run == 0.0 else 'NOT bit-equal'}); resumed against uninterrupted {d:.3e} m; checkpoint "
        f"{size} bytes, save {t_save:.4f} s, load {t_load:.4f} s; uninterrupted non-deferred {full.frames_per_sec:.3f} fps, "
        f"resumed part {resumed.frames_per_sec:.3f} fps; launches {launches_by_path[f'resumed_{name}']}; "
        f"{time.perf_counter() - t:.1f} s"
    )
    for k, v in launches_by_path[f"resumed_{name}"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the resumed {name} run")
    return dict(run_to_run=run_to_run, resumed_diff=d, bytes=size, save_s=t_save, load_s=t_load)


def host_paths(feed, cfg: PipelineConfig, device, grouped: runner.RunResult, tmp: str, launches_by_path: dict,
               run_to_run: float) -> None:
    """Phase 8: progress and the metrics JSONL on the 30-frame feed."""
    t = time.perf_counter()
    n = len(feed)
    seen = []
    path = os.path.join(tmp, "metrics.jsonl")
    single = runner.run_sequence(feed, dataclasses.replace(cfg, fused_group=1), device=device)
    res = counted(
        launches_by_path, "per_frame_host",
        lambda: runner.run_sequence(
            feed, cfg, device=device, progress=lambda i, info: seen.append((i, info)), metrics_path=path
        ),
    )
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != n or [r["frame"] for r in rows] != list(range(n)) or set(rows[0]) != METRICS_KEYS:
        raise AssertionError(f"metrics JSONL: {len(rows)} rows with keys {sorted(rows[0]) if rows else None}")
    if [i for i, _ in seen] != list(range(n)):
        raise AssertionError("progress was not called once per frame in order")
    for i, info in seen[1:]:
        want = dict(n_tracks=int(res.n_tracks[i - 1]), n_inliers=int(res.n_inliers[i - 1]), pose_ok=bool(res.pose_ok[i - 1]))
        if info != want:
            raise AssertionError(f"progress at frame {i}: {info} against the result's {want}")
    d_single = require_same_run(res, single, run_to_run, "non-deferred against the deferred single-frame run")
    d_grouped = max_diff(res, grouped)
    if not d_grouped <= GROUPED_POSE_TOL:
        raise AssertionError(f"non-deferred poses differ from the grouped deferred run's by {d_grouped} > {GROUPED_POSE_TOL}")
    ms = np.asarray([r["frame_ms"] for r in rows[1:]])
    print(
        f"[8] per-frame host paths, {n} frames: non-deferred {res.frames_per_sec:.3f} fps against {single.frames_per_sec:.3f} fps "
        f"deferred frame by frame (ratio {res.frames_per_sec / single.frames_per_sec:.3f}) and {grouped.frames_per_sec:.3f} fps "
        f"deferred in groups of {cfg.fused_group} (ratio {res.frames_per_sec / grouped.frames_per_sec:.3f}); frame_ms, one host read "
        f"included, p50 {np.percentile(ms, 50):.2f} p90 {np.percentile(ms, 90):.2f} p99 {np.percentile(ms, 99):.2f} max {ms.max():.2f}; "
        f"poses against frame by frame {d_single:.3e} m, against the groups {d_grouped:.3e} m; "
        f"launches {launches_by_path['per_frame_host']}; {time.perf_counter() - t:.1f} s"
    )
    # (the dev utilities on the card: every launch of a short deferred run counted, and the non-finite trap armed)
    n_dev = 10
    with debug.compile_logging() as log:
        runner.run_sequence(feed, cfg, n_frames=n_dev, device=device, warmup=False)
    with debug.nan_debug():
        try:
            runner.run_sequence(feed, cfg, n_frames=4, device=device, warmup=False)
        except ValueError as e:
            refused = "graph=False" in str(e)
        else:
            refused = False
        checked = runner.run_sequence(feed, cfg, n_frames=4, device=device, warmup=False, graph=False)
    # One detection call per group replayed, one in the eager warm-up run that precedes the capture, and one in
    # the replay of the runner's warm-up call.
    calls = n_dev // cfg.fused_group + 2
    if log.hand_written != {**{k: calls for k in KERNELS}, K3: calls * cfg.fused_group, K4: calls * k4_launches(cfg)} or not log.device_launches or not np.isfinite(checked.poses).all():
        raise AssertionError(f"compile_logging counted {log.hand_written} and {log.device_launches} launches in {n_dev} frames")
    if not refused:
        raise AssertionError("a graphed run under nan_debug did not raise the ValueError that names graph=False")
    print(f"    utils.debug: {json.dumps(log.per_frame(n_dev))} over {n_dev} deferred graphed frames (the capture's warm-up run "
          f"included); under nan_debug the graphed run raised and named graph=False, 4 eager frames stayed finite")


def _shared_keypoints(a, b, img: int):
    """Rows of ``a``'s valid keypoints and the rows of ``b`` that are the same keypoint (position and
    orientation within the card-against-CPU tolerances) -> (share of a's that b has, max descriptor difference)."""
    am, bm = a.mask[img].cpu().numpy(), b.mask[img].cpu().numpy()
    axy, bxy = a.xy[img].cpu().numpy()[am], b.xy[img].cpu().numpy()[bm]
    aori, bori = a.orientation[img].cpu().numpy()[am], b.orientation[img].cpu().numpy()[bm]
    close = (np.abs(axy[:, None] - bxy[None]).max(-1) < EXACT_CPU_XY) & (np.abs(aori[:, None] - bori[None]) < EXACT_CPU_ORI)
    j = np.argmax(close, axis=1)
    has = close.any(axis=1)
    dd = np.abs(a.desc[img].cpu().numpy()[am][has] - b.desc[img].cpu().numpy()[bm][j[has]]).max()
    return float(has.mean()), float(dd)


def exact_sift(feed, cfg: PipelineConfig, device, gt, fast_fps: float, launches_by_path: dict) -> None:
    """Phase 9: the exact-SIFT oracle path on the card."""
    t = time.perf_counter()
    imgs = torch.stack([im for i in range(cfg.fused_group) for im in feed.frame(i)]).float() / 255.0
    one = dict(n_orientations=1)
    exact1 = dataclasses.replace(cfg.sift, fast_descriptor=False, **one)
    fe = counted(launches_by_path, "exact_detect_call", lambda: detect_and_describe(imgs, exact1))
    if launches_by_path["exact_detect_call"] != {"extrema_scores": 1, "bin_maps": 0, K3: 0, K4: k4_launches(cfg, fast=False)}:
        raise AssertionError(f"exact detection call launched {launches_by_path['exact_detect_call']}, expected K1 once, K2 "
                             f"never, K4 for the pyramid alone")
    fa = detect_and_describe(imgs, dataclasses.replace(cfg.sift, **one))
    if not torch.equal(fa.mask, fe.mask):
        raise AssertionError("exact and fast paths select different keypoints")
    d_xy = float((fa.xy - fe.xy).abs().max())
    if not d_xy <= EXACT_XY_TOL:
        raise AssertionError(f"exact and fast keypoints differ by {d_xy} px > {EXACT_XY_TOL}")
    exact = dataclasses.replace(cfg.sift, fast_descriptor=False)
    on_card = detect_and_describe(imgs, exact)
    on_cpu = detect_and_describe(imgs.cpu(), exact)
    shared, d_desc = zip(*(_shared_keypoints(on_card, on_cpu, b) for b in range(imgs.shape[0])))
    if min(shared) < EXACT_CPU_SHARED or max(d_desc) > EXACT_CPU_DESC:
        raise AssertionError(f"exact path, card against CPU: shared {shared}, descriptor differences {d_desc}")
    if not (torch.isfinite(on_card.desc).all() and on_card.desc.shape == (imgs.shape[0], cfg.sift.max_keypoints, 128)):
        raise AssertionError("exact descriptors: wrong shape or non-finite")
    ms_exact = median_ms(lambda: detect_and_describe(imgs, exact), reps=10)
    ms_fast = median_ms(lambda: detect_and_describe(imgs, cfg.sift), reps=10)
    cfg_exact = dataclasses.replace(cfg, sift=exact)
    runner.run_sequence(feed, cfg_exact, device=device)  # warm
    res = counted(launches_by_path, "exact_run", lambda: runner.run_sequence(feed, cfg_exact, device=device))
    ate = metrics.ate(res.poses, gt)["rmse"]
    n_ok = int(res.pose_ok.sum())
    la = launches_by_path["exact_run"]
    print(
        f"[9] exact-SIFT path: detection call ({imgs.shape[0]} images) launches {launches_by_path['exact_detect_call']}, keypoints equal "
        f"to the fast path's (xy within {d_xy:.2e} px, {int(fe.mask.sum())} valid); card against CPU: shared {min(shared):.4f}, "
        f"descriptors within {max(d_desc):.2e}; {ms_exact:.3f} ms per call between CUDA events against the fast path's {ms_fast:.3f} ms; "
        f"{len(feed)}-frame run {res.frames_per_sec:.3f} fps against {fast_fps:.3f} fps, ATE rmse {ate:.5f} m, "
        f"pose_ok {n_ok}/{len(res.pose_ok)}, launches {la}; {time.perf_counter() - t:.1f} s"
    )
    if la["extrema_scores"] <= 0 or la["bin_maps"] != 0:
        raise AssertionError(f"the exact run launched {la}: K1 must run, K2 must not")
    if not (np.isfinite(res.poses).all() and ate <= ATE_MAX_M and n_ok >= len(feed) - 2):
        raise AssertionError(f"exact run: ATE {ate} m, pose_ok {n_ok}")


def write_png_gray(path: str, img: np.ndarray) -> None:
    """An 8-bit greyscale PNG from a uint8 [H, W] array (standard library only)."""
    h, w = img.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(img, np.uint8))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def cli(*argv: str, expect: int = 0) -> str:
    """``python -m vo_tpu_torch argv`` from the checkout's root -> its output (its errors where
    ``expect`` is not 0). Fails on another exit code than ``expect``."""
    proc = subprocess.run(
        [sys.executable, "-m", "vo_tpu_torch", *argv], cwd=REPO, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S
    )
    if proc.returncode != expect:
        raise AssertionError(f"vo_tpu_torch {' '.join(argv)} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout if expect == 0 else proc.stderr


def shell_surface(feed, cfg: PipelineConfig, device, tmp: str, run_to_run: float) -> None:
    """Phase 10: the command line as subprocesses, a KITTI directory on disk, and undistortion."""
    t = time.perf_counter()
    have_figures = importlib.util.find_spec("matplotlib") is not None
    out = os.path.join(tmp, "cli")
    run = ("run", "--synthetic", "--frames", "12", "--ba", "--loop-closure", "--checkpoint-every", "8", "--out", out)
    first = cli(*run)
    files = ["trajectory.npz", "landmarks.npz", "stats.json", "metrics.json", "checkpoint.npz"]
    files += ["map.png", "error.png"] if have_figures else []
    for name in files:
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"run wrote no {name}")
    if "device: cuda" not in first:
        raise AssertionError(f"run without --cpu did not pick the card:\n{first}")
    poses_first = np.load(os.path.join(out, "trajectory.npz"))["poses"]
    second = cli(*run, "--resume")
    poses_resumed = np.load(os.path.join(out, "trajectory.npz"))["poses"]
    d_cli = float(np.abs(poses_first - poses_resumed).max())
    if poses_resumed.shape != (11, 4, 4) or not d_cli <= max(10.0 * run_to_run, 0.0):
        raise AssertionError(f"--resume: poses {poses_resumed.shape} differ by {d_cli} from the uninterrupted run's")
    gt_file = os.path.join(synthetic.DEFAULT_KITTI_ROOT, "poses", "00.txt")
    ev = json.loads(cli("eval", "--trajectory", os.path.join(out, "trajectory.npz"), "--poses", gt_file))
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    if not (np.isfinite(ev["ate"]["rmse"]) and np.isfinite(m["ate"]["rmse"]) and set(ev) == {"ate", "rpe", "xz_mean", "xz_max"}):
        raise AssertionError(f"eval: {ev}")
    print(
        f"[10] run --synthetic --frames 12 --ba --loop-closure --checkpoint-every 8: {first.splitlines()[-2]}; --resume "
        f"(frames 8-11): {second.splitlines()[-2]}, poses differ by {d_cli:.3e} m; eval ATE rmse {ev['ate']['rmse']:.5f} m; "
        + ("figures written" if have_figures else "figure files not asserted: matplotlib is not installed")
    )

    # (the mesh from the shell: a world of one in process, and a mesh larger than the machine)
    meshed = cli("run", "--synthetic", "--frames", "12", "--mesh", "1,1", "--out", os.path.join(tmp, "cli_mesh"))
    poses_meshed = np.load(os.path.join(tmp, "cli_mesh", "trajectory.npz"))["poses"]
    n_cards = torch.cuda.device_count()
    refused = cli("run", "--synthetic", "--frames", "12", "--mesh", f"2,{n_cards}", "--out", os.path.join(tmp, "cli_mesh2"), expect=2)
    want = f"--mesh 2x{n_cards} needs {2 * n_cards} devices, have {n_cards}"
    if "mesh: {'data': 1, 'model': 1} over 1 gpu devices" not in meshed or poses_meshed.shape != (11, 4, 4) or want not in refused:
        raise AssertionError(f"--mesh from the shell:\n{meshed}\n{refused}")
    print(f"     run --mesh 1,1: {meshed.splitlines()[-2]}; run --mesh 2,{n_cards} exits 2: {refused.strip().splitlines()[-1]}")

    # (a KITTI directory of 10 rendered frames on disk)
    n = 10
    seq_dir = os.path.join(tmp, "kitti", "00")
    for cam in (0, 1):
        os.makedirs(os.path.join(seq_dir, f"image_{cam}"))
    with open(os.path.join(synthetic.DEFAULT_KITTI_ROOT, "00", "calib.txt")) as src, open(os.path.join(seq_dir, "calib.txt"), "w") as dst:
        dst.write(src.read())
    np.savetxt(os.path.join(seq_dir, "times.txt"), np.arange(n) * runner.KITTI_DT)
    for i in range(n):
        for cam, im in enumerate(feed.frame(i)):
            write_png_gray(os.path.join(seq_dir, f"image_{cam}", f"{i:06d}.png"), im.cpu().numpy())
    seq = kitti.StereoSequence(seq_dir, poses_path=gt_file)
    try:
        if len(seq) != n or seq.times.shape != (n,):
            raise AssertionError(f"StereoSequence found {len(seq)} frames")
        for cam, im in enumerate(feed.frame(3)):
            if not torch.equal(runner.to_device(seq.frame(3)[cam], device), im):  # as the runner quantizes it
                raise AssertionError("a decoded frame differs from the frame that was written")
        from_disk = runner.run_sequence(seq, cfg, device=device)
    finally:
        seq.close()
    from_memory = runner.run_sequence(feed, cfg, n_frames=n, device=device)
    d_disk = require_same_run(from_disk, from_memory, run_to_run, "frames from the KITTI directory against frames from memory")
    out_data = os.path.join(tmp, "cli_data")
    text = cli("run", "--data", seq_dir, "--poses", gt_file, "--out", out_data)
    d_sub = float(np.abs(np.load(os.path.join(out_data, "trajectory.npz"))["poses"] - from_memory.poses).max())
    if f"image decoder: {seq.decoder}" not in text or not d_sub <= max(10.0 * run_to_run, 0.0):
        raise AssertionError(f"run --data: poses differ from the in-memory run's by {d_sub}:\n{text}")
    print(
        f"     KITTI directory of {n} frames, decoder {seq.decoder}: StereoSequence in process against memory {d_disk:.3e} m, "
        f"run --data against memory {d_sub:.3e} m ({text.splitlines()[-2]})"
    )

    # (undistortion of a staged frame)
    img = feed.frame(0)[0].float() / 255.0
    model = undistort.DistortionModel(k1=-0.05, k2=0.002, p1=1e-4, p2=-1e-4)
    before = dict(graphs.PROGRAMS["undistort_warp"])
    und = undistort.Undistorter(feed.calib, model, device=device)
    on_card = und(img)
    right = und(feed.frame(0)[1].float() / 255.0)  # the graph's second replay: the first result is the caller's copy
    eager = undistort.Undistorter(feed.calib, model, device=device, graph=False)
    on_cpu = undistort.Undistorter(feed.calib, model, device="cpu")(img.cpu())
    d_und = float((on_card.cpu() - on_cpu).abs().max())
    if undistort.Undistorter(feed.calib, device=device)(img) is not img:
        raise AssertionError("the identity model did not return its input")
    if not (d_und <= UNDISTORT_TOL and on_card.device.type == "cuda" and float((on_card - img).abs().max()) > 1e-3):
        raise AssertionError(f"Undistorter on the card differs from the CPU by {d_und}")
    warp = {k: graphs.PROGRAMS["undistort_warp"][k] - before[k] for k in ("captures", "replays")}
    if not (isinstance(und._warp, graphs.ByShape) and warp == {"captures": 1, "replays": 2}):
        raise AssertionError(f"the Undistorter's warp was not one captured graph replayed twice: {warp}")
    if not (torch.equal(on_card, eager(img)) and torch.equal(right, eager(feed.frame(0)[1].float() / 255.0))):
        raise AssertionError("the graphed Undistorter differs from graph=False")
    print(f"     Undistorter (k1 {model.k1}) on a staged frame: graphed ({warp}) equal to graph=False bit for bit, card "
          f"against CPU {d_und:.2e}; {time.perf_counter() - t:.1f} s")


def ransac_problem(cfg: PipelineConfig, device):
    """Correspondences between GT frames 2 and 3 at the step's capacity (cfg.max_tracks rows, the
    unused ones masked): 0.3 px noise, 30 % outliers."""
    root = synthetic.DEFAULT_KITTI_ROOT
    calib = kitti.load_stereo_calib(f"{root}/00")
    gt = kitti.read_poses(f"{root}/poses/00.txt")
    rng = np.random.default_rng(0)
    lm = synthetic.scatter_landmarks(rng, gt[:10], 3000)
    tr = synthetic.make_tracks(rng, calib, gt[2], gt[3], lm, noise_px=0.3, outlier_frac=0.3, max_points=cfg.max_tracks)
    n, cap = tr.px_cur_l.shape[0], cfg.max_tracks

    def rows(a):
        out = np.zeros((cap,) + a.shape[1:], np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    calib = calib.to(device)
    mask = (torch.arange(cap) < n).to(device)
    return rows(tr.px_cur_l), triangulate_rectified(rows(tr.px_prev_l), rows(tr.px_prev_r), calib), mask, calib, tr.rel_pose


def window_problem(cfg: PipelineConfig, device) -> window.BAProblem:
    """A full window at the solver's capacity: cfg.ba.window GT keyframes two frames apart observing
    cfg.ba.max_points landmarks, 0.3 px noise, perturbed initial poses and landmarks."""
    root = synthetic.DEFAULT_KITTI_ROOT
    calib = kitti.load_stereo_calib(f"{root}/00")
    K, M = cfg.ba.window, cfg.ba.max_points
    gt = kitti.read_poses(f"{root}/poses/00.txt")[: 2 * K : 2]
    rng = np.random.default_rng(0)
    lms = synthetic.scatter_landmarks(rng, gt, M)
    H, W = calib.image_size
    P1, P2 = (P.numpy().astype(np.float64) for P in (calib.P1, calib.P2))
    obs, obs_ur, msk = np.zeros((K, M, 2), np.float32), np.zeros((K, M), np.float32), np.zeros((K, M), bool)
    for k in range(K):
        cam = synthetic._w2c_apply(gt[k], lms)
        safe = np.where(cam[:, 2:3] > 1.0, cam, [0, 0, 10.0])
        px, pxr = synthetic.project_np(P1, safe), synthetic.project_np(P2, safe)
        msk[k] = (cam[:, 2] > 1.0) & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
        obs[k] = px + rng.normal(scale=0.3, size=px.shape)
        obs_ur[k] = pxr[:, 0] + rng.normal(scale=0.3, size=M)
    T0 = gt.astype(np.float32).copy()
    T0[1:, :3, 3] += rng.normal(scale=0.05, size=(K - 1, 3)).astype(np.float32)
    X0 = (lms + rng.normal(scale=0.3, size=lms.shape)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return window.BAProblem(
        T_c2w=t(T0), X=t(X0), obs_uv=t(obs), obs_mask=t(msk), obs_ur=t(obs_ur), obs_ur_mask=t(msk.copy()),
        X_mask=torch.ones(M, dtype=torch.bool, device=device), kf_mask=torch.ones(K, dtype=torch.bool, device=device),
    )


def graph_problem(device, K: int = 33) -> pose_graph.PoseGraph:
    """K GT poses five frames apart chained by their odometry edges, two of them displaced."""
    gt = kitti.read_poses(f"{synthetic.DEFAULT_KITTI_ROOT}/poses/00.txt")[: 5 * K : 5]
    T = torch.from_numpy(gt.astype(np.float32)).to(device)
    edges = pose_graph.odometry_edges(T)
    pert = T.clone()
    pert[3, :3, 3] += torch.tensor([0.2, -0.1, 0.15], device=device)
    pert[K // 2, :3, 3] += torch.tensor([-0.15, 0.05, 0.2], device=device)
    return pose_graph.PoseGraph(pert, *edges)


def same_bits(a, b, what: str) -> None:
    for name, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} of the sharded call differs from the single-device function's")


def nccl_one_rank(feed, cfg: PipelineConfig, device, tmp: str) -> None:
    """Phase 11: the four sharded entry points on a (1, 1) mesh over NCCL, each against its
    single-device function, bit for bit and without a host wait."""
    torch.distributed.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", world_size=1, rank=0)
    try:
        nccl_world_of_one(feed, cfg, device, tmp)
    finally:
        # A process that exits with an NCCL group up waits on its store for good: leave the world first.
        torch.distributed.destroy_process_group()


def nccl_world_of_one(feed, cfg: PipelineConfig, device, tmp: str) -> None:
    mesh = mesh_mod.make_mesh(MeshConfig(data=1, model=1), device=device)
    backends = {ax: torch.distributed.get_backend(mesh.get_group(ax)) for ax in ("data", "model")}
    if set(backends.values()) != {"nccl"}:
        raise AssertionError(f"the mesh's groups are not NCCL groups: {backends}")

    px, X, mask, calib, rel = ransac_problem(cfg, device)
    prob = window_problem(cfg, device)
    graph = graph_problem(device)
    imgs = torch.stack([im for i in range(2) for im in feed.frame(i)]).float() / 255.0
    gens = [torch.Generator(device=device) for _ in range(2)]

    def seeded(i):
        gens[i].manual_seed(7)
        return gens[i]

    graph_iters = 8
    cases = {
        "estimate_world_pose_sharded": (
            lambda: ransac_sharded.estimate_world_pose_sharded(px, X, mask, calib, cfg.ransac, seeded(0), mesh),
            lambda: ransac.estimate_world_pose(px, X, mask, calib, cfg.ransac, gen=seeded(1)),
            "per RANSAC call",
        ),
        "solve_window_sharded": (
            lambda: ba_sharded.solve_window_sharded(prob, calib, cfg.ba, mesh),
            lambda: window.solve_window(prob, calib, cfg.ba),
            f"per window solve of {cfg.ba.iters} iterations",
        ),
        "optimize_sharded": (
            lambda: pose_graph_sharded.optimize_sharded(graph, mesh, iters=graph_iters),
            lambda: pose_graph.optimize(graph, iters=graph_iters),
            f"per graph solve of {graph_iters} iterations",
        ),
        "detect_batch": (
            lambda: frontend_batch.detect_batch(imgs, cfg.sift, mesh),
            lambda: detect_and_describe(imgs, cfg.sift),
            f"per detection call of {imgs.shape[0]} images",
        ),
    }
    print(f"[11] the mesh over NCCL, world of one on the card: mesh {mesh_mod.mesh_shape(mesh)}, groups {backends}")
    for name, (sharded, single, per) in cases.items():
        got, want = sharded(), single()  # also the warm call: NCCL builds its communicator on first use
        torch.cuda.synchronize()
        same_bits(got, want, name)
        mesh_mod.reset_collectives()
        torch.cuda.set_sync_debug_mode("error")  # a host wait inside the sharded call raises
        try:
            sharded()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        n_coll = dict(mesh_mod.COLLECTIVES)
        if sum(n_coll.values()) < 1:
            raise AssertionError(f"{name} made no collective")
        ms_sharded, ms_single = median_ms(sharded, reps=5), median_ms(single, reps=5)
        print(f"     {name}: equal to the single-device function bit for bit, no host wait; collectives {per} "
              f"{n_coll}; {ms_sharded:.3f} ms sharded against {ms_single:.3f} ms single between CUDA events (the host's time "
              f"to enqueue the call where that is the longer)")
    est = cases["estimate_world_pose_sharded"][0]()
    d_t = float(np.linalg.norm(est.pose_c2w.cpu().numpy()[:3, 3] - rel[:3, 3]))
    res = cases["solve_window_sharded"][0]()
    if not (bool(est.ok) and d_t < 0.1 and float(res.cost) < 0.05 * float(res.cost0)):
        raise AssertionError(f"sharded RANSAC {d_t} m from the true pose, or the window solve did not converge: {res.cost0} -> {res.cost}")
    print(f"     sharded RANSAC {d_t:.4f} m from the true relative pose; window cost {float(res.cost0):.1f} -> {float(res.cost):.1f}")

    # (the same four captured: each a StaticCall whose graph holds its collectives)
    gen = torch.Generator(device=device)
    graphed = {
        "estimate_world_pose_sharded": (
            lambda: ransac_sharded.estimate_world_pose_sharded(px, X, mask, calib, cfg.ransac, gen, mesh), (gen,)),
        "solve_window_sharded": (lambda: ba_sharded.solve_window_sharded(prob, calib, cfg.ba, mesh), ()),
        "optimize_sharded": (lambda: pose_graph_sharded.optimize_sharded(graph, mesh, iters=graph_iters), ()),
        "detect_batch": (lambda: frontend_batch.detect_batch(imgs, cfg.sift, mesh), ()),
    }
    for name, (fn, gens) in graphed.items():
        gen.manual_seed(7)
        t_cap = time.perf_counter()
        call = graphs.StaticCall(fn, (), device, name, generators=gens)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t_cap
        gen.manual_seed(7)
        got = [t.clone() for t in call()]
        gen.manual_seed(7)
        want = list(fn())
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: the replay differs from the eager sharded call")
        mesh_mod.reset_collectives()
        torch.cuda.set_sync_debug_mode("error")  # a host wait inside the replay raises
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        replayed = dict(mesh_mod.COLLECTIVES)
        mesh_mod.reset_collectives()
        fn()
        if not (replayed == mesh_mod.COLLECTIVES == call.captured.collectives and sum(replayed.values()) >= 1):
            raise AssertionError(f"{name}: collectives per replay {replayed}, eager {mesh_mod.COLLECTIVES}, "
                                 f"captured {call.captured.collectives}")
        by, copies, host = replay_trace(call, os.path.join(tmp, "nccl_replay.json"))
        # Besides the one cudaGraphLaunch, only a registered generator's prologue (its seed and offset
        # written into the graph's device scalars: two fills) may launch anything.
        prologue = [k for k, v in by.items() if v != {"cudaGraphLaunch"}]
        extra = sum(v for k, v in host.items() if k != "cudaGraphLaunch")
        if (host.get("cudaGraphLaunch") != 1 or extra > 2 * len(gens)
                or not all("fill" in k.lower() for k in prologue)):
            raise AssertionError(f"{name}: the replay's host launches {host}, its kernels launched by {by}")
        ms_graph, ms_eager = median_ms(call, reps=5), median_ms(fn, reps=5)
        print(f"     {name} captured ({capture_s:.3f} s): replay equal to the eager call bit for bit, no host wait; "
              f"collectives per replay {replayed} = eager = captured; the replay's trace: host launches {host}, "
              f"{len(by) - len(prologue)} kernels by cudaGraphLaunch, {len(prologue)} before it, {len(copies)} copies; {ms_graph:.3f} ms per replay "
              f"against {ms_eager:.3f} ms eager")
    print("     (NCCL runs a world of one without a kernel of its own: its all-gather is a device-to-device copy, an "
          "all-reduce in place nothing; NCCL kernels under cudaGraphLaunch need two cards: tools/profile_torch_step.py --cards)")

    # (run_sequence on the (1, 1) mesh: no axis > 1, no collective, so its step is captured)
    captures = []
    capture = graphs.capture

    def counting(*a, **k):
        captures.append(1)
        return capture(*a, **k)

    one = dataclasses.replace(cfg, fused_group=1)
    single = runner.run_sequence(feed, one, device=device)
    graphs.capture = counting
    try:
        meshed = runner.run_sequence(feed, cfg, mesh=mesh, device=device)
    finally:
        graphs.capture = capture
    require_bit_equal(meshed, single, "run_sequence on the (1, 1) NCCL mesh against the single-process run at fused_group=1")
    if len(captures) != 1:
        raise AssertionError(f"the (1, 1) mesh's run captured {len(captures)} graphs, expected its step's one")
    print(f"     run_sequence on the (1, 1) NCCL mesh, {N_FRAMES} frames: its step captured once, bit-equal to the "
          f"single-process graphed run at fused_group=1; {meshed.per_frame_ms:.3f} against {single.per_frame_ms:.3f} ms/frame")


class ArrayFeed:
    """A feed over frames saved as one uint8 array [N, 2, H, W] (what a launched rank reads)."""

    def __init__(self, path: str, calib, gt_poses):
        self.frames = np.load(path)
        self.calib, self.gt_poses = calib, gt_poses

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int):
        return self.frames[i, 0], self.frames[i, 1]


def save_frames(feed, n: int, path: str) -> None:
    np.save(path, np.stack([np.stack([im.cpu().numpy() for im in feed.frame(i)]) for i in range(n)]))


def record_collectives(mesh, order: list) -> None:
    """Append (issuing thread: "main" or "worker", the mesh axis, kind) to ``order`` at every collective
    this process issues from now on."""
    axes = {tuple(dist.get_process_group_ranks(mesh.get_group(a))): a for a in mesh.mesh_dim_names}

    def recorded(kind, fn):
        def call(t, group):
            role = "main" if threading.current_thread() is threading.main_thread() else "worker"
            order.append((role, axes[tuple(dist.get_process_group_ranks(group))], kind))
            return fn(t, group)

        return call

    mesh_mod.all_gather = recorded("all_gather", mesh_mod.all_gather)
    mesh_mod.all_reduce_sum_ = recorded("all_reduce", mesh_mod.all_reduce_sum_)
    ba_sharded.all_gather = mesh_mod.all_gather  # imported there by name


def mesh_rank(mesh, device, frames_path: str, gt_poses, use_ba: bool) -> dict:
    """One rank of phase 12: run_sequence(mesh=) over the saved frames at the default config."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    calib = kitti.load_stereo_calib(f"{synthetic.DEFAULT_KITTI_ROOT}/00")
    seq = ArrayFeed(frames_path, calib, gt_poses)
    feed = runner.StagedSequence(seq, len(seq), device)
    cfg = PipelineConfig()
    batches = []
    k1 = kernels.extrema_scores_octaves

    def spy(dogs, *a, **k):
        batches.append(int(dogs[0].shape[0]))
        return k1(dogs, *a, **k)

    kernels.extrema_scores_octaves = spy
    order: list = []
    record_collectives(mesh, order)
    runner.run_sequence(feed, cfg, mesh=mesh, device=device, use_ba=use_ba)  # warm run
    order.clear()
    batches.clear()
    kernels.reset_launches()
    mesh_mod.reset_collectives()
    graphs.reset_programs()
    res = runner.run_sequence(feed, cfg, mesh=mesh, device=device, use_ba=use_ba)
    out = dict(
        poses=res.poses, pose_ok=res.pose_ok, n_inliers=res.n_inliers, per_frame_ms=res.per_frame_ms,
        launches=dict(kernels.LAUNCHES), collectives=dict(mesh_mod.COLLECTIVES), batches=sorted(set(batches)),
        n_keyframes=res.refine_stats.get("n_keyframes"), ba_solves=res.refine_stats.get("ba_solves"),
        programs={k: {n: v[n] for n in ("captures", "replays")} for k, v in graphs.PROGRAMS.items()},
        order=list(order),
    )
    if use_ba:
        # Over gloo the step and the sharded solve are eager by rule; the association is still a graph.
        eager = runner.run_sequence(feed, cfg, mesh=mesh, device=device, use_ba=use_ba, graph=False)
        out["eager"] = {k: getattr(eager, k) for k in ("poses", "rel_poses", "n_inliers", "n_tracks", "pose_ok", "landmarks")}
        out["eager"]["refine"] = [eager.refine_stats[k] for k in ("n_keyframes", "ba_solves")]
        out["graphed"] = {k: getattr(res, k) for k in ("rel_poses", "n_tracks", "landmarks")}
    return out


def shared_card_mesh(feed, feed5, cfg: PipelineConfig, device, single: runner.RunResult, gt, tmp: str, launches_by_path: dict) -> None:
    """Phase 12: four ranks share the card over gloo."""

    def launched(shape, frames_path, gt_poses, use_ba):
        t = time.perf_counter()
        per_rank = mesh_mod.launch(
            mesh_rank, shape, device, backend="gloo", args=(frames_path, gt_poses, use_ba), timeout=MESH_TIMEOUT_S, threads=2
        )
        for r, out in enumerate(per_rank):
            for k in ("poses", "pose_ok", "n_inliers"):
                if not np.array_equal(out[k], per_rank[0][k]):
                    raise AssertionError(f"mesh {shape}: {k} of rank {r} differs from rank 0's")
            if min(out["launches"].values()) <= 0:
                raise AssertionError(f"mesh {shape}: rank {r} never launched a kernel: {out['launches']}")
            if out["order"] != per_rank[0]["order"]:
                raise AssertionError(f"mesh {shape}: rank {r} issued its collectives in another order than rank 0")
            if {role for role, _, _ in out["order"]} != {"main"}:
                raise AssertionError(f"mesh {shape}: rank {r} issued collectives from {sorted({o[0] for o in out['order']})}")
        order = per_rank[0]["order"]
        print(f"     mesh {shape}: every rank issued the same {len(order)} collectives in one order, all from the frame "
              f"loop's thread ({sorted(collections.Counter((a, k) for _, a, k in order).items())})")
        return per_rank, time.perf_counter() - t

    path = os.path.join(tmp, "frames30.npy")
    save_frames(feed, N_FRAMES, path)
    per_rank, secs = launched((2, 2), path, gt, False)
    m = per_rank[0]
    launches_by_path["mesh_2x2_rank0"] = m["launches"]
    d = float(np.linalg.norm(m["poses"][:, :3, 3] - single.poses[:, :3, 3], axis=1).max())
    ate_m, ate_1 = metrics.ate(m["poses"], gt)["rmse"], metrics.ate(single.poses, gt)["rmse"]
    print(
        f"[12] four ranks share the card over gloo, mesh (2, 2), {N_FRAMES} frames at the default config: every rank's poses "
        f"equal bit for bit; against phase 4's single-process run max |dt| {d:.3e} m, ATE rmse {ate_m:.5f} m against "
        f"{ate_1:.5f} m; detection batches {[o['batches'] for o in per_rank]}, launches per rank {[o['launches'] for o in per_rank]}, "
        f"collectives on rank 0 {m['collectives']} ({sum(m['collectives'].values()) / N_FRAMES:.2f} per frame); "
        f"{m['per_frame_ms']:.3f} ms/frame meshed against {single.per_frame_ms:.3f} ms/frame single-process: the overhead of "
        f"the integration on one shared card, not scaling; {secs:.1f} s with the ranks' start-up"
    )
    if not (d < MESH_POSE_TOL_M and np.array_equal(m["pose_ok"], single.pose_ok) and abs(ate_m - ate_1) < MESH_ATE_TOL_M):
        raise AssertionError(f"the meshed run left the single-process run: {d} m, ATE {ate_m} against {ate_1}")
    if any(o["batches"] != [1] for o in per_rank):
        raise AssertionError(f"a \"data\" axis of 2 must give every rank a detection batch of one image: {[o['batches'] for o in per_rank]}")

    path = os.path.join(tmp, "frames60.npy")
    save_frames(feed5, MESH_BA_FRAMES, path)
    gt60 = feed5.gt_poses[:MESH_BA_FRAMES]
    first60 = ArrayFeed(path, feed5.calib, gt60)
    one = runner.run_sequence(runner.StagedSequence(first60, MESH_BA_FRAMES, device), cfg, use_ba=True, device=device)
    per_rank, secs = launched((1, 2), path, gt60, True)
    m = per_rank[0]
    launches_by_path["mesh_1x2_ba_rank0"] = m["launches"]
    d = float(np.linalg.norm(m["poses"][:, :3, 3] - one.poses[:, :3, 3], axis=1).max())
    print(
        f"     mesh (1, 2) with window BA, {MESH_BA_FRAMES} frames: ranks equal bit for bit; keyframes {m['n_keyframes']}, accepted "
        f"solves {m['ba_solves']} (single-process {one.refine_stats['n_keyframes']}, {one.refine_stats['ba_solves']}); max |dt| "
        f"{d:.3e} m; collectives on rank 0 {m['collectives']}; {m['per_frame_ms']:.3f} ms/frame meshed against "
        f"{one.per_frame_ms:.3f} ms/frame single-process (overhead on one shared card, not scaling); {secs:.1f} s"
    )
    if m["n_keyframes"] != one.refine_stats["n_keyframes"] or not m["ba_solves"] >= 1 or not d < MESH_POSE_TOL_M:
        raise AssertionError("the meshed BA run does not have the single-process run's keyframes, or no solve was accepted")
    for r, o in enumerate(per_rank):
        assoc = o["programs"].get("keyframe_association", {})
        if not (assoc.get("captures", 0) > 0 and assoc.get("replays", 0) > 0) or "window_solve" in o["programs"]:
            raise AssertionError(f"rank {r}: the association is not a graph, or the gloo-sharded solve is: {o['programs']}")
        graphed = dict(o["graphed"], poses=o["poses"], n_inliers=o["n_inliers"], pose_ok=o["pose_ok"])
        for k, v in o["eager"].items():
            want = [o["n_keyframes"], o["ba_solves"]] if k == "refine" else graphed[k]
            if not np.array_equal(v, want):
                raise AssertionError(f"mesh (1, 2) with BA, rank {r}: {k} with graph=False differs from the graphed run's")
    print(f"     the same with graph=False: equal bit for bit on every rank (poses, rel poses, n_inliers, n_tracks, pose_ok, "
          f"landmarks, keyframes, solves); programs captured and replayed per rank {[o['programs'] for o in per_rank]} "
          f"(the step and the sharded solve reduce over gloo: eager by rule)")


def bench_surface(feed5, cfg: PipelineConfig, device, ate4: float, launches_by_path: dict) -> None:
    """Phase 13: the port's bench and long-run matrix, in process."""
    from vo_tpu_torch import bench

    t = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = counted(launches_by_path, "bench", lambda: bench.main(["--repeats", "3", "--sustained-frames", "0", "--stages"]))
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 2:
        raise AssertionError(f"bench.main returned {rc} and printed {len(lines)} lines:\n{out.getvalue()[-4000:]}")
    line, stages = json.loads(lines[0]), json.loads(lines[1])["stage_breakdown"]
    t_bench = time.perf_counter() - t
    la = launches_by_path["bench"]
    print(f"[13] bench.main --repeats 3 --sustained-frames 0 --stages ({t_bench:.1f} s), launches {la}:\n{lines[0]}\n{lines[1]}")
    if not BENCH_KEYS <= set(line):
        raise AssertionError(f"the bench line lacks {sorted(BENCH_KEYS - set(line))}")
    if not (line["ate_rmse_m"] <= ATE_MAX_M and abs(line["ate_rmse_m"] - ate4) <= BENCH_ATE_TOL_M):
        raise AssertionError(f"bench ATE {line['ate_rmse_m']} m against phase 4's {ate4} m")
    if line["graphed"] is not True:
        raise AssertionError("the bench did not step through CUDA graphs")
    for st in BENCH_STAGES:
        vals = [stages[f"{st}_{k}"] for k in ("ms", "device_ms", "busy_ms")]
        if not (all(v is not None and np.isfinite(v) for v in vals) and stages[f"{st}_launches"] > 0):
            raise AssertionError(f"stage {st}: {[(k, v) for k, v in stages.items() if k.startswith(st)]}")
    if min(la[k] for k in (*KERNELS, K4)) <= 0:
        raise AssertionError(f"the bench did not launch both kernels: {la}")

    t = time.perf_counter()
    longrun = load_tool("longrun_torch")
    poses = feed5.gt_poses[:LONGRUN_FRAMES]
    payload = counted(launches_by_path, "longrun", lambda: longrun.run_matrix(feed5, poses, cfg, device))
    c = payload["configs"]
    print(f"     longrun_torch.run_matrix over the first {LONGRUN_FRAMES} frames of the phase-5 feed ({time.perf_counter() - t:.1f} s), "
          f"launches {launches_by_path['longrun']}")
    if set(c) != {"vo", "vo_lc", "vo_ba", "vo_ba_lc"}:
        raise AssertionError(f"run_matrix ran {sorted(c)}")
    for name, row in c.items():
        if not all(np.isfinite(row[k]) for k in ("ate_rmse_m", "ate_max_m", "xz_mean_m", "xz_max_m", "per_frame_ms")):
            raise AssertionError(f"{name}: {row}")
    want_kf = (LONGRUN_FRAMES - 1) // cfg.ba.keyframe_every
    if not c["vo_ba"]["n_keyframes"] == c["vo_ba_lc"]["n_keyframes"] == want_kf:
        raise AssertionError(f"keyframes vo_ba {c['vo_ba']['n_keyframes']}, vo_ba_lc {c['vo_ba_lc']['n_keyframes']}, expected {want_kf}")


def load_tool(name: str):
    """tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_scale_tools(feed5, cfg: PipelineConfig, device, launches_by_path: dict) -> None:
    """Phase 14: bigrun_torch.run_configs over phase 5's feed, loaded through severity_sweep_torch."""
    from vo_tpu_torch.bench import stage_frames

    t = time.perf_counter()
    sweep, bigrun = load_tool("severity_sweep_torch"), load_tool("bigrun_torch")
    n, gt = len(feed5), feed5.gt_poses
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "outback.npz")
        frames = [[im.cpu().numpy() for im in feed5.frame(i)] for i in range(n)]
        np.savez(cache, l=np.stack([f[0] for f in frames]), r=np.stack([f[1] for f in frames]), poses=gt)
        del frames
        pre = sweep.load_prefix(cache, n, SWEEP_EXTRA_NOISE)
    pre.calib = feed5.calib
    times = np.arange(n) * runner.KITTI_DT
    pre.times = times
    staged = stage_frames(pre, device)
    del pre
    t_load = time.perf_counter() - t
    small = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, max_keyframes=SMALL_CAPACITY))
    t = time.perf_counter()
    kept: dict = {}
    out = counted(launches_by_path, "bigrun",
                  lambda: bigrun.run_configs(staged, gt, times, small, ["vo", "vo_lc"], device, keep=kept))
    vo, lc = out["configs"]["vo"], out["configs"]["vo_lc"]
    keep = ("frames_per_sec", "ate_rmse_m", "xz_max_m", "pose_ok_frac", "peak_memory_bytes", "n_keyframes", "decimations",
            "lc_verified", "loops_closed", "main_wait_s")
    print(
        f"[14] bigrun_torch.run_configs over the {n}-frame feed (load_prefix at extra noise {SWEEP_EXTRA_NOISE}, "
        f"{t_load:.1f} s; runs {time.perf_counter() - t:.1f} s), loop capacity {SMALL_CAPACITY}, launches "
        f"{launches_by_path['bigrun']}:\n     vo {json.dumps({k: vo[k] for k in keep if k in vo})}\n"
        f"     vo_lc {json.dumps({k: lc[k] for k in keep if k in lc})}"
    )
    for name, row in out["configs"].items():
        vals = [row[k] for k in ("ate_rmse_m", "ate_max_m", "xz_mean_m", "xz_max_m", "per_frame_ms")]
        if not (all(np.isfinite(v) for v in vals) and row["pose_ok_frac"] >= POSE_OK_FRAC_MIN):
            raise AssertionError(f"{name}: {row}")
    want_kf = (n - 1) // cfg.ba.keyframe_every
    if (lc["n_keyframes"], lc["decimations"]) != (want_kf, SMALL_CAPACITY_DECIMATIONS):
        raise AssertionError(f"vo_lc: {lc['n_keyframes']} keyframes, {lc['decimations']} decimations; "
                             f"expected {want_kf} and {SMALL_CAPACITY_DECIMATIONS}")
    # A candidate must be min_gap keyframes older than the newest, and at most max_keyframes are archived.
    if small.loop.max_keyframes > small.loop.min_gap:
        raise AssertionError(f"capacity {small.loop.max_keyframes} > min_gap {small.loop.min_gap}: loops could close here")
    if lc["lc_verified"] != 0 or lc["loops_closed"] != 0 or not abs(lc["ate_rmse_m"] - vo["ate_rmse_m"]) <= REFINED_ATE_SLACK_M:
        raise AssertionError(f"vo_lc verified or closed a loop with no candidate possible, or left vo: {lc}")
    if min(launches_by_path["bigrun"][k] for k in (*KERNELS, K4)) <= 0:
        raise AssertionError(f"run_configs did not launch both kernels: {launches_by_path['bigrun']}")

    # The decimating vo_lc run again with graph=False: bit for bit, keyframes and decimations too.
    t = t_added = time.perf_counter()
    eager, eager_row, _ = counted(launches_by_path, "bigrun_eager",
                                  lambda: bigrun.run_one(staged, gt, small, "vo_lc", device, graph=False))
    require_bit_equal(kept["vo_lc"], eager, "phase 14: the decimating vo_lc run graphed against graph=False")
    stats = ("n_keyframes", "decimations", "lc_verified", "loops_closed")
    if [lc[k] for k in stats] != [eager_row[k] for k in stats] or bigrun.first_difference(kept["vo_lc"], eager) is not None:
        raise AssertionError(f"phase 14: graphed {[lc[k] for k in stats]} against eager {[eager_row[k] for k in stats]}")
    print(f"     vo_lc with graph=False ({time.perf_counter() - t:.1f} s, {eager_row['frames_per_sec']:.3f} fps, "
          f"peak memory {eager_row['peak_memory_bytes']} bytes): equal bit for bit to the graphed run, "
          f"{eager_row['n_keyframes']} keyframes, {eager_row['decimations']} decimations")
    del staged, kept, eager

    # The two diagnostic tools' hooks on the card: diag_ba_torch over the first frames of phase 5's feed
    # (graphed), diag_lc_torch over phase 6's closure feed.
    t = time.perf_counter()
    diag_ba, diag_lc = load_tool("diag_ba_torch"), load_tool("diag_lc_torch")
    _, log = counted(launches_by_path, "diag_ba", lambda: diag_ba.run(feed5, gt, cfg, device, DIAG_BA_FRAMES))
    t_ba = time.perf_counter() - t
    print(f"     diag_ba_torch over the first {DIAG_BA_FRAMES} frames of phase 5's feed ({t_ba:.1f} s): "
          f"{len(log.rows)} solves past the cost gate, {json.dumps(log.counts())}, last n_obs {log.last_n_obs}")
    for row in log.rows:
        print(f"       {json.dumps(row)}")
    if not (any(r["cost"] <= r["cost0"] for r in log.rows) and log.last_n_obs is not None and log.last_n_obs > 30):
        raise AssertionError(f"diag_ba_torch: no solve with cost <= cost0 and n_obs > 30 ({log.rows})")
    t = time.perf_counter()
    closures = diag_lc.ClosureLog()
    with closures.installed():
        counted(launches_by_path, "diag_lc", lambda: closure_fires(feed5, cfg, device, tag="     diag_lc_torch's hook:"))
    rows = closures.rows(gt)
    print(f"     diag_lc_torch over phase 6's feed ({time.perf_counter() - t:.1f} s): {len(rows)} closures")
    for row in rows:
        print(f"       {json.dumps(row)}")
    if not any(r["kf_rms_after"] < r["kf_rms_before"] for r in rows):
        raise AssertionError(f"diag_lc_torch: no closure brought the keyframes nearer the truth ({rows})")
    print(f"     phase 14's additions took {time.perf_counter() - t_added:.1f} s")


def replay_trace(fn, path: str) -> tuple:
    """fn() under torch.profiler -> ({device kernel: the host calls that launched it}, [names of the
    device copies and fills], {host launching call: count})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        tr = json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    copies = sorted(e["name"] for e in evs if e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    host: dict = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and e["name"] in HOST_LAUNCH_CALLS:
            host[e["name"]] = host.get(e["name"], 0) + 1
    return launched_by(path), copies, host


def launched_by(trace_path: str) -> dict:
    """{device kernel name: the host calls that launched it} from a chrome trace of torch.profiler: a
    kernel and the runtime call that launched it share a correlation id."""
    with open(trace_path) as f:
        tr = json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    calls = {e["args"]["correlation"]: e["name"] for e in evs
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in (e.get("args") or {})}
    out: dict = {}
    for e in evs:
        if e.get("cat") == "kernel":
            out.setdefault(e["name"], set()).add(calls.get((e.get("args") or {}).get("correlation"), "?"))
    return out


def require_bit_equal(a: runner.RunResult, b: runner.RunResult, what: str, fields=("poses", "rel_poses", "n_inliers",
                      "n_tracks", "pose_ok", "landmarks")) -> None:
    for k in fields:
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            raise AssertionError(f"{what}: {k} differs (max |pose difference| {max_diff(a, b)})")


def graphed_against_eager(feed, feed5, cfg: PipelineConfig, device, plain: runner.RunResult, refined: runner.RunResult,
                          resumed: dict, tmp: str, launches_by_path: dict) -> None:
    """Phase 15: the captured steps (utils.graphs) against the eager ones, the kernels inside a replay,
    and what the graphs change in the profile."""
    from vo_tpu_torch.odometry import landmarks, pipeline
    from vo_tpu_torch.utils import graphs

    t = time.perf_counter()
    # (paths: phase 4's and phase 5's runs stepped through CUDA graphs; the same runs eagerly)
    eager = runner.run_sequence(feed, cfg, device=device, graph=False)
    require_bit_equal(plain, eager, "plain path, graphed against eager")
    eager5 = runner.run_sequence(feed5, cfg, use_ba=True, use_loop_closure=True, device=device, graph=False)
    require_bit_equal(refined, eager5, "refined path, graphed against eager")
    require_refine_records(eager5, "phase 15, refined eager")
    keys = ("n_keyframes", "ba_solves", "lc_verified", "loops_closed")
    want_kf = (len(feed5) - 1) // cfg.ba.keyframe_every
    if [refined.refine_stats[k] for k in keys] != [eager5.refine_stats[k] for k in keys] or refined.refine_stats["n_keyframes"] != want_kf:
        raise AssertionError(f"refine stats graphed {refined.refine_stats} against eager {eager5.refine_stats}")
    if any(d != 0.0 for d in resumed.values()):
        raise AssertionError(f"a graphed resume is not bit-equal to the uninterrupted graphed run: {resumed}")
    # (track ids, frame by frame: make_jitted_step captured and eager over the 30-frame feed)
    calib = feed.calib.to(device)
    ids = {}
    for g in (None, False):
        step = pipeline.make_jitted_step(calib, cfg, graph=g)
        st, rows = pipeline.init_state(cfg, 0, device), []
        for i in range(len(feed)):
            st, out = step(st, *feed.frame(i))
            rows.append(torch.cat([st.prev.ids.float(), out.pose_c2w.flatten(), out.pose_ok.float()[None]]).cpu().numpy())
        ids[g] = np.stack(rows)
    if not np.array_equal(ids[None], ids[False]):
        raise AssertionError("make_jitted_step: track ids or poses differ between the graphed and the eager step")

    # (one replay: the kernels inside it, the launches it accounts, its capture time and the pools' memory)
    pool = graphs.Pool(device)
    stepN = pipeline.make_fused_multi_step(calib, cfg, with_landmarks=True, group=cfg.fused_group, pool=pool)
    step1 = pipeline.make_fused_loop_step(calib, cfg, with_landmarks=True, pool=pool)
    frames = [im for i in range(cfg.fused_group) for im in feed.frame(i)]
    torch.cuda.synchronize()
    t_cap = time.perf_counter()
    r = stepN(pipeline.init_state(cfg, 0, device), landmarks.init_map(cfg.landmarks, device), *frames)
    torch.cuda.synchronize()
    capture_group_s = time.perf_counter() - t_cap
    t_cap = time.perf_counter()
    step1(pipeline.init_state(cfg, 0, device), landmarks.init_map(cfg.landmarks, device), *frames[:2])
    torch.cuda.synchronize()
    capture_single_s = time.perf_counter() - t_cap
    pools_bytes = graphs.pools_bytes()
    r = counted(launches_by_path, "one_replay", lambda: stepN(r[0], r[1], *frames))
    if launches_by_path["one_replay"] != {**{k: 1 for k in KERNELS}, K3: cfg.fused_group, K4: k4_launches(cfg)}:
        raise AssertionError(f"one replay of the group step accounted {launches_by_path['one_replay']}, expected one launch "
                             f"of K1 and K2, one of K3 a frame and one detection call's of K4")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # Two replays: the trace of a single profiled replay lacked the step's first kernels (the pyramid's).
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            stepN(r[0], r[1], *frames)
        torch.cuda.synchronize()
    trace = os.path.join(tmp, "one_replay.json")
    prof.export_chrome_trace(trace)
    by = launched_by(trace)
    families = ("extrema_scores_kernel", "bin_maps_kernel", "pose_refine_kernel", "gauss_stack_kernel", "gauss_rows_kernel")
    hand = {name: sorted(v) for name, v in by.items() if any(k in name for k in families)}
    if any(not any(k in n for n in hand) for k in families) or any(v != ["cudaGraphLaunch"] for v in hand.values()):
        raise AssertionError(f"K1, K2, K3 and K4 were not launched by cudaGraphLaunch in a replay: {hand}")
    solver = sorted({n[:80] for n in by if any(k in n.lower() for k in ("getrf", "getrs", "magma", "trsm", "cusolver"))})
    n_kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    print(
        f"[15] graphed against eager: plain {len(feed)} frames and refined {len(feed5)} frames (the step, and the "
        f"window solve, verification round, association and global descriptor) bit-equal (poses, rel poses, "
        f"n_inliers, n_tracks, pose_ok, landmarks; refined keyframes {refined.refine_stats['n_keyframes']}, solves "
        f"{refined.refine_stats['ba_solves']}, verified {refined.refine_stats['lc_verified']}); make_jitted_step's track ids "
        f"and poses equal frame by frame; graphed resumes against uninterrupted graphed runs {json.dumps(resumed)}; "
        f"eager {eager.per_frame_ms:.3f} ms/frame plain, {eager5.per_frame_ms:.3f} refined, against graphed "
        f"{plain.per_frame_ms:.3f} and {refined.per_frame_ms:.3f}"
    )
    print(
        f"     two replays of the group step: {n_kernels} device events, K1, K2, K3 and K4 launched by {hand}; one "
        f"replay accounted {launches_by_path['one_replay']}; the 6x6 solve's kernels {solver}; first call (warm-up "
        f"+ capture + instantiate + replay) {capture_group_s:.3f} s for the group step, {capture_single_s:.3f} s for "
        f"the single-frame step; graph pools {pools_bytes} bytes"
    )
    del r, stepN, step1

    # (the refined path's four programs: the seconds of each capture and the bytes of each pool)
    from vo_tpu_torch.odometry.refiner import RefinerWorker

    t_cap = time.perf_counter()
    worker = RefinerWorker(feed5.calib, cfg, use_ba=True, use_loop_closure=True, device=device)
    kfs = runner._Keyframes(worker, cfg, device, use_ba=True, graph=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_cap
    calls = [worker.wba._call, *worker.lclo._rounds.calls.values(), *worker._gdesc.calls.values(), kfs._assoc]
    stats = [dict(program=c.name, capture_s=round(c.capture_s, 4), pool_bytes=c.pool.bytes()) for c in calls]
    worker.close()
    del worker, kfs, calls
    # (the solver kernels of the window solve's [6K, 6K] solve_ex, eager: what the backend PyTorch picks captured)
    prob, calib_dev = window_problem(cfg, device), feed.calib.to(device)
    window.solve_window(prob, calib_dev, cfg.ba)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window.solve_window(prob, calib_dev, cfg.ba)
        torch.cuda.synchronize()
    ba_solver = sorted({e.name[:80] for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                        and any(k in e.name.lower() for k in ("getrf", "getrs", "magma", "trsm", "gemv", "cusolver"))})
    print(f"     the refined path's programs (worker warm-up + association capture {build_s:.3f} s): {json.dumps(stats)}; "
          f"the window solve's solver kernels (backend {torch.backends.cuda.preferred_linalg_library()}) {ba_solver}")

    # (the profile: per frame, host launches, device busy and launches, idle share; graphed and eager)
    prof_tool = load_tool("profile_torch_step")
    n4, n5 = PROFILE_PLAIN_FRAMES, PROFILE_REFINED_FRAMES
    for name, g in (("graphed", None), ("eager", False)):
        for path, run, n in (
            ("plain", lambda w=True, g=g: runner.run_sequence(feed, cfg, n_frames=n4, device=device, warmup=w, graph=g), n4),
            ("refined", lambda w=True, g=g: runner.run_sequence(
                feed5, cfg, n_frames=n5, use_ba=True, use_loop_closure=True, device=device, warmup=w, graph=g), n5),
        ):
            untraced = run()
            _, loop = prof_tool.frame_loop_trace(lambda: run(w=False), n)
            loop.pop("kernel_ms_per_frame")
            row = dict(frames=n, wall_ms_per_frame=untraced.per_frame_ms,
                       device_idle_share=1.0 - loop["device_busy_ms_per_frame"] / untraced.per_frame_ms, **loop)
            if path == "refined":
                row["refine_stats"] = {k: v for k, v in untraced.refine_stats.items()
                                       if k in ("main_wait_s", "worker_ba_dispatch_s", "worker_lc_dispatch_s")}
            print(f"     profile, {path} {name} ({n} frames): {json.dumps(row)}")
    print(f"     phase 15 took {time.perf_counter() - t:.1f} s")


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[1] device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t = time.perf_counter()
    lib = kernels.build()
    kernels.load()
    print(f"[2] built {lib.name} from vo_tpu_torch/csrc in {time.perf_counter() - t:.2f} s")

    cfg = PipelineConfig()
    t = time.perf_counter()
    seq = synthetic.kitti_synthetic_sequence(n_frames=N_FRAMES, n_landmarks=N_LANDMARKS, seed=0)
    feed = runner.StagedSequence(seq, N_FRAMES, device)
    print(f"[3] rendered and staged {N_FRAMES} frames {seq.H}x{seq.W} in {time.perf_counter() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = check_kernels(feed, cfg)
    k3 = check_pose_refine(cfg, device)
    k4 = check_gauss_blur(feed, cfg)

    launches_by_path: dict = {}
    warm = runner.run_sequence(feed, cfg, n_frames=N_FRAMES, device=device)  # warm run
    res = counted(launches_by_path, "plain", lambda: runner.run_sequence(feed, cfg, n_frames=N_FRAMES, device=device))
    launches = launches_by_path["plain"]
    ate = metrics.ate(res.poses, np.asarray(seq.gt_poses))
    n_ok = int(res.pose_ok.sum())
    print(
        f"[4] main path, {N_FRAMES} frames at the default config: {res.frames_per_sec:.3f} fps, "
        f"{res.per_frame_ms:.3f} ms/frame, ATE rmse {ate['rmse']:.5f} m, pose_ok {n_ok}/{len(res.pose_ok)}, "
        f"median n_tracks {float(np.median(res.n_tracks)):.1f}, landmarks {res.landmarks.shape[0]}, launches {launches}"
    )
    if not np.isfinite(res.poses).all():
        raise AssertionError("non-finite pose in the main path's output")
    if res.poses.shape != (N_FRAMES - 1, 4, 4):
        raise AssertionError(f"expected {N_FRAMES - 1} poses, got {res.poses.shape}")
    if not ate["rmse"] <= ATE_MAX_M:
        raise AssertionError(f"ATE {ate['rmse']} m > {ATE_MAX_M} m")
    if n_ok < N_FRAMES - 2:
        raise AssertionError(f"pose_ok {n_ok} < {N_FRAMES - 2} of {N_FRAMES - 1}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the main path")

    t = time.perf_counter()
    feed5 = OutAndBackFeed(OUT_FRAMES, device)
    print(f"[5] rendered and staged {OUT_FRAMES} frames {feed5.H}x{feed5.W} for a {len(feed5)}-frame feed in "
          f"{time.perf_counter() - t:.1f} s")
    launches_by_path["refined"], refined = refined_path(feed5, cfg, device)
    closure_fires(feed5, cfg, device)

    with tempfile.TemporaryDirectory() as tmp:
        found = resume_on_the_card(feed5, cfg, device, OUT_FRAMES, tmp, launches_by_path, refined=True, again=refined)
        plain_found = resume_on_the_card(feed, cfg, device, N_FRAMES // 2, tmp, launches_by_path, refined=False)
        d_warm = max_diff(warm, res)
        print(f"    phase 4's two deferred runs differ by {d_warm:.3e} m")
        run_to_run = max(plain_found["run_to_run"], d_warm)
        host_paths(feed, cfg, device, res, tmp, launches_by_path, run_to_run)
        exact_sift(feed, cfg, device, np.asarray(seq.gt_poses), res.frames_per_sec, launches_by_path)
        shell_surface(feed, cfg, device, tmp, max(run_to_run, found["run_to_run"]))
        nccl_one_rank(feed, cfg, device, tmp)
        shared_card_mesh(feed, feed5, cfg, device, res, np.asarray(seq.gt_poses), tmp, launches_by_path)
    bench_surface(feed5, cfg, device, ate["rmse"], launches_by_path)
    reference_scale_tools(feed5, cfg, device, launches_by_path)
    with tempfile.TemporaryDirectory() as tmp:
        resumed = {"refined": found["resumed_diff"], "plain": plain_found["resumed_diff"]}
        graphed_against_eager(feed, feed5, cfg, device, res, refined, resumed, tmp, launches_by_path)
    launches = {k: sum(v[k] for v in launches_by_path.values()) for k in KERNELS}

    summary = [
        dict(
            name=k,
            route="cuda",
            source=meta["source"],
            replaces=meta["replaces"],
            launches=launches[k],
            launches_by_path={path: v[k] for path, v in launches_by_path.items()},
            launches_per_detect_call=stats[k]["launches_per_detect_call"],
            max_abs_err=stats[k]["max_abs_err"],
            max_abs_err_by_batch=stats[k]["max_abs_err_by_batch"],
            ms=stats[k]["ms"],
            octave0_ms=stats[k]["octave0_ms"],
            per_octave_launches_ms=stats[k]["per_octave_launches_ms"],
            copy_same_bytes_ms=stats[k]["copy_same_bytes_ms"],
            back_to_back_ms=stats[k]["back_to_back_ms"],
            plain_ms=stats[k]["plain_ms"],
            bound_ms=stats[k]["bound_ms"],
            bound_by=stats[k]["bound_by"],
            share_of_bound=stats[k]["share_of_bound"],
            library_ms=None,
        )
        for k, meta in KERNELS.items()
    ]
    summary.append(dict(
        name=K3, route="cuda", source="vo_tpu_torch/csrc/pose_refine.cu", replaces=None,
        launches=sum(v[K3] for v in launches_by_path.values()),
        launches_by_path={path: v[K3] for path, v in launches_by_path.items()},
        **{k: k3[k] for k in ("n", "iters", "pose_gap_m", "pose_gap_rad", "inliers_differ", "mean_err_gap", "ms",
                              "back_to_back_ms", "plain_ms", "plain_graph_ms", "floor_ms", "floor_share", "bound_ms",
                              "bound_by")},
        library_ms=None,
    ))
    summary.append(dict(
        name=K4, route="cuda", source="vo_tpu_torch/csrc/gauss_blur.cu", replaces=None,
        launches=sum(v[K4] for v in launches_by_path.values()),
        launches_by_path={path: v[K4] for path, v in launches_by_path.items()},
        **{k: k4[k] for k in ("launches_per_detect_call", "max_abs_err", "max_abs_err_by_batch", "differ_by_batch", "ms",
                              "pyramid_ms", "map_rows_ms", "back_to_back_ms", "plain_ms", "bound_ms", "bound_by",
                              "share_of_bound")},
        library_ms=None,
    ))
    print(f"chip_smoke took {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
