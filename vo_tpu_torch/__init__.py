"""vo_tpu_torch — vo_tpu's VO main path and refined path in PyTorch, with CUDA kernels.

A module-for-module port of the JAX package ``vo_tpu`` (which stays the
reference): same layout and names, PyTorch idiom inside. The two Pallas TPU
kernels of the front-end are hand-written CUDA C++ for Hopper (``csrc/``),
built with ``nvcc`` at first use (``frontend/kernels.py``).

Ported so far: ``odometry.runner.run_sequence`` on the plain path and on the
refined path (window BA + loop closure through the background refiner), with
no checkpoint/resume and no mesh. The package imports ``torch`` and never
``jax``; it shares only the jax-free ``vo_tpu.config`` and ``vo_tpu.eval.metrics``.

Subpackages:
  geom      SE(3), stereo calibration, rectified triangulation
  io        KITTI parsers, synthetic KITTI-geometry renderer
  frontend  pyramid, CUDA kernels, SIFT detection + dense descriptors, matching, tracking
  pose      P3P, RANSAC
  odometry  per-frame VO step, landmark store, sequence runner, window-BA runner, refiner
  ba        sliding-window bundle adjustment, host pose-graph solve
  slam      loop closure
  eval      trajectory metrics (re-exported)
  utils     fixed-capacity padding/masking, non-waiting host/device copies
"""

__version__ = "0.1.0"
