"""vo_tpu_torch — vo_tpu's VO engine (main path, refined path, runtime surface, device mesh) in PyTorch, with CUDA kernels.

A module-for-module port of the JAX package ``vo_tpu`` (which stays the
reference): same layout and names, PyTorch idiom inside. The two Pallas TPU
kernels of the front-end (K1, K2), the pyramid's blurs (K4), RANSAC's consensus
refinement (K3) and the tracer's stage stamp are hand-written CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` at first use into one library and
launched and counted through ``utils/cuda_lib.py``.

Ported: ``odometry.runner.run_sequence`` on the plain path and on the refined
path (window BA + loop closure through the background refiner), with
checkpoint/resume (the refiner's state included; the files are the
reference's format), the per-frame ``progress`` / ``metrics_path`` /
``viz_every`` options, the command line (``python -m vo_tpu_torch run|eval``:
the card unless ``--cpu``; ``--checkpoint-every N`` and ``--resume``), the
Lowe-exact SIFT oracle path (``SIFTConfig(fast_descriptor=False)``),
undistortion, the KITTI image feed, the dev utilities, and the device mesh on
``torch.distributed`` (``dist/``, ``run_sequence(mesh=)``, ``--mesh``: one
process per rank, NCCL with a card per rank, gloo on the CPU or on a shared
card), and the benchmark surface (``bench``: ``python -m vo_tpu_torch bench``,
``--stages``; the scoped matmul precision of ``utils.precision``). The package imports ``torch``, never ``jax`` and nothing of
``vo_tpu``: it keeps its own copies of the configuration, the trajectory
metrics, the profiling helpers and the figures. Its entry points run on the
CUDA card unless the caller passes ``device="cpu"``
(``utils.device.default_device``).

Subpackages:
  geom      SE(3) with logarithms and alignment, stereo calibration and projections, rectified and DLT triangulation
  io        KITTI parsers and image feed, native PNG decoder, undistortion, synthetic KITTI-geometry renderer
  frontend  pyramid, CUDA kernels, SIFT detection + dense and exact descriptors, matching, tracking
  pose      P3P, RANSAC
  odometry  per-frame VO step, landmark store, sequence runner, checkpoint, window-BA runner, refiner
  ba        sliding-window bundle adjustment, pose-graph solve (device float32, host float64)
  dist      device mesh and rank launcher, sharded RANSAC / window BA / pose graph / detection, smoke and harness
  slam      loop closure
  eval      trajectory metrics
  utils     the CUDA library (build, bind, launch, count), fixed-capacity padding/masking, non-waiting host/device
            copies, the default device, scoped matmul precision,
            profiling (the tracer: spans and device stage stamps; metrics JSONL, torch.profiler trace),
            debugging (non-finite trap, launch counts)
  viz       the reference's four figures (matplotlib, imported only where drawn)
"""

__version__ = "0.1.0"
