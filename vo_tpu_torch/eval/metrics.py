"""Trajectory metrics (xz error, ATE, RPE): re-exported from the jax-free vo_tpu.eval.metrics."""
from vo_tpu.eval.metrics import ate, rpe, xz_error  # noqa: F401
