"""Dev-mode debugging: non-finite trapping, launch counting, determinism checks
(port of vo_tpu.utils.debug).

The reference leans on XLA's switches (``jax_debug_nans``, ``jax_log_compiles``).
The port's step is eager tensor code, so the counterparts are:

- ``nan_debug``: while the context is open, the VO step checks the outputs of
  each of its stages (detection, stereo match, tracking, triangulation, RANSAC,
  chaining) with ``torch.isfinite`` and raises ``FloatingPointError`` naming the
  first stage that produced a non-finite value. Every check reads a value back
  from the device, so the step waits on the device at every stage: dev only.
  (``torch.autograd.set_detect_anomaly`` does not serve: nothing here records a
  graph.)
- ``compile_logging``: eager code has no retracing to catch; what creeps into a
  frame loop unnoticed is extra kernel launches. The context counts them: the
  hand-written kernels through ``frontend.kernels.LAUNCHES``, and every device
  kernel through ``torch.profiler`` where a CUDA card is present.
- ``check_determinism``: the same contract as the reference's, on tensors.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_state = threading.local()


def nan_checks_enabled() -> bool:
    """Whether a ``nan_debug`` context is open on this thread."""
    return getattr(_state, "nan_depth", 0) > 0


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def check_finite(stage: str, tree, mask=None) -> None:
    """Under ``nan_debug``: raise if a floating tensor of ``tree`` holds a non-finite value
    (only rows where ``mask`` is set, when given; masked-out rows may hold anything)."""
    if not nan_checks_enabled():
        return
    for i, t in enumerate(_leaves(tree)):
        if not t.is_floating_point():
            continue
        bad = ~torch.isfinite(t)
        if mask is not None and t.ndim >= mask.ndim and t.shape[: mask.ndim] == mask.shape:
            bad &= mask.reshape(mask.shape + (1,) * (t.ndim - mask.ndim))
        if bool(bad.any()):
            raise FloatingPointError(
                f"non-finite value produced by stage '{stage}' (output {i}, shape {tuple(t.shape)}, "
                f"{int(bad.sum())} bad of {t.numel()})"
            )


@contextlib.contextmanager
def nan_debug():
    """Trap non-finite values at the stage of the VO step that produced them (slow; dev only)."""
    _state.nan_depth = getattr(_state, "nan_depth", 0) + 1
    try:
        yield
    finally:
        _state.nan_depth -= 1


class LaunchLog:
    """What ``compile_logging`` counted: ``hand_written`` {kernel: launches} and, where a card
    was traced, ``device_launches`` (every kernel and copy on the card)."""

    def __init__(self):
        self.hand_written: dict = {}
        self.device_launches: int | None = None

    def per_frame(self, n_frames: int) -> dict:
        n = max(n_frames, 1)
        out = {f"{k}_per_frame": v / n for k, v in self.hand_written.items()}
        if self.device_launches is not None:
            out["device_launches_per_frame"] = self.device_launches / n
        return out


@contextlib.contextmanager
def compile_logging():
    """Count the kernel launches made inside the block -> LaunchLog (filled when the block ends)."""
    from ..frontend import kernels

    log = LaunchLog()
    before = dict(kernels.LAUNCHES)
    prof = None
    if torch.cuda.is_available():
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    try:
        yield log
    finally:
        log.hand_written = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            log.device_launches = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def _tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, torch.Generator):
        return isinstance(b, torch.Generator)  # a sample stream is state, not output
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def check_determinism(fn, *args, n: int = 2) -> bool:
    """Run ``fn`` n times on identical inputs; True iff the output trees are bit-identical
    (``torch.equal`` on tensors; NaN therefore never equals NaN, as in the reference)."""
    outs = [fn(*args) for _ in range(n)]
    return all(_tree_equal(outs[0], other) for other in outs[1:])
