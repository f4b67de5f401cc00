"""Scoped matmul precision: the counterpart of ``jax.default_matmul_precision``.

The reference enters ``jax.default_matmul_precision("float32")`` around each
piece of geometry that needs it, and runs the plain per-frame step at
``cfg.matmul_precision``. On a CUDA card the knobs are two process-global
flags, ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``. ``matmul_precision(name)`` turns both
off for the duration of a block (or of a decorated function) and gives the
caller's values back on exit, whether the block returns or raises.

Names (the reference's), all full float32 products on this card:
- ``"float32"`` / ``"highest"``.
- ``"default"``: the reference's reduced-precision accelerator rate, which on
  an H100 would be TF32 in the plain step's matmuls and convolutions (the
  pyramid's band-matrix GEMMs). Measured on an H100 at 700 W
  (``tools/precision_torch.py``, PERF.md section 6), TF32 moves about a
  quarter of a frame's keypoints and multiplies the 200-frame ATE several
  times over, at no gain in ms/frame (the step is bound by the host). So
  ``"default"`` is float32 here too.

Any other name raises ``ValueError``.

The flags are global to the process, not to a thread: a block that changed
them on one thread would change them under every other thread too. So a
block whose flags are already off writes nothing, and a run that has a
second thread (the refiner's worker) pins float32 around the whole run; the
solvers' own blocks are then no-ops inside it.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("default", "float32", "highest")


@contextlib.contextmanager
def matmul_precision(name: str):
    """Run the block (or the decorated function) in float32, then restore the caller's flags."""
    if name not in NAMES:
        raise ValueError(f"unknown matmul precision {name!r}: expected one of {sorted(NAMES)}")
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (mm.allow_tf32, cudnn.allow_tf32)
    if before == (False, False):
        yield
        return
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = before
