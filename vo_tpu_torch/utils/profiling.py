"""Tracing / profiling / structured metrics (port of vo_tpu.utils.profiling).

- ``StageTimer``   — named wall-clock accumulators around pipeline stages
  (host-side; the caller closes device work with a synchronise).
- ``MetricsLog``   — per-frame structured JSONL (inlier ratio, track count,
  ms/frame) for offline analysis and dashboards.
- ``trace``        — context manager around ``torch.profiler`` that writes a
  Chrome trace (host and, where there is a card, device activity).
- ``pretty_frame`` — the reference's console block (frame #, distance step,
  velocity km/h, pose translation) for parity.

Everything but ``trace`` is the reference's code, copied: importing the
reference module would import its package, and with it jax.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: dict(
                total_s=round(self.totals[k], 4),
                calls=self.counts[k],
                mean_ms=round(1000.0 * self.totals[k] / max(self.counts[k], 1), 3),
            )
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        rows = [f"{k:>24s}  {v['mean_ms']:8.2f} ms x{v['calls']}" for k, v in self.summary().items()]
        return "\n".join(rows)


class MetricsLog:
    """Append-only JSONL of per-frame metric dicts."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._f = open(path, "a") if path else None
        self.rows: list = []

    def log(self, frame: int, **metrics):
        row = dict(frame=frame, **{k: _jsonable(v) for k, v in metrics.items()})
        self.rows.append(row)
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler and write ``<log_dir>/trace.json`` (a Chrome trace:
    chrome://tracing or Perfetto). Device activity is traced where a CUDA card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def pretty_frame(frame_idx: int, rel_pose: np.ndarray, pose: np.ndarray, dt: float) -> str:
    """Console telemetry block matching pretty_print (VO.m:261-277)."""
    step = float(np.linalg.norm(rel_pose[:3, 3]))
    vel_kmh = 3.6 * step / dt if dt > 0 else 0.0
    t = pose[:3, 3]
    return (
        f"frame {frame_idx}\n"
        f"  distance since last frame: {step:.3f} m\n"
        f"  velocity: {vel_kmh:.1f} km/h\n"
        f"  position: x={t[0]:.2f} y={t[1]:.2f} z={t[2]:.2f}"
    )
