"""Tracing, profiling and structured metrics (port of vo_tpu.utils.profiling).

The tracer, the port's one tracing system (off unless turned on):

- ``span(name, total=None, **attrs)`` — the helper of every span site. Off, it returns one
  shared no-op context: no ``record_function``, no clock read. On, it enters
  ``torch.profiler.record_function(name)``, so the span lands in a Kineto trace beside the
  device's intervals, and keeps ``(name, start, end, parent, thread, attrs)`` in the tracer's
  list (``perf_counter_ns``; ``parent`` the index of the enclosing span of the same thread, -1
  at the top). ``total`` (a dict) gets the span's seconds added under the last dotted part of
  the name, on or off: the refiner's phase clocks, which ``refine_stats`` reports.
- ``tracing()`` turns it on for a block, with or without a profiler. ``call_tracing()`` is what
  ``run_sequence`` enters, once per call: the active tracer; else, while ``torch.profiler``
  records, one of the call's own; else None. So a call made under the profiler is traced.
- ``StageStamps``: the device's clock at the stage boundaries of the graphed step, one row per
  replay in a ring on the device (``write_stamp``: on a card a one-thread kernel,
  ``csrc/stage_stamp.cu``, reading ``%globaltimer``; on the CPU ``perf_counter_ns``), read
  once after the loop.
- ``Trace``: what one traced ``run_sequence`` call returns (``RunResult.trace``).

The clocks. Spans are read on ``time.perf_counter_ns``. One ``(perf_counter_ns, time_ns)`` pair,
read when the tracer starts, maps them onto the Unix epoch clock on which Kineto stamps host
events (``Trace.profiler_ns``). The device's stamps are mapped onto ``perf_counter_ns`` linearly
between two anchors, each a stamp launched between two synchronises with a host read on either
side, one before the loop and one after it (so the drift of the two clocks over a job is taken
out, and the narrowest of several brackets counts); under CUPTI the stamp kernels' own intervals
give the raw stamps' offset to the profiler's device timeline (``Trace.device_offset_ns``).

Also:

- ``MetricsLog``   — per-frame structured JSONL (inlier ratio, track count, ms/frame).
- ``trace``        — the tracer on under ``torch.profiler``, and a Chrome trace written (host and,
  where there is a card, device activity).
- ``pretty_frame`` — the reference's console block (frame #, distance step, velocity km/h, pose
  translation) for parity.

``MetricsLog`` and ``pretty_frame`` are the reference's code, copied: importing the reference
module would import its package, and with it jax.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..frontend import kernels

_tracer: Optional["Tracer"] = None  # the active tracer; None: off

STAMP_KERNEL = "stage_stamp_kernel"  # the stamp's kernel, as a trace names it
ANCHOR_TRIES = 8  # stamps a clock anchor takes; the one the host brackets most narrowly counts
# Stamp writes: kernels enqueued on a card, and launches recorded into a CUDA graph under capture.
STAMPS = {"launched": 0, "captured": 0}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Timed:
    """Off, with ``total``: the phase's seconds on the host clock, and nothing else."""

    __slots__ = ("total", "key", "t0")

    def __init__(self, total: dict, key: str):
        self.total, self.key = total, key

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.total[self.key] = self.total.get(self.key, 0.0) + (time.perf_counter_ns() - self.t0) / 1e9
        return False


class _Span:
    __slots__ = ("tracer", "name", "total", "key", "attrs", "rf", "index", "t0")

    def __init__(self, tracer: "Tracer", name: str, total: Optional[dict], key: str, attrs: dict):
        self.tracer, self.name, self.total, self.key, self.attrs = tracer, name, total, key, attrs

    def __enter__(self):
        # The clock first: Kineto stamps the range inside record_function's enter.
        self.t0 = time.perf_counter_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.index = self.tracer._open(self.name, self.t0, self.attrs)

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        end = time.perf_counter_ns()
        self.tracer._close(self.index, end)
        if self.total is not None:
            self.total[self.key] = self.total.get(self.key, 0.0) + (end - self.t0) / 1e9
        return False


def span(name: str, total: Optional[dict] = None, **attrs):
    """A span around a block (module docstring): ``with span("vo_tpu_torch.step", frame=i): ...``."""
    tracer = _tracer
    if tracer is None and total is None:
        return NOOP
    key = name.rsplit(".", 1)[-1]
    return _Timed(total, key) if tracer is None else _Span(tracer, name, total, key, attrs)


class Tracer:
    """The spans of every thread while the tracer is on (``span``), in the order they opened."""

    def __init__(self):
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.rows: list = []  # [name, start, end, parent, thread, attrs]; end -1 while open
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, start: int, attrs: dict) -> int:
        stack = self._stack()
        with self._lock:
            self.rows.append([name, start, -1, stack[-1] if stack else -1, threading.get_ident(), attrs])
            index = len(self.rows) - 1
        stack.append(index)
        return index

    def _close(self, index: int, end: int) -> None:
        self.rows[index][2] = end
        self._stack().pop()

    def collect(self, first: int = 0, stamps: Optional["StageStamps"] = None) -> "Trace":
        """The spans opened since row ``first`` (parents before it become -1) and the rows that
        ``stamps.read()`` took."""
        spans = [(n, s, e, p - first if p >= first else -1, th, a) for n, s, e, p, th, a in self.rows[first:]]
        tr = Trace(anchor=self.anchor, spans=spans)
        if stamps is not None:
            tr.raw, tr.stamps, tr.clock = stamps.raw, stamps.mapped, stamps.clock
            tr.frames = [f for f, _ in stamps.replays]
            tr.stages = [c for _, c in stamps.replays]
        return tr


@contextlib.contextmanager
def tracing():
    """The tracer on for the block (the active one where there is one) -> the ``Tracer``."""
    global _tracer
    if _tracer is not None:
        yield _tracer
        return
    _tracer = Tracer()
    try:
        yield _tracer
    finally:
        _tracer = None


@contextlib.contextmanager
def call_tracing():
    """One call's tracer (module docstring) -> the ``Tracer`` or None."""
    if _tracer is not None or not torch.autograd.profiler._is_profiler_enabled:
        yield _tracer
        return
    with tracing() as tracer:
        yield tracer


def write_stamp(buf: torch.Tensor, row: torch.Tensor, col: int, advance: bool = False) -> None:
    """Stamp ``buf[row % rows, col]`` (int64 ``[rows, width]``) with the clock and, with ``advance``,
    move ``row`` (int64 ``[1]``) on: on a card the stamp kernel on the current stream (the
    device's ``%globaltimer``, ns), on the CPU ``perf_counter_ns`` at once."""
    if buf.device.type == "cpu":
        buf[int(row) % buf.shape[0], col] = time.perf_counter_ns()
        if advance:
            row += 1
        return
    if buf.dtype != torch.int64 or row.dtype != torch.int64 or not buf.is_contiguous() or buf.device != row.device:
        raise ValueError(f"write_stamp: expected contiguous int64 buf and row on one device, got {buf.dtype} {row.dtype}")
    with torch.cuda.device(buf.device):
        err = kernels.load().vo_stage_stamp(
            buf.data_ptr(), row.data_ptr(), buf.shape[0], buf.shape[1], col, int(advance),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stage_stamp kernel launch failed with cudaError_t {err}")
    STAMPS["captured" if torch.cuda.is_current_stream_capturing() else "launched"] += 1


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageStamps:
    """A ring of stage stamps, int64 ``[rows, width]`` on ``device``, and its row counter there.

    The step's body calls ``mark()`` at each stage boundary, its first at the start (column 0),
    and ``mark(advance=True)`` at its last, which moves the counter on: every replay fills its
    own row and the host does not read the counter. The caller keeps, per replay of the loop,
    its frames and the stage each column ends in ``replays``; ``start()`` before the loop and
    ``read()`` after it (module docstring: the clock anchors), which sets ``raw``, ``mapped``
    and ``clock``.
    """

    def __init__(self, rows: int, width: int, device):
        self.device = torch.device(device)
        self.buf = torch.full((max(rows, 1), width), -1, dtype=torch.int64, device=self.device)
        self.row = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._anchors = torch.full((1, 2 * ANCHOR_TRIES), -1, dtype=torch.int64, device=self.device)
        self._anchor_row = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._host: list = []  # (perf_counter_ns before, after) each anchor stamp, the tries in order
        self._col = 0
        self.replays: list = []  # (frame indices, stage of each column) per replay of the loop
        self.raw = self.mapped = self.clock = None  # read()'s

    def mark(self, advance: bool = False) -> None:
        write_stamp(self.buf, self.row, self._col, advance)
        self._col = 0 if advance else self._col + 1

    def _anchor(self) -> None:
        """A stamp between two synchronises, ``ANCHOR_TRIES`` times: the narrowest bracket is kept."""
        for _ in range(ANCHOR_TRIES):
            _sync(self.device)
            h0 = time.perf_counter_ns()
            write_stamp(self._anchors, self._anchor_row, len(self._host))
            _sync(self.device)
            self._host.append((h0, time.perf_counter_ns()))

    def start(self) -> None:
        """Before the loop: the ring emptied, row 0 next, and the first anchor."""
        self.buf.fill_(-1)
        self.row.zero_()
        self.replays, self._host = [], []
        self._anchor()

    def read(self) -> None:
        """After the loop: the second anchor, then the loop's rows, as written (``raw``) and on
        ``perf_counter_ns`` (``mapped``, -1 where unwritten), and the map (``clock``)."""
        self._anchor()
        n = len(self.replays)
        if n > self.buf.shape[0]:
            raise ValueError(f"{n} replays overran a ring of {self.buf.shape[0]} rows")
        self.raw = self.buf[:n].cpu().numpy()
        g = self._anchors[0].cpu().numpy()
        host = np.asarray(self._host, np.int64)
        # Each end's narrowest bracket: its stamp lies between the host's two reads, so the map's
        # error there is at most half the bracket.
        width = (host[:, 1] - host[:, 0]).reshape(2, ANCHOR_TRIES)
        best = [k * ANCHOR_TRIES + int(np.argmin(width[k])) for k in (0, 1)]
        g0, g1 = (int(g[b]) for b in best)
        (a0, a1), (b0, b1) = (tuple(int(x) for x in host[b]) for b in best)
        h0, h1 = (a0 + a1) / 2, (b0 + b1) / 2
        scale = (h1 - h0) / (g1 - g0) if g1 != g0 else 1.0
        self.mapped = np.where(self.raw >= 0, np.round(h0 + (self.raw - g0) * scale), -1).astype(np.int64)
        self.clock = dict(device_ns=(g0, g1), host_ns=((a0, a1), (b0, b1)), scale=scale,
                          error_ns=max(a1 - a0, b1 - b0) / 2)


@dataclasses.dataclass
class Trace:
    """One traced call: its spans and its step's device stage stamps (module docstring)."""

    anchor: tuple  # (perf_counter_ns, time_ns), read together when the tracer started
    spans: list  # (name, start_ns, end_ns, parent, thread, attrs) on perf_counter_ns
    stamps: Optional[np.ndarray] = None  # [replays, width] int64 on perf_counter_ns; -1 unwritten
    stages: list = dataclasses.field(default_factory=list)  # per replay: the stage each column ends
    frames: list = dataclasses.field(default_factory=list)  # per replay: its frames' indices
    raw: Optional[np.ndarray] = None  # the stamps as written: the device's ns (the CPU: perf_counter_ns)
    clock: Optional[dict] = None  # the anchors of the device -> perf_counter_ns map; error_ns its bound

    def named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]

    def profiler_ns(self, t):
        """``perf_counter_ns`` -> the Unix epoch ns on which Kineto stamps host events."""
        return t - self.anchor[0] + self.anchor[1]

    def device_offset_ns(self, kernel_starts) -> Optional[int]:
        """ns to add to a raw stamp to put it on the profiler's device timeline, from the start times
        there of the stamp kernels (``STAMP_KERNEL``; a profiler records them only on a card): each
        written stamp is matched to the kernel start nearest its estimate over the host clock
        (``profiler_ns(stamps)``), and the median of (start − raw stamp) is taken. CUPTI's device
        times run with the device's clock, so one offset holds over a job. None where there is
        nothing to match."""
        ks = np.sort(np.asarray(kernel_starts, np.int64))
        if self.raw is None or not len(ks):
            return None
        ok = self.raw >= 0
        raw, est = self.raw[ok], self.profiler_ns(self.stamps[ok])
        if not len(raw):
            return None
        j = np.searchsorted(ks, est)
        lo, hi = ks[np.clip(j - 1, 0, len(ks) - 1)], ks[np.clip(j, 0, len(ks) - 1)]
        return int(np.median(np.where(np.abs(lo - est) <= np.abs(hi - est), lo, hi) - raw))


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
    """The tracer on (``tracing``) and the block profiled with torch.profiler; writes
    ``<log_dir>/trace.json`` (a Chrome trace: chrome://tracing or Perfetto), where the port's
    spans (``vo_tpu_torch.*``) lie beside the host's ops and, where a CUDA card is present, the
    device's activity."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tracing(), profile(activities=activities) as prof:
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
