"""Sums of the program's spans in a traced run's job 0 (``RunResult.trace``, utils/profiling.py),
for the metric readers of the refined path.

A per-layer metric is read in the ``--trace 1`` run alone, whose window is job 0 under the profiler.
There the profiler slows the frame loop about twofold, so the worker keeps up more often than in an
untraced job: the frame loop's wait reads a fraction of its untraced size, and the worker's phases
read its own work, launches slowed by the profiler included. Each still grows and shrinks with the
refiner's work a keyframe; the untraced totals of the same spans are ``refine_stats``' ``main_wait_s``
and ``worker_*_s``."""
from __future__ import annotations


def _ms(run, names) -> float | None:
    """ms in job 0's spans named ``names`` (closed ones), or None where job 0 carries no trace."""
    tr = getattr(run.jobs[0].result, "trace", None) if run.jobs else None
    if tr is None:
        return None
    return sum(e - s for n, s, e, *_ in tr.spans if n in names and e >= s) / 1e6


def per_frame(run, names) -> float | None:
    ms = _ms(run, names)
    if ms is None or not run.jobs[0].result.refine_stats:
        return None
    return ms / run.jobs[0].n_frames


def per_keyframe(run, names) -> float | None:
    ms = _ms(run, names)
    n = run.jobs[0].result.refine_stats.get("n_keyframes", 0) if ms is not None else 0
    return ms / n if n else None
