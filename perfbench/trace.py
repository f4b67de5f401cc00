"""The traced job's device timeline, reduced to what the per-layer readers need.

``torch.profiler`` (CUPTI) records every kernel, copy and memset on the card and the host's
ops and spans. The reduction reads the raw events (not ``prof.events()``, which builds a tree of
millions of Python objects) into arrays once: device intervals (``kernel``, ``gpu_memcpy``,
``gpu_memset``) with their names, the host's spans (``runner.FRAME_LOOP``, the harness's job
span) and the host's ops. Busy time is the union of device intervals (streams overlap), as
tools/profile_torch_step.py::union_ms takes it (``union``).
"""
from __future__ import annotations

import collections
import re
from typing import Optional

import numpy as np
import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME_LOOP = "vo_tpu_torch.frame_loop"  # vo_tpu_torch.odometry.runner.FRAME_LOOP
JOB_SPAN = "perfbench.job"


def union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Merged intervals of ``[starts, ends)``: (starts, ends) of the union, in order."""
    if len(starts) == 0:
        return np.zeros(0, starts.dtype), np.zeros(0, ends.dtype)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    emax = np.maximum.accumulate(e)
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > emax[:-1]
    idx = np.flatnonzero(new)
    return s[idx], emax[np.r_[idx[1:] - 1, len(s) - 1]]


def clip(starts, ends, lo, hi):
    """The parts of intervals that lie inside [lo, hi)."""
    s, e = np.maximum(starts, lo), np.minimum(ends, hi)
    keep = e > s
    return s[keep], e[keep]


class Summary:
    """Arrays of one traced window (times in ns on the profiler's clock)."""

    def __init__(self, events):
        dev_s, dev_e, dev_n, dev_c = [], [], [], []
        spans = collections.defaultdict(list)
        host_s, host_e, host_n = [], [], []
        launch_at = {}  # correlation id -> start of the host call that launched it
        cuda = torch.autograd.DeviceType.CUDA
        dev_events = []
        for ev in events:
            name = ev.name()
            if ev.device_type() == cuda:
                dev_events.append(ev)
            elif name in (FRAME_LOOP, JOB_SPAN):
                spans[name].append((ev.start_ns(), ev.end_ns()))
            else:
                host_s.append(ev.start_ns())
                host_e.append(ev.end_ns())
                host_n.append(name)
                if name.startswith("cu") and ev.correlation_id():
                    launch_at[ev.correlation_id()] = ev.start_ns()
        # The device side of a host annotation (a span's "gpu_user_annotation") is no device work:
        # without ``activity_type`` (older torch) it is told apart by its name, a host op's or span's.
        host_names = set(host_n) | set(spans)
        for ev in dev_events:
            kind = ev.activity_type() if hasattr(ev, "activity_type") else None
            if kind in DEVICE_KINDS if kind is not None else ev.name() not in host_names:
                dev_s.append(ev.start_ns())
                dev_e.append(ev.end_ns())
                dev_n.append(ev.name())
                dev_c.append(launch_at.get(ev.correlation_id(), ev.start_ns()))
        self.dev_s = np.asarray(dev_s, np.int64)
        self.dev_e = np.asarray(dev_e, np.int64)
        # When the host launched each device interval (a graph's kernels carry its launch's
        # correlation id): work launched inside a span runs after it, behind the queue.
        self.dev_launch = np.asarray(dev_c, np.int64)
        names, self.dev_name = np.unique(np.asarray(dev_n, dtype=object), return_inverse=True) if dev_n else ([], np.zeros(0, int))
        self.names = list(names)
        self.spans = {k: np.asarray(sorted(v), np.int64).reshape(-1, 2) for k, v in spans.items()}
        self.host_s = np.asarray(host_s, np.int64)
        self.host_e = np.asarray(host_e, np.int64)
        self.host_n = host_n
        job = self.spans.get(JOB_SPAN, np.zeros((0, 2), np.int64))
        self.window_s = float((job[:, 1] - job[:, 0]).sum()) / 1e9
        self.busy_s = sum(self.busy_ns(lo, hi) for lo, hi in job) / 1e9

    def busy_ns(self, lo: int, hi: int) -> int:
        """Device busy ns inside [lo, hi): the union over every stream."""
        s, e = union(*clip(self.dev_s, self.dev_e, lo, hi))
        return int((e - s).sum())

    def launched_in(self, within: str) -> np.ndarray:
        """[device intervals] bool: launched by the host inside a ``within`` span."""
        inside = np.zeros(len(self.dev_s), bool)
        for lo, hi in self.span(within):
            inside |= (self.dev_launch >= lo) & (self.dev_launch < hi)
        return inside

    def busy_launched_ns(self, within: str) -> int:
        """Device busy ns of the work launched inside ``within`` spans: the union over every stream."""
        sel = self.launched_in(within)
        s, e = union(self.dev_s[sel], self.dev_e[sel])
        return int((e - s).sum())

    def span(self, name: str) -> np.ndarray:
        return self.spans.get(name, np.zeros((0, 2), np.int64))

    def kernel_ns(self, name: str, within: str) -> np.ndarray:
        """Durations (ns) of the launches of kernel ``name`` that the host launched inside a ``within``
        span. The trace names a kernel with its namespaces and signature:
        ``(anonymous namespace)::extrema_scores_kernel((anonymous namespace)::Octaves, int, float, int)``."""
        pat = re.compile(r"(^|::)" + re.escape(name) + r"(\(|$)")
        ks = [k for k, n in enumerate(self.names) if pat.search(n)]
        sel = np.isin(self.dev_name, ks) & self.launched_in(within)
        return (self.dev_e - self.dev_s)[sel]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the job spans, and the idle gaps between
        device work there, summed by the innermost host op running halfway through each gap."""
        ops = np.zeros(len(self.names))
        gaps = collections.Counter()
        order = np.argsort(self.host_s, kind="stable")
        hs, he = self.host_s[order], self.host_e[order]
        hn = [self.host_n[i] for i in order]
        for lo, hi in self.span(JOB_SPAN):
            inside = (self.dev_s >= lo) & (self.dev_s < hi)
            ops += np.bincount(self.dev_name[inside], weights=(self.dev_e - self.dev_s)[inside], minlength=len(self.names))
            us, ue = union(*clip(self.dev_s, self.dev_e, lo, hi))
            for a, b in zip(np.r_[lo, ue], np.r_[us, hi]):
                if b <= a:
                    continue
                # What the host was doing halfway through the gap: the innermost op running then.
                mid = (a + b) // 2
                name = "no host op"
                j = int(np.searchsorted(hs, mid, side="right")) - 1
                for jj in range(j, max(j - 4096, -1), -1):
                    if he[jj] > mid:
                        name = hn[jj]
                        break
                gaps[name] += int(b - a)
        top_ops = np.argsort(-ops)[:top]
        return dict(
            device_ops=[[self.names[k], float(ops[k]) / 1e9] for k in top_ops if ops[k] > 0],
            idle_gaps=[[n, v / 1e9] for n, v in gaps.most_common(top)],
        )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start(device: torch.device) -> torch.profiler.profile:
    _sync(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop(prof, device: torch.device) -> Optional[Summary]:
    _sync(device)
    prof.stop()
    return Summary(prof.profiler.kineto_results.events())
