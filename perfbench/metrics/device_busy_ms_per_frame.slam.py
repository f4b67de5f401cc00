"""``device_busy_ms_per_frame.slam``: the union of the card's kernel, copy and memset intervals
over every stream (the frame loop's and the refiner worker's) inside the traced job 0's span, per
frame, in ms (closed-loop cells)."""
from perfbench.trace import JOB_SPAN


def read(run):
    tr = run.trace
    if tr is None or run.traffic.loop != "closed" or len(tr.span(JOB_SPAN)) == 0:
        return None
    busy = sum(tr.busy_ns(lo, hi) for lo, hi in tr.span(JOB_SPAN))
    return busy / 1e6 / run.jobs[0].n_frames if busy > 0 else None
