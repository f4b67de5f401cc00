"""``device_busy_ms_per_frame.offline``: the union of the card's kernel, copy and
memset intervals that the host launched inside the traced job's ``runner.FRAME_LOOP`` span (both
streams; they run behind the host's queue), per frame (closed-loop cells)."""
from perfbench.trace import FRAME_LOOP


def read(run):
    tr = run.trace
    if tr is None or run.traffic.loop != "closed" or len(tr.span(FRAME_LOOP)) == 0:
        return None
    busy = tr.busy_launched_ns(FRAME_LOOP)
    return busy / 1e6 / run.jobs[0].n_frames if busy > 0 else None
