"""``device_busy_ms_per_frame.live``: as ``device_busy_ms_per_frame.offline``, in the open-loop job."""
from perfbench.trace import FRAME_LOOP


def read(run):
    tr = run.trace
    if tr is None or run.traffic.loop != "open" or len(tr.span(FRAME_LOOP)) == 0:
        return None
    busy = tr.busy_launched_ns(FRAME_LOOP)
    return busy / 1e6 / run.jobs[0].n_frames if busy > 0 else None
