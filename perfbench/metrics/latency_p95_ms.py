"""``latency_p95_ms``: the 95th percentile, over every frame of the open-loop job, of the time from
the frame's release by the camera to its pose reaching ``run_sequence``'s ``progress`` callback."""
import numpy as np


def read(run):
    if run.traffic.loop != "open" or not run.jobs:
        return None
    j = run.jobs[0]
    lat = 1000.0 * (j.done_s - j.release_s)
    if not np.all(np.isfinite(lat)):
        return None
    return float(np.percentile(lat, 95))
