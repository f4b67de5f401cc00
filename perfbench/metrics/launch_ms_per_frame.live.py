"""``launch_ms_per_frame.live``: per frame of the traced open-loop job 0, the time from the end of
the runner's ``vo_tpu_torch.fetch`` span of the frame (the camera's frame in hand) to the device's
start stamp of the frame's step (the copy-in, the graph's launch, and the queue before the card
starts it), both on ``perf_counter`` (``RunResult.trace``); the mean in ms. Nothing where job 0
carries no stamps (a program without the tracer)."""
FETCH = "vo_tpu_torch.fetch"


def read(run):
    tr = getattr(run.jobs[0].result, "trace", None) if run.jobs and run.traffic.loop == "open" else None
    if tr is None or tr.stamps is None or not len(tr.stamps):
        return None
    fetched = {s[5].get("frame"): s[2] for s in tr.spans if s[0] == FETCH}
    gaps = [int(row[0]) - fetched[f[0]] for row, f in zip(tr.stamps, tr.frames) if f[0] in fetched and row[0] >= 0]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
