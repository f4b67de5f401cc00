"""``readback_ms_per_frame.live``: per frame of the traced open-loop job 0, the time from the
device's last stage stamp of the frame's step to the end of the host's wait for the frame's
``HostCopy`` (the runner's ``vo_tpu_torch.host_copy`` span, inside ``vo_tpu_torch.host_read``),
both on ``perf_counter`` (``RunResult.trace``); the mean in ms. Nothing where job 0 carries no
stamps (a program without the tracer)."""
HOST_COPY = "vo_tpu_torch.host_copy"


def read(run):
    tr = getattr(run.jobs[0].result, "trace", None) if run.jobs and run.traffic.loop == "open" else None
    if tr is None or tr.stamps is None or not len(tr.stamps):
        return None
    copied = {s[5].get("frame"): s[2] for s in tr.spans if s[0] == HOST_COPY}
    gaps = [copied[f[0]] - int(row[len(c) - 1]) for row, f, c in zip(tr.stamps, tr.frames, tr.stages)
            if f[0] in copied and row[len(c) - 1] >= 0]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
