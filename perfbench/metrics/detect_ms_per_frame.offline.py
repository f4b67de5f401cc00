"""``detect_ms_per_frame.offline``: the card's time in the step's ``detect`` stage (``_normalize``
and ``detect_and_describe``, once for a group), per frame of the traced job 0: over the grouped
step's replays (closed-loop cells), the sum of the intervals that end at a stamp of this stage
and start at the stamp before it (the step's device stage stamps, ``RunResult.trace``;
vo_tpu_torch/odometry/pipeline.py), over the job's frames, in ms. Nothing where job 0 carries no
stamps (a program without the tracer)."""
STAGE, LOOP = "detect", "closed"


def read(run):
    tr = getattr(run.jobs[0].result, "trace", None) if run.jobs and run.traffic.loop == LOOP else None
    if tr is None or tr.stamps is None or not len(tr.stamps):
        return None
    ns = 0
    for row, cols in zip(tr.stamps, tr.stages):
        if (row[: len(cols)] < 0).any():
            return None
        ns += sum(int(row[k] - row[k - 1]) for k in range(1, len(cols)) if cols[k] == STAGE)
    return ns / 1e6 / run.jobs[0].n_frames
