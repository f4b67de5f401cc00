"""``capture_ms_per_job.offline``: the traced job 0's ``RunResult.capture_s``, in ms: the
``run_sequence`` call's host time from its entry to its frame loop, the span
``vo_tpu_torch.capture`` (the step graphs' warm-up and capture, made anew in every call). Job 0
runs under CUPTI, which slows the capture's eager warm-up; it is the job a traced run has, since
reducing its trace outlasts the window. Closed-loop cells; nothing where job 0 carries no trace (a
program without the tracer)."""


def read(run):
    if run.traffic.loop != "closed" or not run.jobs or getattr(run.jobs[0].result, "trace", None) is None:
        return None
    return 1000.0 * run.jobs[0].result.capture_s
