"""``fps``: every frame of the window's jobs over the sum of their wall times (closed-loop cells).
A job's time runs from the ``run_sequence`` call to its return and a synchronise, so it holds the
call's graph capture and warm-up."""


def read(run):
    if run.traffic.loop != "closed" or not run.jobs:
        return None
    return sum(j.n_frames for j in run.jobs) / sum(j.wall_s for j in run.jobs)
