"""``refiner_wait_ms_per_frame.slam``: the frame loop's host time blocked on the refiner in the
traced job 0, per frame: its spans ``vo_tpu_torch.refiner.throttle`` (a keyframe's wait while the
worker is more than two keyframes behind) and ``vo_tpu_torch.refiner.launch_wait`` (under a mesh,
the wait for a window problem to launch), in ms. Nothing where job 0 carries no trace or ran no
refiner."""
from perfbench.metrics_spans import per_frame

NAMES = ("vo_tpu_torch.refiner.throttle", "vo_tpu_torch.refiner.launch_wait")


def read(run):
    return per_frame(run, NAMES)
