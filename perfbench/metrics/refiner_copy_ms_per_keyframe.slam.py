"""``refiner_copy_ms_per_keyframe.slam``: the refiner worker's ``copy`` phase in the traced job 0
(span ``vo_tpu_torch.refiner.copy``: the wait for a keyframe's host copies and their reading), per
keyframe, in ms. Nothing where job 0 carries no trace or ran no refiner."""
from perfbench.metrics_spans import per_keyframe

NAMES = ("vo_tpu_torch.refiner.copy",)


def read(run):
    return per_keyframe(run, NAMES)
