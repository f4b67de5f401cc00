"""``refiner_lc_ms_per_keyframe.slam``: the refiner worker's ``loop_closure`` phase in the traced
job 0 (span ``vo_tpu_torch.refiner.loop_closure``: archiving, candidates, the verification round's
dispatch and collect, the pose-graph solve), per keyframe, in ms. Nothing where job 0 carries no
trace or ran no refiner."""
from perfbench.metrics_spans import per_keyframe

NAMES = ("vo_tpu_torch.refiner.loop_closure",)


def read(run):
    return per_keyframe(run, NAMES)
