"""``refiner_ba_ms_per_keyframe.slam``: the refiner worker's window-BA phases in the traced job 0
(spans ``vo_tpu_torch.refiner.ba_collect``, ``.associate`` and ``.ba_dispatch``: the collect and its
gates, the track association, the window's assembly and the solve's launch), per keyframe, in ms.
Nothing where job 0 carries no trace or ran no refiner."""
from perfbench.metrics_spans import per_keyframe

NAMES = ("vo_tpu_torch.refiner.ba_collect", "vo_tpu_torch.refiner.associate", "vo_tpu_torch.refiner.ba_dispatch")


def read(run):
    return per_keyframe(run, NAMES)
