"""``k1_roofline``: K1 (``extrema_scores_kernel``, vo_tpu_torch/csrc/extrema_scores.cu) against its
bound by bytes, in %: the bytes that the traced job's frame-loop detection calls need
(perfbench/arith.py::k1_bytes, from the configuration's shapes) over the card's 3.35 TB/s, divided
by the device time of those launches. Nothing where the launches in the span are not one per
detection call."""
from perfbench import arith


def read(run):
    return arith.roofline(run, "extrema_scores_kernel", arith.k1_bytes)
