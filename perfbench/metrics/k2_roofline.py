"""``k2_roofline``: K2 (``bin_maps_kernel``, vo_tpu_torch/csrc/bin_maps.cu), as ``k1_roofline``
with perfbench/arith.py::k2_bytes."""
from perfbench import arith


def read(run):
    return arith.roofline(run, "bin_maps_kernel", arith.k2_bytes)
