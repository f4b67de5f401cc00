"""The refiner's control comes out not correct, on the card, at the cell's own size: the program's
window solve and verification round computed with TF32 products (the precision below the float32
the configuration states) put in the program's place, on one job of each of two seeds. Run on the
card:

    python -m pytest -p no:cacheprovider -m gpu perfbench/tests/test_perfbench_refiner_control.py
"""
import dataclasses
import time

import pytest

from perfbench import harness


@pytest.mark.gpu
def test_tf32_refiner_control_is_not_correct(cuda):
    c = harness.Cell("slam.offline")
    c.traffic = dataclasses.replace(c.traffic, jobs=1)
    (refiner,) = c.extras
    for seed in (3_000_000_019, 3_000_000_037):
        run = harness.measure(c, seed, 51.0, False, time.perf_counter(), device=cuda)
        assert refiner.values(c, run, cuda)["refine_records_missing"] == 0
        assert refiner.control(c, run, cuda)["correct"] is False
