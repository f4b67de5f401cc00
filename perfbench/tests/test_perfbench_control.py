"""The control comes out not correct, on the card, at the cell's own size: the plain reference
computed with TF32 products (the precision below the float32 the configurations state) put in the
program's place, on three seeds. Run on the card:

    python -m pytest -p no:cacheprovider -m gpu perfbench/tests/test_perfbench_control.py
"""
import pytest

from perfbench import check, harness
from perfbench.gen import world


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["vo.offline", "vo.live"])
def test_tf32_control_is_not_correct(cuda, cell):
    c = harness.Cell(cell)
    t = c.traffic
    n = t.frames_in(30.0) if t.loop == "open" else len(c.world.log)
    group = c.group()
    for seed in (3_000_000_019, 3_000_000_037, 3_000_000_053):
        jobs = [harness.Job(index=0, seed=world.job_seed(seed, 0), n_frames=n, wall_s=0.0, result=None)]
        assert check.control(c, seed, jobs, group, cuda)["correct"] is False
