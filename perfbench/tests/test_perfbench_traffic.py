"""The traffic generator's logs and release schedule, and the check's detection batches."""
import time

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.gen import traffic


def test_out_and_back_log():
    t = traffic.load("outback400")
    log = t.log()
    assert len(log) == 799 and t.n_landmarks == 4800
    assert list(log[:400]) == list(range(400)) and list(log[400:]) == list(range(398, -1, -1))


def test_open_loop_releases():
    """The live feed serves the runner's warm-up fetch of frame 0 at once, starts the camera's
    clock at the loop's fetch of frame 0, and releases frame i at t0 + i * period, not before."""
    t = traffic.load("outback400-live")
    assert t.loop == "open" and t.period_s == pytest.approx(0.10374)
    assert t.frames_in(51) == 491 and t.frames_in(1e6) == 799
    period = 0.02
    feed = harness.LiveFeed(torch.zeros((4, 2, 3, 3), dtype=torch.uint8), None, None, period)
    feed.frame(0)  # the warm-up's fetch
    assert feed.t0 is None
    feed.frame(0)
    got = []
    for i in (1, 2, 3):
        feed.frame(i)
        got.append(time.perf_counter())
    assert np.allclose(feed.release - feed.t0, period * np.arange(4))
    assert all(g >= feed.t0 + period * i for g, i in zip(got, (1, 2, 3)))


@pytest.mark.parametrize("loop,route", [("sometimes", "out_and_back"), ("closed", "one_way")])
def test_refuses_unknown_kinds(tmp_path, loop, route):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "odd.json").write_text(
        f'{{"loop": "{loop}", "route": "{route}", "poses": 3, "landmarks_per_pose": 1, "render_noise": 0, '
        '"world_seed": 0, "sensor_noise": 0}'
    )
    with pytest.raises(ValueError):
        traffic.load("odd", root=str(tmp_path))


def test_batches_follow_the_runner():
    assert check.batch_of(0, 799, 2) == [0, 1] and check.batch_of(797, 799, 2) == [796, 797]
    assert check.batch_of(798, 799, 2) == [798]
    assert check.batch_of(5, 10, 1) == [5]


def test_sample_is_drawn_from_the_seed():
    jobs = [type("J", (), dict(index=i, n_frames=799))() for i in range(3)]
    a, b, c = check.sample(jobs, 40, 2**40 + 3), check.sample(jobs, 40, 2**40 + 3), check.sample(jobs, 40, 7)
    assert a == b and a != c
    assert sum(len(v) for v in a.values()) == 40 and all(1 <= t < 799 for v in a.values() for t in v)
