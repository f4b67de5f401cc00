"""The closed loop's window is a fixed set of jobs, whatever the program's speed: which jobs a run
has, what it attempts, the traffic files that name the jobs, and the check's sample, on the CPU at
a small size."""
import json
import time

import numpy as np
import pytest

from perfbench import check, harness
from perfbench.gen import traffic

from .conftest import SMALL_CLOSED

JOBS = 3
SEED = 2**33 + 17


def _run(monkeypatch, seconds, trace=False):
    """run_cell over vo.offline at SMALL with JOBS jobs -> (the Run measured, the line's object)."""
    runs = []
    measure = harness.measure

    def kept(*a, **k):
        runs.append(measure(*a, **k))
        return runs[-1]

    monkeypatch.setattr(harness, "measure", kept)
    ov = dict(SMALL_CLOSED, traffic=dict(SMALL_CLOSED["traffic"], jobs=JOBS))
    code, out = harness.run_cell("vo.offline", SEED, seconds, trace, time.perf_counter(), device="cpu", overrides=ov, workers=2)
    assert code == 0 and out["correct"] is True
    return runs[0], out


@pytest.mark.parametrize(
    "seconds,trace,want",
    [
        (1e4, False, list(range(JOBS))),  # --seconds far above the window: the jobs end it, not the clock
        (1e-3, False, [0]),  # far below one job's time: no job starts once 2 * --seconds have passed
        (1e4, True, [0]),  # traced: job 0 alone
    ],
    ids=["untraced-long", "untraced-cut", "traced"],
)
def test_window_is_the_fixed_jobs(monkeypatch, capsys, seconds, trace, want):
    run, out = _run(monkeypatch, seconds, trace)
    n_log = len(run.world.log)
    assert [j.index for j in run.jobs] == want
    assert all(j.n_frames == n_log for j in run.jobs)
    assert out["attempted"] == len(want) * n_log
    fails = {j.index: int(np.sum(~np.asarray(j.result.pose_ok, bool))) for j in run.jobs}
    assert out["failed"] == sum(fails.values())
    assert f"frames with pose_ok false by job {fails}" in capsys.readouterr().err


def test_two_runs_at_one_seed_draw_the_same_sample(monkeypatch):
    """Runs that differ only in --seconds (neither cut) have the same jobs, the same check sample
    and, the CPU being deterministic, the same pose_ok frame for frame."""
    a, out_a = _run(monkeypatch, 1e4)
    b, out_b = _run(monkeypatch, 1e3)
    assert [j.index for j in a.jobs] == [j.index for j in b.jobs] == list(range(JOBS))
    n = int(SMALL_CLOSED["check"]["samples"])
    sa, sb = check.sample(a.jobs, n, SEED), check.sample(b.jobs, n, SEED)
    assert sa == sb and sum(len(v) for v in sa.values()) == n
    assert out_a["attempted"] == out_b["attempted"] and out_a["failed"] == out_b["failed"]
    for ja, jb in zip(a.jobs, b.jobs):
        assert np.array_equal(ja.result.pose_ok, jb.result.pose_ok)


BASE = dict(route="out_and_back", poses=3, landmarks_per_pose=1, render_noise=0, world_seed=0, sensor_noise=0)


def _write(tmp_path, d):
    (tmp_path / "traffic").mkdir(exist_ok=True)
    (tmp_path / "traffic" / "mix.json").write_text(json.dumps(dict(BASE, **d)))


@pytest.mark.parametrize(
    "d,match",
    [
        (dict(loop="closed"), "closed loop needs jobs"),
        (dict(loop="closed", jobs=0), "closed loop needs jobs"),
        (dict(loop="closed", jobs=2.0), "closed loop needs jobs"),
        (dict(loop="closed", jobs=True), "closed loop needs jobs"),
        (dict(loop="open", period_s=0.1, jobs=2), "open loop is one job"),
    ],
    ids=["closed-none", "closed-zero", "closed-float", "closed-bool", "open-with-jobs"],
)
def test_load_refuses_jobs_that_break_the_loop(tmp_path, d, match):
    _write(tmp_path, d)
    with pytest.raises(ValueError, match=match):
        traffic.load("mix", root=str(tmp_path))


def test_load_takes_the_jobs_of_its_loop(tmp_path):
    _write(tmp_path, dict(loop="closed", jobs=2))
    assert traffic.load("mix", root=str(tmp_path)).jobs == 2
    _write(tmp_path, dict(loop="open", period_s=0.1))
    assert traffic.load("mix", root=str(tmp_path)).jobs is None
    t = traffic.load("outback400")
    assert t.jobs == 8 and t.jobs * len(t.log()) == 6392
    assert traffic.load("outback400-live").jobs is None
