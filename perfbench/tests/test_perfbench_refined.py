"""The refined path (window BA + loop closure) through the harness, on the CPU at a small size: the
per-frame check reads the frame loop's own rows, and judged so a sound refined run is correct to
the bit, where its re-anchored rows would not be; and the check batches detection as the program
steps, on the plain, the open-loop and the refined path."""
import time

import numpy as np
import pytest
import torch

from perfbench import check, harness

from .conftest import REFINED, SMALL, SMALL_CLOSED

SEED = 2**33 + 29


@pytest.fixture
def refined(monkeypatch, step_rows):
    """run_cell over vo.offline with the refined configuration -> (the Run measured, the line)."""
    runs = []
    measure = harness.measure

    def kept(*a, **k):
        runs.append(measure(*a, **k))
        return runs[-1]

    monkeypatch.setattr(harness, "measure", kept)
    code, out = harness.run_cell("vo.offline", SEED, 100.0, False, time.perf_counter(), device="cpu", overrides=REFINED, workers=2)
    assert code == 0
    return runs[0], out


def test_refined_run_is_correct_on_the_step_rows(refined):
    run, out = refined
    assert run.group == 1 and len(run.jobs) == REFINED["traffic"]["jobs"]
    for j in run.jobs:
        res = j.result
        assert res.refine_stats["ba_solves"] >= 1
        assert np.abs(res.poses - res.step_poses).max() > 1e-3  # re-anchoring moved rows
    values = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is True, values
    assert values["stat_mismatches"] == values["rel_t_gap_m"] == values["rel_r_gap_rad"] == 0
    assert values["chain_rel_gap"] < 1e-6  # float32 rounding of the chained world pose


def test_reanchored_rows_would_not_be_correct(refined):
    """The same run judged on ``poses`` / ``rel_poses``, which re-anchoring moved."""
    run, _ = refined
    for j in run.jobs:
        del j.result.step_poses, j.result.step_rel_poses
    got = check.run_check(harness.Cell("vo.offline", REFINED), run, torch.device("cpu"))
    assert got["correct"] is False
    assert got["numbers"]["rel_t_gap_m"]["value"] > got["numbers"]["rel_t_gap_m"]["limit"]


@pytest.mark.parametrize(
    "cell,overrides,group",
    [
        ("vo.offline", dict(SMALL_CLOSED, traffic=dict(SMALL_CLOSED["traffic"], jobs=1)), 2),
        ("vo.live", dict(SMALL, traffic=dict(SMALL["traffic"], period_s=0.05)), 1),
        ("vo.offline", dict(REFINED, traffic=dict(REFINED["traffic"], jobs=1)), 1),
    ],
    ids=["closed", "open", "refined"],
)
def test_group_is_the_programs(cell, overrides, group):
    """``Cell.group()`` against the frames the program stepped together, from its tracer's record
    (``RunResult.trace.frames``, one tuple a step)."""
    from vo_tpu_torch.utils import profiling

    c = harness.Cell(cell, overrides)
    with profiling.tracing():
        run = harness.measure(c, SEED, 0.5, False, time.perf_counter(), device="cpu", workers=2)
    g, n = run.group, run.jobs[0].n_frames
    want = [tuple(range(i, i + g)) for i in range(0, n - n % g, g)] + [(i,) for i in range(n - n % g, n)]
    assert g == group
    assert run.jobs[0].result.trace.frames == want
