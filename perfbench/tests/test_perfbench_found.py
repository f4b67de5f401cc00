"""What a configuration, a workload and a check module add by name: a configuration's ``run``
options reach every ``run_sequence`` call of a run, and a workload's ``check.extra`` numbers are
judged beside the check's own; what does not fit is refused when the cell loads. On the CPU at a
small size."""
import time

import pytest

from perfbench import check, harness

from .conftest import REFINED, SMALL, SMALL_CLOSED

LIVE = dict(SMALL, traffic=dict(SMALL["traffic"], period_s=0.3))
PLANTED = '''
NUMBERS = ("planted_gap",)


def values(cell, run, device):
    return {VALUES}
'''


@pytest.mark.parametrize(
    "cell,overrides,want",
    [
        ("vo.offline", SMALL_CLOSED, dict()),
        ("vo.live", LIVE, dict(progress=None)),
        ("vo.offline", REFINED, dict(use_ba=True, use_loop_closure=True)),
    ],
    ids=["closed", "open", "refined"],
)
def test_run_options_reach_every_job(monkeypatch, cell, overrides, want):
    """Without ``run`` a call gets today's keywords (seed, device, and the open loop's progress);
    with it, the options too, in the warm job and in every job of the window."""
    from vo_tpu_torch.odometry import runner

    calls = []
    monkeypatch.setattr(runner, "run_sequence", lambda seq, cfg, **kw: calls.append(kw))
    c = harness.Cell(cell, overrides)
    harness.measure(c, 2**33 + 3, 1.0, False, time.perf_counter(), device="cpu", workers=2)
    assert len(calls) == 1 + (c.traffic.jobs or 1)
    for kw in calls:
        assert set(kw) == {"seed", "device"} | set(want)
        assert all(kw[k] is v for k, v in want.items() if v is not None)


def test_the_cells_configurations_set_no_run_option():
    for name in ("vo.offline", "vo.live"):
        assert harness.Cell(name).run_options == {}


@pytest.mark.parametrize(
    "run,match",
    [
        (dict(graph=False), "'graph'"),
        (dict(seed=1), "'seed'"),
        (dict(use_ba=1), "true or false"),
        ([], "must be an object"),
    ],
    ids=["graph", "seed", "not-a-bool", "not-an-object"],
)
def test_a_run_option_that_does_not_fit_is_refused(run, match):
    ov = dict(SMALL_CLOSED, config=dict(SMALL_CLOSED["config"], run=run))
    with pytest.raises(ValueError, match=match):
        harness.Cell("vo.offline", ov)


def _plant(tmp_path, monkeypatch, values, numbers='("planted_gap",)'):
    (tmp_path / "planted.py").write_text(PLANTED.replace("{VALUES}", values).replace('("planted_gap",)', numbers))
    monkeypatch.setattr(harness, "CHECKS", str(tmp_path))


def _with_check(**chk):
    return dict(SMALL_CLOSED, check=dict(SMALL_CLOSED["check"], **chk))


def _planted_run(tmp_path, monkeypatch, values):
    _plant(tmp_path, monkeypatch, values)
    ov = _with_check(extra=["planted"], limits=dict(planted_gap=1.0))
    return harness.run_cell("vo.offline", 2**33 + 7, 1.0, False, time.perf_counter(), device="cpu", overrides=ov, workers=2)


@pytest.mark.parametrize(
    "values,correct",
    [("dict(planted_gap=0.5, where=dict(planted_gap='here'))", True), ("dict(planted_gap=2.0)", False)],
    ids=["within", "over"],
)
def test_a_planted_number_is_judged(tmp_path, monkeypatch, capsys, values, correct):
    code, out = _planted_run(tmp_path, monkeypatch, values)
    assert code == 0 and out["correct"] is correct
    assert list(out["checks"]) == list(check.NUMBERS) + ["planted_gap"]
    assert out["checks"]["planted_gap"]["limit"] == 1.0
    err = capsys.readouterr().err
    assert f"check planted_gap: {out['checks']['planted_gap']['value']!r} limit 1.0 {'ok' if correct else 'FAILED'}" in err
    assert ("# check planted_gap set by here" in err) == correct
    assert all(c["value"] <= c["limit"] for k, c in out["checks"].items() if k != "planted_gap")


def test_a_planted_number_left_out_ends_the_run(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match=r"gave no value for \['planted_gap'\]"):
        _planted_run(tmp_path, monkeypatch, "dict()")


@pytest.mark.parametrize(
    "chk,numbers,match",
    [
        (dict(extra=["planted"]), '("planted_gap",)', r"missing \['planted_gap'\], spare \[\]"),
        (dict(limits=dict(planted_gap=1.0)), '("planted_gap",)', r"missing \[\], spare \['planted_gap'\]"),
        (dict(extra=["planted"], limits=dict(rel_t_gap_m=1.0)), '("rel_t_gap_m",)', "already a number"),
        (dict(extra=["absent"], limits=dict(planted_gap=1.0)), '("planted_gap",)', "absent"),
    ],
    ids=["missing", "spare", "clash", "no-file"],
)
def test_limits_that_do_not_fit_the_numbers_are_refused(tmp_path, monkeypatch, chk, numbers, match):
    _plant(tmp_path, monkeypatch, "dict(planted_gap=0.0)", numbers)
    with pytest.raises(ValueError, match=match):
        harness.Cell("vo.offline", _with_check(**chk))
