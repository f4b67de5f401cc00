"""BENCHMARK.json against the benchmark's files, and the run's one line."""
import json
import os
import subprocess
import sys
import time

import pytest

from perfbench import harness

from .conftest import SMALL, SMALL_CLOSED

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_cells_configs_and_metrics_have_their_files():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        harness.run_options(json.load(open(os.path.join(ROOT, c["file"]))))
    for w in BENCH["workloads"]:
        spec = json.load(open(os.path.join(ROOT, "perfbench", "workloads", f"{w['name']}.json")))
        assert (spec["config"], spec["traffic"]) == (w["config"], w["traffic"])
        assert os.path.exists(os.path.join(ROOT, "perfbench", "traffic", f"{w['traffic']}.json"))
        assert set(spec["check"]["limits"]) == set(harness_check_numbers(spec["check"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", names)) <= names


def harness_check_numbers(spec):
    """The numbers a workload's check judges: check.NUMBERS and its ``extra`` modules' NUMBERS."""
    from perfbench import check

    return check.numbers([harness.module(harness.CHECKS, n) for n in spec.get("extra", [])])


def test_exits_without_a_card_and_prints_nothing():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "vo.offline", "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0 and p.stdout == "" and "CUDA" in p.stderr


@pytest.mark.parametrize("cell,trace", [("vo.offline", False), ("vo.offline", True), ("vo.live", False)])
def test_one_line_has_the_contracts_keys(cell, trace):
    ov = dict(SMALL, traffic=dict(SMALL["traffic"], period_s=0.3)) if cell == "vo.live" else SMALL_CLOSED
    code, out = harness.run_cell(cell, 2**33 + 5, 1.5, trace, time.perf_counter(), device="cpu", overrides=ov, workers=2)
    assert code == 0 and out["correct"] is True
    want = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    assert set(out["metrics"]) <= {m["name"] for m in (per_layer if trace else e2e)}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in e2e}
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    json.dumps(out)
