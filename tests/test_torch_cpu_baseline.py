"""tools/measure_cpu_baseline_torch.py on the CPU at a tiny size (the reference's keys in the file it
writes), the committed ``CPU_BASELINE_TORCH.json``, and the port's bench reading it: with a
baseline file its line carries ``cpu_baseline_fps`` and ``vs_baseline`` = fps over it, without
one null and fps / CAMERA_HZ, as the reference's bench falls back. Every file under the test's
own directory."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from vo_tpu_torch import bench

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--frames", "3", "--image-size", "94,310", "--landmarks", "400", "--max-keypoints", "128", "--hypotheses", "64"]
BENCH = ["--cpu", "--frames", "2", "--sustained-frames", "0", "--repeats", "1",
         "--image-size", "94,310", "--max-keypoints", "128", "--hypotheses", "64"]
# The reference's keys (tools/measure_cpu_baseline.py, the committed CPU_BASELINE.json).
REF_KEYS = set(json.loads((REPO / "CPU_BASELINE.json").read_text()))


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("_measure_cpu_baseline_torch", REPO / "tools" / "measure_cpu_baseline_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_writes_the_reference_keys(tool, tmp_path, capsys):
    out = tmp_path / "base.json"
    assert tool.main([*TINY, "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert REF_KEYS == {"cpu_fps", "per_frame_ms", "n_frames", "ate_rmse_m", "device", "cpu", "n_cpus", "config"}
    assert REF_KEYS <= set(got)
    assert got["device"] == "cpu" and got["n_frames"] == 3 and got["cpu_fps"] > 0 and got["n_cpus"] >= 1
    assert got["per_frame_ms"] == pytest.approx(1e3 / got["cpu_fps"]) and got["ate_rmse_m"] < 0.05
    assert got["cpu"] and "94" in got["config"] and "128 keypoints" in got["config"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got


def test_committed_baseline_names_its_machine():
    got = json.loads((REPO / "CPU_BASELINE_TORCH.json").read_text())
    assert REF_KEYS <= set(got)
    assert got["device"] == "cpu" and got["n_frames"] == 100 and got["cpu_fps"] > 0
    assert got["cpu"] and got["n_cpus"] >= 1 and "1241x376" in got["config"] and "1024 keypoints" in got["config"]


def _bench_line(capsys) -> dict:
    assert bench.main(BENCH) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[0])


def test_bench_reads_a_given_baseline(tmp_path, monkeypatch, capsys):
    path = tmp_path / "CPU_BASELINE_TORCH.json"
    path.write_text(json.dumps({"cpu_fps": 0.25}))
    monkeypatch.setattr(bench, "CPU_BASELINE_PATH", str(path))
    line = _bench_line(capsys)
    assert line["cpu_baseline_fps"] == 0.25
    assert line["vs_baseline"] == pytest.approx(line["value"] / 0.25)


def test_bench_without_a_baseline(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "CPU_BASELINE_PATH", str(tmp_path / "missing.json"))
    line = _bench_line(capsys)
    assert line["cpu_baseline_fps"] is None
    assert line["vs_baseline"] == pytest.approx(line["value"] / bench.CAMERA_HZ)


def test_bench_default_is_the_committed_file():
    assert Path(bench.CPU_BASELINE_PATH) == REPO / "CPU_BASELINE_TORCH.json"
    assert bench.load_cpu_baseline() == json.loads((REPO / "CPU_BASELINE_TORCH.json").read_text())
