"""The port's command line (python -m vo_tpu_torch) in process: the reference's flags, the
card unless --cpu, ``--mesh`` over launched ranks (gloo with --cpu), ``--precision``, and clear
exits for what is malformed."""
import argparse
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vo_tpu.__main__ as r_main
import vo_tpu_torch.__main__ as p_main
from vo_tpu_torch import config as p_config
from vo_tpu_torch import convert

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
SMALL = ["--max-keypoints", "256", "--hypotheses", "128"]


def _run_parser(mod):
    ap = argparse.ArgumentParser()
    return ap, mod._add_run(ap.add_subparsers(dest="cmd"))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """run --synthetic --frames 6 --cpu --checkpoint-every 4: the checkpoint of frame 4 stays behind."""
    out = tmp_path_factory.mktemp("cli") / "out"
    rc = p_main.main(["run", "--synthetic", "--frames", "6", "--cpu", "--out", str(out), "--checkpoint-every", "4", *SMALL])
    return rc, out


def test_run_flags_are_the_references():
    (_, p_run), (_, r_run) = _run_parser(p_main), _run_parser(r_main)
    flags = lambda p: {tuple(a.option_strings): (a.default, a.type, tuple(a.choices or ()), a.nargs) for a in p._actions}  # noqa: E731
    assert flags(p_run) == flags(r_run)


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["--no-view-3d", "--max-keypoints", "300", "--single-orientation"],
        ["--multi-orientation", "--hypotheses", "64", "--precision", "float32"],
        ["--loop-radius", "7.5", "--loop-min-inliers", "9", "--loop-max-keyframes", "40", "--no-loop-appearance",
         "--loop-drift-frac", "0.03"],
        ["--single-orientation", "--multi-orientation", "--precision", "default"],
    ],
)
def test_build_cfg_equals_reference(argv):
    p_ap, r_ap = _run_parser(p_main)[0], _run_parser(r_main)[0]
    got = p_main._build_cfg(p_ap.parse_args(["run", *argv]))
    want = convert.config_from_reference(r_main._build_cfg(r_ap.parse_args(["run", *argv])))
    assert type(got) is p_config.PipelineConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_run_synthetic_writes_its_files(cli_run):
    rc, out = cli_run
    assert rc == 0
    for name in ("trajectory.npz", "landmarks.npz", "stats.json", "metrics.json", "checkpoint.npz", "map.png", "error.png"):
        assert os.path.exists(out / name), name
    m = json.load(open(out / "metrics.json"))
    assert np.isfinite(m["ate"]["rmse"]) and m["ate"]["rmse"] < 0.05
    assert np.load(out / "trajectory.npz")["poses"].shape == (5, 4, 4)
    assert int(np.load(out / "checkpoint.npz")["frame_idx"]) == 4


def test_run_resumes_from_its_checkpoint(cli_run, tmp_path, capsys):
    """--resume in a directory that holds the checkpoint of frame 4 steps frames 4 and 5 only and
    ends on the trajectory of the uninterrupted run. (The synthetic feed depends on --frames, so the
    interrupted run is the same command.)"""
    _, full_out = cli_run
    out = tmp_path / "out"
    out.mkdir()
    shutil.copy(full_out / "checkpoint.npz", out / "checkpoint.npz")
    assert p_main.main(["run", "--synthetic", "--frames", "6", "--cpu", "--out", str(out), "--resume", "--progress", *SMALL]) == 0
    got, want = np.load(out / "trajectory.npz"), np.load(full_out / "trajectory.npz")
    np.testing.assert_array_equal(got["poses"], want["poses"])
    np.testing.assert_array_equal(got["n_inliers"], want["n_inliers"])
    text = capsys.readouterr().out
    assert "device: cpu" in text and "6 frames" in text and "frame 0:" not in text  # frames 0-3 were not stepped


def test_eval_prints_the_reference_keys(cli_run, capsys):
    _, out = cli_run
    capsys.readouterr()
    argv = ["eval", "--trajectory", str(out / "trajectory.npz"), "--poses", str(DATA / "poses" / "00.txt")]
    assert p_main.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert r_main.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want and set(got) == {"ate", "rpe", "xz_mean", "xz_max"}
    assert np.isfinite(got["ate"]["rmse"])


def test_missing_data_dir_exits_2(tmp_path, capsys):
    assert p_main.main(["run", "--data", str(tmp_path / "nowhere"), "--cpu"]) == 2
    assert "calib.txt" in capsys.readouterr().err
    assert p_main.main(["run", "--cpu"]) == 2
    assert "--data or --synthetic" in capsys.readouterr().err
    empty = tmp_path / "00"
    empty.mkdir()
    (empty / "calib.txt").write_text((DATA / "00" / "calib.txt").read_text())
    assert p_main.main(["run", "--data", str(empty), "--cpu"]) == 2
    assert "no frames" in capsys.readouterr().err


@pytest.mark.parametrize(
    "argv,message",
    [(["run", "--synthetic", "--cpu", "--mesh", "2"], "--mesh expects DATA,MODEL")],
)
def test_unported_surfaces_exit_2(argv, message, capsys):
    assert p_main.main(argv) == 2
    assert message in capsys.readouterr().err


def test_run_without_cpu_needs_a_card(monkeypatch, tmp_path, capsys):
    """No --cpu means the card: where there is none the run fails with the default-device message
    and nothing is computed on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    assert p_main.main(["run", "--synthetic", "--frames", "3", "--out", str(out), *SMALL]) == 2
    err = capsys.readouterr().err
    assert 'device="cpu"' in err and "--cpu" in err
    assert not out.exists()


def test_precision_default_is_accepted_and_explained(tmp_path, capsys, monkeypatch):
    """--precision reaches the run: "default" runs in float32 on the card as "float32" does
    (utils.precision), plain and with --ba, and the caller's flags are back afterwards."""
    from vo_tpu_torch.odometry import runner

    seen = []
    first = runner.resolve

    def spy(device):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return first(device)

    monkeypatch.setattr(runner, "resolve", spy)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for name in ("default", "float32"):
        for extra in ([], ["--ba"]):
            rc = p_main.main(["run", "--synthetic", "--frames", "2", "--cpu", "--precision", name, "--no-view-3d",
                              "--out", str(tmp_path / "o"), *SMALL, *extra])
            assert rc == 0
    assert seen == [(False, False)] * 4
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
    assert "note:" not in capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["run", "bench"])
def test_invalid_precision_exits_2(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        p_main.main([cmd, "--synthetic", "--cpu", "--precision", "bfloat16"] if cmd == "run" else [cmd, "--cpu", "--precision", "tf32"])
    assert e.value.code == 2
    assert "--precision" in capsys.readouterr().err


def test_mesh_needs_its_devices(monkeypatch, capsys):
    """On the card a mesh needs one card per rank; the message is the reference's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert p_main.main(["run", "--synthetic", "--mesh", "2,2"]) == 2
    assert "--mesh 2x2 needs 4 devices, have 1" in capsys.readouterr().err


def test_run_cpu_mesh_1x2_as_a_command(cli_run, tmp_path):
    """``run --cpu --mesh 1,2`` as a user types it: the process launches two gloo ranks, rank 0
    prints the reference's ``mesh:`` line and writes the results, and the ATE is the
    single-process run's within 0.02 m."""
    _, single_out = cli_run
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "vo_tpu_torch", "run", "--synthetic", "--frames", "6", "--cpu", "--mesh", "1,2",
           "--out", str(out), *SMALL]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent.parent, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the ranks too
        raise
    assert proc.returncode == 0, stderr
    assert "mesh: {'data': 1, 'model': 2} over 2 cpu devices" in stdout
    assert stdout.count("ATE rmse") == 1  # rank 0 alone reports
    meshed = json.load(open(out / "metrics.json"))["ate"]["rmse"]
    single = json.load(open(single_out / "metrics.json"))["ate"]["rmse"]
    assert abs(meshed - single) < 0.02
    assert np.load(out / "trajectory.npz")["poses"].shape == (5, 4, 4)
