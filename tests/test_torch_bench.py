"""The port's benchmark (vo_tpu_torch/bench.py, ``python -m vo_tpu_torch bench``) on the CPU: the
rendered-frame cache against the reference's ``bench.preload_cached`` (the same bytes, the same
file both ways, invalidated by other poses), the stage breakdown's keys, the profiler's launch count, and the one JSON line. Feeds are small (a
reduced image size and landmark count). The reference writes its cache under /tmp by a fixed name;
here each test moves that file into its own directory, so no two runs share one."""
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import vo_tpu_torch.__main__ as p_main
from vo_tpu_torch import bench
from vo_tpu_torch.config import PipelineConfig, RansacConfig, SIFTConfig
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "kitti"
SIZE = (60, 200)
N, LANDMARKS = 3, 400
SMALL = ["--image-size", "94,310", "--max-keypoints", "128", "--hypotheses", "64"]
# The reference's keys that keep a meaning on a card, and the port's own (module docstring).
KEYS = {
    "metric", "value", "unit", "vs_baseline", "vs_realtime", "sustained_fps", "sustained_frames", "cpu_baseline_fps",
    "ate_rmse_m", "n_frames", "per_frame_ms", "device", "device_kind", "per_frame_ms_runs", "per_frame_ms_min",
    "per_frame_ms_max", "sustained_ate_rmse_m", "pose_ok_frac", "matmul_precision", "power_limit_w", "graphed",
}
NO_COUNTERPART = {"est_flops_per_frame", "achieved_tflops", "est_mfu_bf16_peak", "hbm_staged_feed"}
REF_STAGE_KEYS = {"detect_describe_x2_ms", "stereo_match_ms", "temporal_track_ms", "triangulate_ransac_ms", "sum_ms", "note"}


@pytest.fixture(scope="module")
def ref_bench_module():
    """The reference's root bench.py as a module."""
    spec = importlib.util.spec_from_file_location("_reference_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _View:
    """A module seen with some of its attributes replaced."""

    def __init__(self, mod, **over):
        self._mod, self._over = mod, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._mod, name)


@pytest.fixture()
def ref_bench(ref_bench_module, tmp_path, monkeypatch):
    """(the reference's bench.py, its cache directory): the cache it names under /tmp is moved into
    the test's own directory ``ref``, as its os.path.exists, np.load and np.savez see it."""
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()

    def moved(fn):
        def call(path, *a, **k):
            assert path.startswith("/tmp/"), path
            return fn(str(ref_dir / path[len("/tmp/"):]), *a, **k)

        return call

    monkeypatch.setattr(ref_bench_module, "np", _View(np, load=moved(np.load), savez=moved(np.savez)))
    monkeypatch.setattr(ref_bench_module, "os", _View(os, path=_View(os.path, exists=moved(os.path.exists))))
    return ref_bench_module, ref_dir


@pytest.fixture(scope="module")
def geometry():
    """(port calib, reference calib, GT poses 0..N-1)."""
    from vo_tpu.io import kitti as r_kitti

    poses = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))[:N]
    return p_kitti.load_stereo_calib(str(DATA / "00")), r_kitti.load_stereo_calib(str(DATA / "00")), poses


def _frames(pre) -> np.ndarray:
    return np.stack([np.stack(f) for f in pre.frames])


@pytest.mark.parametrize("extra_noise", [0.0, 0.05])
def test_preload_cached_equals_reference(ref_bench, geometry, tmp_path, extra_noise):
    """The port's frames are the reference's byte for byte, with and without load-time noise. The
    reference adds ``extra_noise`` only when its cache was already there, so its second call is the
    one compared; the port adds it on a fresh render as on a reload."""
    ref, ref_dir = ref_bench
    p_calib, r_calib, poses = geometry
    kw = dict(seed=8101, image_size=SIZE, extra_noise=extra_noise)
    first = ref.preload_cached(r_calib, poses, N, LANDMARKS, **kw)
    want = ref.preload_cached(r_calib, poses, N, LANDMARKS, **kw)
    got = bench.preload_cached(p_calib, poses, N, LANDMARKS, cache_dir=str(tmp_path / "port"), **kw)
    again = bench.preload_cached(p_calib, poses, N, LANDMARKS, cache_dir=str(tmp_path / "port"), **kw)
    assert [p.name for p in ref_dir.iterdir()] == [p.name for p in (tmp_path / "port").iterdir()]
    assert _frames(got).dtype == np.uint8 and _frames(got).shape == (N, 2) + SIZE
    np.testing.assert_array_equal(_frames(got), _frames(want))
    np.testing.assert_array_equal(_frames(again), _frames(got))
    assert np.array_equal(_frames(first), _frames(want)) == (extra_noise == 0.0)
    np.testing.assert_allclose(got.calib.P1.numpy(), np.asarray(want.calib.P1), rtol=1e-6)


def test_parallel_render_equals_serial(geometry, tmp_path):
    p_calib, _, poses = geometry
    kw = dict(seed=8102, image_size=SIZE, noise=0.01)
    one = bench.preload_cached(p_calib, poses, N, LANDMARKS, cache_dir=str(tmp_path / "a"), **kw)
    two = bench.preload_cached(p_calib, poses, N, LANDMARKS, cache_dir=str(tmp_path / "b"), workers=2, **kw)
    np.testing.assert_array_equal(_frames(two), _frames(one))
    names = [sorted(os.listdir(tmp_path / d)) for d in ("a", "b")]
    assert names[0] == names[1] == [f"longrun_frames_v4_{N}_{LANDMARKS}_8102_{SIZE[0]}x{SIZE[1]}_n0.01.npz"]


def test_cache_invalidated_by_changed_poses(geometry, tmp_path):
    """A cache file is read where its poses are the caller's, and rendered anew where they are not."""
    p_calib, _, poses = geometry
    kw = dict(seed=8103, image_size=SIZE, cache_dir=str(tmp_path))
    fresh = _frames(bench.preload_cached(p_calib, poses, N, LANDMARKS, **kw))
    (path,) = tmp_path.iterdir()
    z = dict(np.load(path))
    np.savez(path, l=np.zeros_like(z["l"]), r=z["r"], poses=z["poses"])
    read = _frames(bench.preload_cached(p_calib, poses, N, LANDMARKS, **kw))
    assert not read[:, 0].any() and np.array_equal(read[:, 1], fresh[:, 1])  # the file was read
    moved = poses.copy()
    moved[-1, 2, 3] += 1.0  # the last camera a meter further on (a shift of all poses would move the scene too)
    other = _frames(bench.preload_cached(p_calib, moved, N, LANDMARKS, **kw))
    assert other[:, 0].any() and not np.array_equal(other, fresh)
    np.testing.assert_array_equal(np.load(path)["poses"], moved)


def test_cache_written_by_one_package_is_read_by_the_other(ref_bench, geometry):
    """Each package reads the other's file: a file whose left frames were zeroed afterwards comes back zeroed."""
    ref, ref_dir = ref_bench
    p_calib, r_calib, poses = geometry

    def zero_left(seed):
        (path,) = ref_dir.glob(f"longrun_frames_v4_{N}_{LANDMARKS}_{seed}_*.npz")
        z = dict(np.load(path))
        np.savez(path, l=np.zeros_like(z["l"]), r=z["r"], poses=z["poses"])
        return z["r"]

    bench.preload_cached(p_calib, poses, N, LANDMARKS, seed=8104, image_size=SIZE, cache_dir=str(ref_dir))
    right = zero_left(8104)
    by_ref = _frames(ref.preload_cached(r_calib, poses, N, LANDMARKS, seed=8104, image_size=SIZE))
    assert not by_ref[:, 0].any() and np.array_equal(by_ref[:, 1], right)

    ref.preload_cached(r_calib, poses, N, LANDMARKS, seed=8105, image_size=SIZE)
    right = zero_left(8105)
    by_port = _frames(bench.preload_cached(p_calib, poses, N, LANDMARKS, seed=8105, image_size=SIZE, cache_dir=str(ref_dir)))
    assert not by_port[:, 0].any() and np.array_equal(by_port[:, 1], right)


def test_stage_breakdown_keys_on_the_cpu():
    """The reference's four stage times and their sum, finite; the device's columns null on the CPU."""
    seq = p_syn.kitti_synthetic_sequence(n_frames=2, n_landmarks=1500, seed=8106, image_size=(94, 310))
    cfg = PipelineConfig(sift=SIFTConfig(max_keypoints=128), ransac=RansacConfig(n_hypotheses=64), max_tracks=128)
    out = bench.stage_breakdown(bench.Preloaded(seq, 2), cfg, device="cpu", n_iter=2)
    assert REF_STAGE_KEYS <= set(out)
    stages = [k[: -len("_ms")] for k in REF_STAGE_KEYS if k.endswith("_ms") and k != "sum_ms"]
    for s in stages:
        assert np.isfinite(out[f"{s}_ms"]) and out[f"{s}_ms"] > 0 and np.isfinite(out[f"{s}_enqueue_ms"])
        assert out[f"{s}_device_ms"] is None and out[f"{s}_busy_ms"] is None and out[f"{s}_launches"] is None
    assert out["sum_ms"] == pytest.approx(sum(out[f"{s}_ms"] for s in stages))


def _event(name, start, end, cuda=False):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end), device_type=kind)


def _session(counts):
    """The events of one profiled session (us): four calls 100 ms apart, each a host range, its
    device-side annotation and ``counts[k]`` launches of 5 us."""
    evs = []
    for k, (mark, c) in enumerate(zip(bench._MARKS, counts)):
        t = 1e5 * k
        evs += [_event(mark, t, t + 1e3), _event(mark, t + 10, t + 1e3, cuda=True)]
        evs += [_event("kernel", t + 20 + 10 * j, t + 25 + 10 * j, cuda=True) for j in range(c)]
    return evs


@pytest.mark.parametrize(
    "sessions,want",
    [
        ([(5, 7, 7, 3)], 7),  # launches lost at the session's start and end are not counted
        ([(7, 6, 7, 7), (7, 7, 7, 7)], 7),  # the counted calls disagree: a second session
        ([(7, 6, 7, 7)] * 3, None),  # they never agree: no count
    ],
    ids=["edges_lost", "second_session", "never_agree"],
)
def test_profile_call_counts_only_what_two_calls_agree_on(sessions, want, monkeypatch):
    queue = [_session(c) for c in sessions]

    class FakeProfile:
        def __init__(self, activities):
            self.evs = queue.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.evs

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    calls = []
    fn = lambda: calls.append(1)  # noqa: E731
    if want is None:
        with pytest.raises(RuntimeError, match="lost launches"):
            bench._profile_call(fn, torch.device("cpu"))
    else:
        busy, launches = bench._profile_call(fn, torch.device("cpu"))
        assert launches == want and busy == pytest.approx(want * 5e-3)
    assert not queue and len(calls) == 4 * len(sessions)


def test_main_prints_one_json_line(capsys):
    """Every key of the port's line, none the port has no counterpart for; the precision named is the run's."""
    argv = ["--cpu", "--frames", "2", "--sustained-frames", "0", "--repeats", "2", "--precision", "float32", *SMALL]
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert KEYS <= set(out) and not NO_COUNTERPART & set(out)
    assert out["metric"] == "frames_per_sec" and out["n_frames"] == 2 and out["device"] == "cpu"
    assert len(out["per_frame_ms_runs"]) == 2 and out["per_frame_ms_min"] <= out["per_frame_ms"] <= out["per_frame_ms_max"]
    assert out["value"] == pytest.approx(np.median([1e3 / ms for ms in out["per_frame_ms_runs"]]))
    assert out["vs_realtime"] == pytest.approx(out["value"] / 9.6)
    assert out["sustained_fps"] is None and out["sustained_frames"] is None and out["power_limit_w"] is None
    assert np.isfinite(out["ate_rmse_m"]) and out["ate_rmse_m"] < 0.05 and out["pose_ok_frac"] == 1.0
    assert out["matmul_precision"] == "float32"
    assert out["graphed"] is False  # the CPU runs the eager step


def test_bench_subcommand_exits_0():
    """``python -m vo_tpu_torch bench --cpu ...`` as a user types it."""
    argv = ["bench", "--cpu", "--frames", "2", "--sustained-frames", "0", "--repeats", "1", *SMALL]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-m", "vo_tpu_torch", *argv], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert KEYS <= set(out) and out["per_frame_ms_runs"] and out["device"] == "cpu"


def test_main_without_a_card_raises(monkeypatch):
    """No --cpu means the card: without one, the default-device error, and nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "Preloaded", None)  # reached only after the device is resolved
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.main(["--frames", "2", "--sustained-frames", "0"])


@pytest.mark.parametrize("argv", [["--precision", "bfloat16"], ["--repeats", "0"]])
def test_main_refuses_bad_flags(argv, capsys):
    with pytest.raises(SystemExit) as e:
        p_main.main(["bench", "--cpu", *argv])
    assert e.value.code == 2
    assert argv[0] in capsys.readouterr().err
