"""tools/severity_sweep_torch.py on the CPU: ``load_prefix`` against the reference's
``tools/severity_sweep.load_prefix`` on the same cache file (byte for byte, with and without
load-time noise) and against ``preload_cached(extra_noise=)`` (a sweep level reproduces a full
run's frames), ``reference_error_at`` against the reference's, and ``main`` over a tiny cache
(rows per level, configuration and seed; the default-device rule). (160, 320) images, 12-frame
cache, every file under the test's own directory."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch import bench
from vo_tpu_torch.io import kitti as p_kitti

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "kitti"
N, LANDMARKS, NOISE, SEED = 12, 1500, 0.02, 8501
CSV = REPO / "REFERENCE_ERROR_CURVE.csv"


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sweep():
    sys.path.insert(0, str(REPO / "tools"))
    return _load(REPO / "tools" / "severity_sweep_torch.py", "_severity_sweep_torch")


@pytest.fixture(scope="module")
def ref_sweep():
    return _load(REPO / "tools" / "severity_sweep.py", "_reference_severity_sweep")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache")
    poses = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))[:N]
    calib = p_kitti.load_stereo_calib(str(DATA / "00"))
    bench.preload_cached(calib, poses, N, LANDMARKS, SEED, image_size=(160, 320), noise=NOISE, cache_dir=str(d))
    return bench.cache_path(N, LANDMARKS, SEED, (160, 320), NOISE, str(d)), calib, poses


def _frames(pre) -> np.ndarray:
    return np.stack([np.stack(f) for f in pre.frames])


@pytest.mark.parametrize("extra_noise,n,seed", [(0.0, N, 0), (0.08, 7, 0), (0.15, N, 3)])
def test_load_prefix_equals_the_reference(sweep, ref_sweep, cache, extra_noise, n, seed):
    path = cache[0]
    got, want = sweep.load_prefix(path, n, extra_noise, seed), ref_sweep.load_prefix(path, n, extra_noise, seed)
    f = _frames(got)
    assert f.dtype == np.uint8 and f.shape == (n, 2, 160, 320)
    np.testing.assert_array_equal(f, _frames(want))
    np.testing.assert_array_equal(got.gt_poses, want.gt_poses)
    assert isinstance(got, bench.Preloaded) and len(got) == n


def test_a_level_reproduces_preload_cached(sweep, cache):
    """The same streams as preload_cached's load-time noise: a level's frames are a full run's."""
    path, calib, poses = cache
    full = bench.preload_cached(calib, poses, N, LANDMARKS, SEED, image_size=(160, 320), noise=NOISE, extra_noise=0.08,
                                cache_dir=str(Path(path).parent))
    np.testing.assert_array_equal(_frames(sweep.load_prefix(path, N, 0.08, SEED)), _frames(full))


@pytest.mark.parametrize("t", [0.0, 10.0, 155.6, 466.8, 1e4])
def test_reference_error_at_equals_the_reference(sweep, ref_sweep, t):
    assert sweep.reference_error_at(t, str(CSV)) == ref_sweep.reference_error_at(t, str(CSV))


def test_main_rows(sweep, cache, tmp_path, capsys):
    """One level, vo at two seeds, over 3 frames: a row each, with the reference's keys."""
    out = tmp_path / "sweep.json"
    assert sweep.main(["--cpu", "--frames", "3", "--levels", "0.05", "--cache", cache[0], "--seeds", "0,1",
                       "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [(r["config"], r["seed"], r["extra_noise"]) for r in rows] == [("vo", 0, 0.05), ("vo", 1, 0.05)]
    ref_keys = {"config", "extra_noise", "effective_sigma", "frames", "fps", "xz_mean_m", "xz_max_m", "xz_final_m",
                "ate_rmse_m", "pose_ok_frac", "tracks_mean", "inliers_mean", "ref_xz_at_t"}
    for r in rows:
        assert ref_keys <= set(r) and r["frames"] == 3 and r["device_kind"] == "cpu" and r["graphed"] is False
        assert np.isfinite(r["ate_rmse_m"]) and r["pose_ok_frac"] == 1.0
        assert r["effective_sigma"] == pytest.approx((0.02**2 + 0.05**2) ** 0.5)
    assert "digitized reference xz error" in capsys.readouterr().out


def test_default_cache_is_the_full_render(sweep, monkeypatch):
    """Without --cache: the name preload_cached gives the 4,500-frame, 54,000-landmark, noise-0.02 render."""
    seen = {}

    def stop(cache, n, extra_noise, seed=0):
        seen["cache"] = cache
        raise SystemExit(0)

    monkeypatch.setattr(sweep, "load_prefix", stop)
    with pytest.raises(SystemExit):
        sweep.main(["--cpu", "--levels", "0.08"])
    assert seen["cache"] == bench.cache_path(4500, 54000, 0, None, 0.02)


def test_main_without_a_card_raises(sweep, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sweep, "load_prefix", None)  # reached only after the device is resolved
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sweep.main(["--frames", "4", "--levels", "0.0"])
