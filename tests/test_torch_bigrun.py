"""tools/bigrun_torch.py on the CPU: ``run_configs`` for ``vo`` and ``vo_lc`` over a short KITTI-00
feed with a loop-closer capacity small enough that its graph is decimated, against the
reference's payload keys (``tools/bigrun.py``, the committed ``BIGRUN_r05.json``) and the
reference ``LoopCloser``'s keyframe and decimation counts; the saved trajectories read by the
unchanged ``tools/diag_axes.py``; the figures, or the note that they were skipped; and the
decimation counts of the full run (899 keyframes at capacity 512) and of ``chip_smoke.py``'s
phase 14 (39 at capacity 16), the port's ``LoopCloser`` against the reference's. (160, 320)
images, 12 frames, 256 keypoints."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch import config as p_config
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.odometry import runner as p_runner
from vo_tpu_torch.slam import loop_closure as p_lc

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "kitti"
SIZE = (160, 320)
N_FRAMES = 12
KEYFRAME_EVERY = 2
CAPACITY = 3
# The reference's keys of a configuration (tools/bigrun.py), and the refiner's that every loop-closure run has.
KEYS = {"frames_per_sec", "per_frame_ms", "ate_rmse_m", "ate_max_m", "xz_mean_m", "xz_max_m", "pose_ok_frac",
        "tracks_mean", "inliers_mean"}
LC_KEYS = {"loops_closed", "ba_solves", "loops_skipped_small", "decimations", "lc_verified", "main_wait_s", "n_keyframes"}
PORT_KEYS = {"xz_final_m", "peak_memory_bytes", "pool_bytes", "graphed", "n_keyframes", "decimations"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bigrun():
    sys.path.insert(0, str(REPO / "tools"))
    return _load(REPO / "tools" / "bigrun_torch.py", "_bigrun_torch")


def _cfg():
    return p_config.PipelineConfig(
        sift=p_config.SIFTConfig(max_keypoints=256, n_octaves=2),
        ransac=p_config.RansacConfig(n_hypotheses=128),
        ba=p_config.BAConfig(keyframe_every=KEYFRAME_EVERY, window=6),
        loop=p_config.LoopConfig(max_keyframes=CAPACITY),
        max_tracks=256,
    )


def reference_loop_closer_counts(n_keyframes: int, capacity: int, closer=None):
    """(keyframes archived, decimations, surviving frame indices) of a LoopCloser with ``capacity``
    nodes after ``n_keyframes`` keyframes that propose no loop candidate (100 m apart, outside
    ``radius``; appearance retrieval off), so only the capacity rule acts. The reference's by default."""
    if closer is None:
        from vo_tpu.io import kitti as r_kitti
        from vo_tpu.slam import loop_closure as r_lc

        lc = r_lc.LoopCloser(r_kitti.load_stereo_calib(str(DATA / "00")), r_lc.LoopConfig(max_keyframes=capacity, appearance=False))
        make = r_lc.ArchivedKeyframe
    else:
        lc, make = closer, p_lc.ArchivedKeyframe
    for k in range(n_keyframes):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 100.0 * k
        g = np.zeros(128, np.float32)
        lc.add_keyframe(make(frame_idx=5 * (k + 1), pose_c2w=pose, l_px=None, r_px=None, l_desc=None, mask=None, global_desc=g))
    return n_keyframes, lc.decimations, [kf.frame_idx for kf in lc.keyframes]


@pytest.mark.parametrize("n_keyframes,capacity,decimations", [(39, 16, 3), (899, 512, 2), (5, 3, 2)])
def test_decimations_equal_the_reference(n_keyframes, capacity, decimations):
    """899 keyframes at the default capacity 512 (4,499 frames at keyframe_every 5) decimate twice,
    as in BIGRUN_r05; chip_smoke.py's phase 14 (199 frames, capacity 16) three times."""
    want = reference_loop_closer_counts(n_keyframes, capacity)
    cfg = p_config.LoopConfig(max_keyframes=capacity, appearance=False)
    port = p_lc.LoopCloser(p_kitti.load_stereo_calib(str(DATA / "00")), cfg, device="cpu")
    assert reference_loop_closer_counts(n_keyframes, capacity, closer=port) == want
    assert want[1] == decimations


def test_full_run_decimations_match_bigrun_r05():
    ref = json.loads((REPO / "BIGRUN_r05.json").read_text())["configs"]["vo_lc"]
    # 899 keyframes at capacity 512 decimate twice: test_decimations_equal_the_reference.
    assert (ref["n_keyframes"], ref["decimations"]) == (899, 2) and p_config.LoopConfig().max_keyframes == 512


@pytest.fixture(scope="module")
def feed(tmp_path_factory):
    """12 frames of the KITTI-00 trajectory at (160, 320), through the cache, staged on the CPU."""
    from vo_tpu_torch.bench import preload_cached, stage_frames

    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))[:N_FRAMES]
    calib = p_kitti.load_stereo_calib(str(DATA / "00"))
    pre = preload_cached(calib, gt, N_FRAMES, 1500, seed=8301, image_size=SIZE, noise=0.02,
                         cache_dir=str(tmp_path_factory.mktemp("cache")))
    times = np.arange(N_FRAMES) * p_runner.KITTI_DT
    pre.times = times
    return stage_frames(pre, "cpu"), gt, times


@pytest.fixture(scope="module")
def payload(bigrun, feed, tmp_path_factory):
    staged, gt, times = feed
    fig_dir = tmp_path_factory.mktemp("figs")
    out = bigrun.run_configs(staged, gt, times, _cfg(), ["vo", "vo_lc"], "cpu", fig_dir=str(fig_dir), save_traj=True)
    return out, fig_dir


def test_payload_has_the_reference_keys(payload):
    out, _ = payload
    assert out["n_frames"] == N_FRAMES and out["device"] == "cpu" and out["device_kind"] == "cpu"
    assert out["power_limit_w"] is None and out["seed"] == 0
    vo, lc = out["configs"]["vo"], out["configs"]["vo_lc"]
    ref = json.loads((REPO / "BIGRUN_r05.json").read_text())["configs"]
    assert set(ref["vo"]) == KEYS and LC_KEYS <= set(ref["vo_lc"])
    assert set(vo) == KEYS | PORT_KEYS
    assert KEYS | LC_KEYS | PORT_KEYS <= set(lc)
    for row in (vo, lc):
        assert all(np.isfinite(row[k]) for k in KEYS)
        assert row["pose_ok_frac"] >= 0.9 and row["peak_memory_bytes"] is None and row["pool_bytes"] is None
        assert row["graphed"] is False  # the CPU steps eagerly
    assert vo["ate_rmse_m"] < 0.1
    assert (vo["n_keyframes"], vo["decimations"]) == (0, 0) and out["graphed"] is False


def test_keyframes_and_decimations_equal_the_reference_loop_closer(payload):
    lc = payload[0]["configs"]["vo_lc"]
    n_kf = (N_FRAMES - 1) // KEYFRAME_EVERY
    _, decimations, _ = reference_loop_closer_counts(n_kf, CAPACITY)
    assert lc["n_keyframes"] == n_kf and lc["decimations"] == decimations >= 1


def test_saved_trajectory_is_read_by_diag_axes(bigrun, payload, feed, monkeypatch, capsys):
    out, fig_dir = payload
    diag = _load(REPO / "tools" / "diag_axes.py", "_diag_axes")
    gt = feed[1]
    for name in ("vo", "vo_lc"):
        z = np.load(fig_dir / f"traj_{name}.npz")
        assert set(z.files) == {"poses", "gt"}
        np.testing.assert_array_equal(z["gt"], gt)
        d = diag.decompose(z["poses"], z["gt"][1:])
        assert d["ate_rmse_m"] == pytest.approx(out["configs"][name]["ate_rmse_m"], abs=1e-4)
    monkeypatch.setattr(sys, "argv", ["diag_axes.py", "--fig-dir", str(fig_dir)])
    diag.main()
    printed = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[0] for line in printed] == ["vo", "vo_lc"]


def test_figures_written_or_skipped(bigrun, payload, feed, tmp_path, monkeypatch):
    out, fig_dir = payload
    if importlib.util.find_spec("matplotlib") is None:
        assert out["figures"] == "skipped: no matplotlib"
    else:
        assert out["figures"].startswith("written")
        for f in ("error_vo.png", "map_vo.png", "error_vo_lc.png", "map_vo_lc.png", "error_parity.png"):
            assert (fig_dir / f).stat().st_size > 0, f
    # Without matplotlib the run goes on and says so; the trajectory is still saved.
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "matplotlib" else find(name, *a))
    staged, gt, times = feed
    few = gt[:4]
    skipped = bigrun.run_configs(staged, few, times, _cfg(), ["vo"], "cpu", fig_dir=str(tmp_path), save_traj=True)
    assert skipped["figures"] == "skipped: no matplotlib"
    assert (tmp_path / "traj_vo.npz").exists() and not (tmp_path / "error_vo.png").exists()
    assert bigrun.run_configs(staged, few, times, _cfg(), ["vo"], "cpu")["figures"] is None


def test_seed_reaches_run_sequence(bigrun, feed, monkeypatch):
    """``seed`` is run_sequence's (the RANSAC draws), for every configuration."""
    staged, gt, times = feed
    seen = []
    run = p_runner.run_sequence

    def spy(*a, **k):
        seen.append((k["seed"], k["use_loop_closure"]))
        return run(*a, **k)

    monkeypatch.setattr(p_runner, "run_sequence", spy)
    out = bigrun.run_configs(staged, gt[:4], times, _cfg(), ["vo", "vo_lc"], "cpu", seed=7)
    assert seen == [(7, False), (7, True)] and out["seed"] == 7


def test_main_without_a_card_raises(bigrun, monkeypatch):
    """No --cpu means the card: without one, the default-device error before anything is rendered."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(REPO / "tools"))
    import longrun_torch

    monkeypatch.setattr(longrun_torch, "load_or_render", None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bigrun.main(["--frames", "4", "--configs", "vo"])


def test_main_refuses_an_unknown_config(bigrun, capsys):
    with pytest.raises(SystemExit) as e:
        bigrun.main(["--cpu", "--configs", "vo,vo_xx"])
    assert e.value.code == 2 and "vo_xx" in capsys.readouterr().err


def _result(rng, n=8, n_lm=5):
    return p_runner.RunResult(
        poses=rng.normal(size=(n, 4, 4)).astype(np.float32), rel_poses=rng.normal(size=(n, 4, 4)).astype(np.float32),
        n_inliers=rng.integers(0, 99, n), n_tracks=rng.integers(0, 99, n), pose_ok=np.ones(n, bool),
        landmarks=rng.normal(size=(n_lm, 3)).astype(np.float32), frames_per_sec=1.0, per_frame_ms=1.0,
        refine_stats=dict(n_keyframes=3, decimations=1, lc_verified=2, loops_closed=1),
    )


def test_first_difference_names_the_first_frame_and_field(bigrun):
    """Equal runs give None; otherwise the earliest differing frame (history row r is frame r + 1) with
    every field that differs there, and apart the landmarks' row and the refiner's counts."""
    a = _result(np.random.default_rng(3))
    b = _result(np.random.default_rng(3))
    assert bigrun.first_difference(a, b) is None
    b.n_inliers[4] += 1
    b.poses[4, 0, 3] += 0.5
    b.rel_poses[6, 1, 1] = np.nan
    assert bigrun.first_difference(a, b) == dict(frame=5, fields=["poses", "n_inliers"],
                                                 max_abs_pose_diff=pytest.approx(0.5, rel=1e-5))
    a.rel_poses[6, 1, 1] = np.nan  # NaN against NaN differs too: equal means the same bits
    assert bigrun.first_difference(a, b)["frame"] == 5
    c = _result(np.random.default_rng(3))
    c.landmarks[2, 1] += 1.0
    c.refine_stats["decimations"] = 2
    assert bigrun.first_difference(_result(np.random.default_rng(3)), c) == dict(
        max_abs_pose_diff=0.0, other={"landmarks": "row 2 of 5"}, refine_stats={"decimations": (1, 2)})


@pytest.mark.parametrize("flag,configs", [("--eager", "vo"), ("--compare", "vo_lc")])
def test_main_eager_and_compare(bigrun, flag, configs, tmp_path):
    """6 frames at half size on the CPU: ``--eager`` runs with graph=False (``graphed`` false);
    ``--compare`` runs each configuration again eagerly and finds the two equal bit for bit (on the
    CPU both are eager: the check that a run repeats), with the eager run's figures beside."""
    out = tmp_path / "big.json"
    assert bigrun.main(["--cpu", "--frames", "6", "--image-size", "188,620", "--configs", configs, flag,
                        "--cache-dir", str(tmp_path), "--fig-dir", str(tmp_path / "figs"), "--workers", "1",
                        "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    row = payload["configs"][configs]
    assert payload["graphed"] is False and row["graphed"] is False and payload["image_size"] == [188, 620]
    assert payload["compare"] is (flag == "--compare")
    if flag == "--compare":
        assert row["bit_equal_to_eager"] is True and "first_difference" not in row
        assert set(row["eager"]) == set(bigrun.EAGER_KEYS) and row["eager"]["graphed"] is False
        assert row["eager"]["ate_rmse_m"] == row["ate_rmse_m"] and row["n_keyframes"] == 1
    else:
        assert "bit_equal_to_eager" not in row and row["n_keyframes"] == 0


def test_main_refuses_eager_with_compare(bigrun, capsys):
    with pytest.raises(SystemExit) as e:
        bigrun.main(["--cpu", "--eager", "--compare"])
    assert e.value.code == 2 and "--compare" in capsys.readouterr().err
