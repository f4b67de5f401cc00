"""tools/diag_ba_torch.py and tools/diag_lc_torch.py on the CPU, against tools/diag_ba.py and
tools/diag_lc.py.

- ``rel_err`` is the reference tool's function, on random SE(3) pairs.
- The reference tool's hook is dead: ``vo_tpu``'s refined run over a 30-frame half-size
  out-and-back never calls ``WindowedBA.optimize`` (its refiner calls ``dispatch`` and
  ``collect``), while ``diag_ba_torch`` over the same feed logs the solves at ``collect``: at
  least one with cost <= cost0 and n_obs > 30, one row per solve past the cost gate, "solved"
  exactly as often as the run counts solves.
- ``diag_lc_torch``'s hook logs the closure of tests/test_torch_loop_closure.py's drift case (the
  out-and-back GT 0..9 then 8..0 at 160x320) and rows that say it brought the keyframes nearer
  the truth; its command line runs a ``vo_lc`` run over a short feed.
"""
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch import config as p_config
from vo_tpu_torch.ba import pose_graph as p_pg
from vo_tpu_torch.frontend.sift import detect_and_describe
from vo_tpu_torch.frontend.track import stereo_features_with_matches
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import synthetic as p_syn
from vo_tpu_torch.slam import loop_closure as p_lc

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "kitti"
HALF = (188, 620)
OUT_AND_BACK = 30  # frames of the half-size out-and-back
LANDMARKS = 3000
ROW_KEYS = {"kf", "solved", "cost0", "cost", "n_obs", "rel_t_before", "rel_r_before", "rel_t_last_before", "rel_t_after",
            "rel_r_after", "rel_t_last_after", "abs_t_before", "abs_t_after"}  # tools/diag_ba.py's
LC_ROW_KEYS = {"loop", "z_err_m", "kf_rms_before", "kf_rms_after", "kf_max_before", "kf_max_after"}  # tools/diag_lc.py's


def _load(name: str):
    sys.path.insert(0, str(REPO / "tools"))
    spec = importlib.util.spec_from_file_location(f"_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def diag_ba():
    return _load("diag_ba_torch")


@pytest.fixture(scope="module")
def diag_lc():
    return _load("diag_lc_torch")


def _out_and_back(n: int) -> np.ndarray:
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    half = (n + 1) // 2
    return np.concatenate([gt[:half], gt[:half][::-1]])[:n]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rel_err_equals_the_reference(diag_ba, seed):
    ref = _load("diag_ba")  # imports jax only inside main
    rng = np.random.default_rng(seed)
    for _ in range(20):
        Ta = p_pg._np_exp_se3(rng.normal(scale=[2, 2, 2, 0.5, 0.5, 0.5]))
        Tb = p_pg._np_exp_se3(rng.normal(scale=[2, 2, 2, 0.5, 0.5, 0.5]))
        assert diag_ba.rel_err(Ta, Tb) == ref.rel_err(Ta, Tb)
    assert diag_ba.rel_err(Ta, Ta) == pytest.approx((0.0, 0.0), abs=1e-6)


def test_reference_diag_ba_hook_never_fires(monkeypatch):
    """tools/diag_ba.py wraps ``WindowedBA.optimize``; the reference's refined run never calls it."""
    from vo_tpu.config import PipelineConfig
    from vo_tpu.io import kitti, synthetic
    from vo_tpu.odometry import ba_runner, runner

    poses = _out_and_back(OUT_AND_BACK)
    seq = synthetic.SyntheticSequence(kitti.load_stereo_calib(str(DATA / "00")), poses, n_landmarks=LANDMARKS, seed=0,
                                      image_size=HALF)
    calls = dict(optimize=0, dispatch=0, collect=0)
    for name in calls:
        orig = getattr(ba_runner.WindowedBA, name)

        def counted(self, *a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(ba_runner.WindowedBA, name, counted)
    res = runner.run_sequence(seq, PipelineConfig(), n_frames=OUT_AND_BACK, use_ba=True)
    assert res.refine_stats["ba_solves"] >= 1
    assert calls["optimize"] == 0 and calls["dispatch"] >= 1 and calls["collect"] >= 1, calls


def test_diag_ba_logs_every_solve_past_the_cost_gate(diag_ba, tmp_path, monkeypatch, capsys):
    """The command line over the same half-size out-and-back on the CPU (rendered into a cache of its own)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = tmp_path / "diag_ba.json"
    assert diag_ba.main(["--cpu", "--half", "--frames", str(OUT_AND_BACK), "--landmarks", str(LANDMARKS),
                         "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    rows, summary = got["rows"], got["summary"]
    assert rows and all(set(r) == ROW_KEYS for r in rows)
    assert all(r["cost"] <= r["cost0"] for r in rows)  # only solves past the cost gate are logged
    assert any(r["n_obs"] > 30 for r in rows)
    solved = [r for r in rows if r["solved"]]
    assert len(solved) == summary["ba_solves"] >= 1
    assert summary["solves_improving_window"] + summary["solves_degrading_window"] == len(solved)
    assert summary["graphed"] is False and np.isfinite(summary["ate_rmse"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in printed[-len(rows) - 1:-1]] == rows


def test_solve_log_is_left_uninstalled(diag_ba):
    from vo_tpu_torch.odometry.ba_runner import WindowedBA

    prepare, collect = WindowedBA.prepare, WindowedBA.collect
    with pytest.raises(RuntimeError):
        with diag_ba.SolveLog(np.eye(4)[None]).installed():
            assert WindowedBA.collect is not collect
            raise RuntimeError
    assert (WindowedBA.prepare, WindowedBA.collect) == (prepare, collect)


@pytest.fixture(scope="module")
def loop():
    """tests/test_torch_loop_closure.py's feed: (calib at 160x320, true poses, per-frame stereo features)."""
    gt = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))
    poses = np.concatenate([gt[:10], gt[8::-1]])
    seq = p_syn.SyntheticSequence(p_kitti.load_stereo_calib(str(DATA / "00")), poses, n_landmarks=2500, seed=12,
                                  image_size=(160, 320))
    sift = p_config.SIFTConfig(max_keypoints=384, n_octaves=2)
    feats = []
    for i in range(len(poses)):
        f = detect_and_describe(torch.from_numpy(np.stack(seq.frame(i))), sift)
        fl, fr = (type(f)(*(x[k] for x in f)) for k in (0, 1))
        sf, _ = stereo_features_with_matches(fl, fr, p_config.MatcherConfig(), 384)
        feats.append(sf)
    return seq.calib, poses, feats


def test_diag_lc_logs_the_closure(diag_lc, loop):
    """The drift case (0.12 m more per keyframe) through a LoopCloser with the hook installed."""
    calib, poses, feats = loop
    cfg = p_config.LoopConfig(radius=8.0, min_gap=8, min_inliers=15, max_keyframes=32, graph_iters=10)
    lc = p_lc.LoopCloser(calib, cfg, device="cpu")
    log = diag_lc.ClosureLog()
    fired = []
    with log.installed():
        for i, sf in enumerate(feats):
            drift = np.eye(4, dtype=np.float32)
            drift[0, 3] = 0.12 * i
            kf = p_lc.ArchivedKeyframe(frame_idx=i, pose_c2w=(drift @ poses[i]).astype(np.float32), l_px=sf.l_xy.numpy(),
                                       r_px=sf.r_xy.numpy(), l_desc=sf.l_desc.numpy(), mask=sf.mask.numpy())
            res = lc.add_keyframe(kf)
            if res is not None:
                fired.append(res["loop"])
    assert p_lc.LoopCloser._solve_graph.__name__ == "_solve_graph"  # uninstalled
    rows = log.rows(poses)
    assert fired and len(rows) == len(fired)
    for row, (old_k, new_k) in zip(rows, fired):
        assert set(row) == LC_ROW_KEYS
        assert row["loop"] == (lc.keyframes[old_k].frame_idx, lc.keyframes[new_k].frame_idx)
        assert row["z_err_m"] < 0.5
    assert any(r["kf_rms_after"] < r["kf_rms_before"] for r in rows)


def test_diag_lc_main_runs_vo_lc(diag_lc, monkeypatch, capsys):
    """The command line on the CPU over 6 frames (a 160x320 render in place of the 4,500-frame cache)."""
    from vo_tpu_torch.bench import preload_cached

    import longrun_torch

    seen = {}

    def small(calib, gt, n, n_landmarks, noise=0.0, extra_noise=0.0, workers=1):
        seen.update(n=n, n_landmarks=n_landmarks, noise=noise, extra_noise=extra_noise)
        return preload_cached(calib, gt, n, 900, image_size=(160, 320), noise=noise, extra_noise=extra_noise,
                              cache_dir=tempfile.mkdtemp())

    monkeypatch.setattr(longrun_torch, "load_or_render", small)
    assert diag_lc.main(["--cpu", "--frames", "6", "--extra-noise", "0.08", "--workers", "1"]) == 0
    assert seen == dict(n=6, n_landmarks=54000, noise=0.02, extra_noise=0.08)
    summary = next(json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{"))
    assert summary["n_keyframes"] == 1 and summary["loops_closed"] == 0 and summary["graphed"] is False
