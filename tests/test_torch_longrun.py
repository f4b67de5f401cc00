"""tools/longrun_torch.py on the CPU: the out-and-back trajectory against the reference's
``tools/longrun.py`` on the committed KITTI-00 poses, and ``run_matrix`` (the four
configurations) over a short out-and-back feed at a small configuration, with the
reference's per-configuration keys."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch import config as p_config
from vo_tpu_torch.io import kitti as p_kitti

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "kitti"
SIZE = (160, 320)
N_FRAMES = 12
# The reference's keys of one configuration (tools/longrun.py), besides refine_stats.
KEYS = {"frames_per_sec", "per_frame_ms", "ate_rmse_m", "ate_max_m", "xz_mean_m", "xz_max_m", "pose_ok_frac"}
REFINE_KEYS = {"n_keyframes", "main_wait_s"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def longrun():
    return _load(REPO / "tools" / "longrun_torch.py", "_longrun_torch")


@pytest.fixture(scope="module")
def ref_longrun():
    return _load(REPO / "tools" / "longrun.py", "_reference_longrun")


@pytest.mark.parametrize("n", [1, 2, 7, 12, 600])
def test_out_and_back_equals_reference(longrun, ref_longrun, monkeypatch, n):
    """The reference reads its dataset's pose file; pointed at the committed one it must give the same poses."""
    from vo_tpu.io import kitti as r_kitti

    committed = str(DATA / "poses" / "00.txt")
    read = r_kitti.read_poses
    monkeypatch.setattr(r_kitti, "read_poses", lambda path: read(committed))
    got = longrun.out_and_back_poses(n)
    np.testing.assert_array_equal(got, ref_longrun.out_and_back_poses(n))
    gt = p_kitti.read_poses(committed)
    half = (n + 1) // 2
    assert got.shape == (n, 4, 4)
    np.testing.assert_array_equal(got[:half], gt[:half])
    np.testing.assert_array_equal(got[half:], gt[:half][::-1][: n - half])


def _cfg():
    return p_config.PipelineConfig(
        sift=p_config.SIFTConfig(max_keypoints=256, n_octaves=2),
        ransac=p_config.RansacConfig(n_hypotheses=128),
        ba=p_config.BAConfig(keyframe_every=2, window=6),
        loop=p_config.LoopConfig(radius=8.0, min_gap=2, min_inliers=15),
        max_tracks=256,
    )


@pytest.fixture(scope="module")
def matrix(longrun, tmp_path_factory):
    poses = longrun.out_and_back_poses(N_FRAMES)
    calib = p_kitti.load_stereo_calib(str(DATA / "00"))
    pre = longrun.load_or_render(
        calib, poses, N_FRAMES, 2500, seed=8301, image_size=SIZE, cache_dir=str(tmp_path_factory.mktemp("cache"))
    )
    return longrun.run_matrix(pre, poses, _cfg(), "cpu", noise=0.0)


def test_run_matrix_payload(matrix):
    assert set(matrix["configs"]) == {"vo", "vo_lc", "vo_ba", "vo_ba_lc"}
    assert matrix["n_frames"] == N_FRAMES and matrix["device"] == "cpu" and matrix["device_kind"] == "cpu"
    assert matrix["power_limit_w"] is None and matrix["noise"] == 0.0 and matrix["graphed"] is False
    for name, row in matrix["configs"].items():
        assert KEYS <= set(row), name
        assert all(np.isfinite(row[k]) for k in KEYS), name
        assert row["pose_ok_frac"] > 0.8, name
    assert not REFINE_KEYS & set(matrix["configs"]["vo"])  # plain VO has no refiner
    for name in ("vo_lc", "vo_ba", "vo_ba_lc"):
        assert REFINE_KEYS <= set(matrix["configs"][name]), name
    # Keyframes are every keyframe_every-th frame, whatever the draw.
    assert matrix["configs"]["vo_ba"]["n_keyframes"] == matrix["configs"]["vo_ba_lc"]["n_keyframes"] == (N_FRAMES - 1) // 2


def test_refined_stays_near_plain(matrix):
    c = matrix["configs"]
    assert c["vo"]["ate_rmse_m"] < 0.05
    assert abs(c["vo_ba_lc"]["ate_rmse_m"] - c["vo"]["ate_rmse_m"]) < 0.02


def test_main_without_a_card_raises(longrun, monkeypatch):
    """No --cpu means the card: without one, the default-device error before anything is rendered."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(longrun, "load_or_render", None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        longrun.main(["--frames", "4"])
