"""tools/render_cache_torch.py on the CPU: parts rendered by strided workers and merged are the
file ``vo_tpu_torch.bench.preload_cached`` writes, byte for byte, at the path it reads; so is the
one-command ``--workers`` render; the quantization (``bench._q``) is the reference's ``render_cache.quant``;
and a cache of the same name rendered from other poses is refused, never overwritten. (160, 320)
images, 12 frames; every file under the test's own directory."""
import importlib.util
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
N, LANDMARKS, NOISE, SEED = 12, 1500, 0.02, 8401
ARGS = ["--frames", str(N), "--landmarks", str(LANDMARKS), "--noise", str(NOISE), "--seed", str(SEED), "--image-size", "160,320"]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load(REPO / "tools" / "render_cache_torch.py", "_render_cache_torch")


@pytest.fixture(scope="module")
def ref_tool():
    return _load(REPO / "tools" / "render_cache.py", "_reference_render_cache")


def _cache(d: Path) -> str:
    return bench.cache_path(N, LANDMARKS, SEED, (160, 320), NOISE, str(d))


@pytest.fixture(scope="module")
def preloaded(tmp_path_factory):
    """preload_cached's file for the same render, written in its own directory."""
    d = tmp_path_factory.mktemp("preload")
    poses = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))[:N]
    calib = p_kitti.load_stereo_calib(str(DATA / "00"))
    bench.preload_cached(calib, poses, N, LANDMARKS, SEED, image_size=(160, 320), noise=NOISE, cache_dir=str(d))
    return np.load(_cache(d))


@pytest.fixture(scope="module")
def merged(tool, tmp_path_factory):
    """Two strided parts (offsets 0 and 1, stride 2) and their merge."""
    d = tmp_path_factory.mktemp("parts")
    parts = [str(d / f"part{k}.npz") for k in (0, 1)]
    for k, p in enumerate(parts):
        assert tool.main([*ARGS, "--offset", str(k), "--stride", "2", "--part", p, "--cache-dir", str(d)]) == 0
    assert tool.main([*ARGS, "--merge", *parts, "--cache-dir", str(d)]) == 0
    return d, parts


def test_parts_are_strided_slices(merged):
    d, parts = merged
    for k, p in enumerate(parts):
        z = np.load(p)
        np.testing.assert_array_equal(z["idx"], np.arange(k, N, 2))
        assert z["l"].shape == z["r"].shape == (N // 2, 160, 320) and z["l"].dtype == np.uint8


def test_merge_equals_preload_cached(merged, preloaded):
    """The merge lands at preload_cached's path with its bytes (l, r, poses)."""
    z = np.load(_cache(merged[0]))
    assert set(z.files) == set(preloaded.files) == {"l", "r", "poses"}
    for k in z.files:
        assert z[k].dtype == preloaded[k].dtype and z[k].shape == preloaded[k].shape, k
        np.testing.assert_array_equal(z[k], preloaded[k], err_msg=k)


def test_preload_cached_reads_the_merge_without_rendering(merged, monkeypatch):
    from vo_tpu_torch.io import synthetic

    def no_render(self, i):
        raise AssertionError("preload_cached rendered a frame")

    monkeypatch.setattr(synthetic.SyntheticSequence, "frame", no_render)
    poses = p_kitti.read_poses(str(DATA / "poses" / "00.txt"))[:N]
    pre = bench.preload_cached(p_kitti.load_stereo_calib(str(DATA / "00")), poses, N, LANDMARKS, SEED,
                               image_size=(160, 320), noise=NOISE, cache_dir=str(merged[0]))
    z = np.load(_cache(merged[0]))
    np.testing.assert_array_equal(np.stack([f[0] for f in pre.frames]), z["l"])


def test_workers_render_equals_preload_cached(tool, preloaded, tmp_path, capsys):
    assert tool.main([*ARGS, "--workers", "2", "--cache-dir", str(tmp_path)]) == 0
    z = np.load(_cache(tmp_path))
    for k in preloaded.files:
        np.testing.assert_array_equal(z[k], preloaded[k], err_msg=k)
    capsys.readouterr()
    assert tool.main([*ARGS, "--workers", "2", "--cache-dir", str(tmp_path)]) == 0
    assert "already there" in capsys.readouterr().out


def test_quant_equals_the_reference(ref_tool):
    """The parts quantize with bench._q: the reference's render_cache.quant, value for value."""
    rng = np.random.default_rng(5)
    img = rng.uniform(-0.2, 1.2, (64, 80)).astype(np.float32)
    img[0, :4] = [0.0, 1.0, 0.5 / 255.0, 254.5 / 255.0]
    got = bench._q(img)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref_tool.quant(img))


@pytest.mark.parametrize("how", ["merge", "workers"])
def test_cache_from_other_poses_is_refused(tool, merged, tmp_path, how):
    """The name does not encode --traj: an out-and-back render of the same counts must not replace it."""
    d, parts = merged
    before = Path(_cache(d)).read_bytes()
    argv = [*ARGS, "--traj", "outback", "--cache-dir", str(d)]
    argv += ["--merge", *parts] if how == "merge" else ["--workers", "2"]
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        tool.main(argv)
    assert Path(_cache(d)).read_bytes() == before


def test_merge_of_missing_frames_writes_nothing(tool, merged, tmp_path):
    d, parts = merged
    with pytest.raises(SystemExit, match="miss frames"):
        tool.main([*ARGS, "--merge", parts[0], "--cache-dir", str(tmp_path)])
    assert not Path(_cache(tmp_path)).exists()


def test_exactly_one_mode(tool, capsys):
    with pytest.raises(SystemExit) as e:
        tool.main(ARGS)
    assert e.value.code == 2 and "exactly one" in capsys.readouterr().err
