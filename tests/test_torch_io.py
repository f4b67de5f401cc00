"""vo_tpu_torch.io against vo_tpu.io: the committed KITTI-00 geometry, byte-identical rendered
frames, and the image feed: the port's own build of the PNG decoder against PIL on grey, RGB and
RGBA files (the tests/test_native_loader.py pattern), its prefetch pool, and ``StereoSequence``
over a KITTI directory written to a temp dir."""
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vo_tpu.io import kitti as r_kitti
from vo_tpu.io import synthetic as r_syn
from vo_tpu_torch.io import kitti as p_kitti
from vo_tpu_torch.io import native_loader
from vo_tpu_torch.io import synthetic as p_syn

DATA = Path(__file__).parent / "data"


def test_committed_kitti_00_geometry():
    calib = p_kitti.load_stereo_calib(str(DATA / "kitti" / "00"))
    assert calib.fu == pytest.approx(718.856)
    assert calib.baseline == pytest.approx(0.5372, abs=1e-4)
    poses = p_kitti.read_poses(str(DATA / "kitti" / "poses" / "00.txt"))
    assert poses.shape == (4500, 4, 4)
    np.testing.assert_array_equal(poses, r_kitti.read_poses(str(DATA / "kitti" / "poses" / "00.txt")))
    np.testing.assert_allclose(poses[:, :3, :3] @ poses[:, :3, :3].transpose(0, 2, 1), np.broadcast_to(np.eye(3), (4500, 3, 3)), atol=1e-5)


@pytest.mark.parametrize("kw", [dict(noise_px=0.3, outlier_frac=0.3), dict(max_points=150), dict()], ids=["noisy", "capped", "exact"])
def test_make_tracks_byte_identical(kw):
    """One seed, both packages: every field of ``Tracks`` equal byte for byte."""
    r_calib = r_kitti.load_stereo_calib(str(DATA / "kitti" / "00"))
    p_calib = p_kitti.load_stereo_calib(str(DATA / "kitti" / "00"))
    gt = p_kitti.read_poses(str(DATA / "kitti" / "poses" / "00.txt"))
    lm = p_syn.scatter_landmarks(np.random.default_rng(5), gt[:10], 2000)
    got = p_syn.make_tracks(np.random.default_rng(9), p_calib, gt[2], gt[3], lm, **kw)
    want = r_syn.make_tracks(np.random.default_rng(9), r_calib, gt[2], gt[3], lm, **kw)
    assert got._fields == want._fields and got.px_cur_l.shape[0] > 100
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_sequence_iterates_its_frames():
    seq = p_syn.kitti_synthetic_sequence(n_frames=2, n_landmarks=300, seed=4, image_size=(94, 310))
    frames = list(seq)
    assert len(frames) == 2
    for i, (l, r) in enumerate(frames):
        np.testing.assert_array_equal(l, seq.frame(i)[0])
        np.testing.assert_array_equal(r, seq.frame(i)[1])


@pytest.mark.parametrize("image_size", [None, (188, 620)])
def test_rendered_frames_byte_identical(image_size):
    kw = dict(n_frames=3, n_landmarks=800, seed=4, image_size=image_size)
    p = p_syn.kitti_synthetic_sequence(**kw)  # default root: the committed tests/data/kitti
    r = r_syn.kitti_synthetic_sequence(str(DATA), **kw)
    assert p.calib.image_size == r.calib.image_size
    np.testing.assert_array_equal(p.calib.P1.numpy(), np.asarray(r.calib.P1))
    np.testing.assert_array_equal(p.landmarks, r.landmarks)
    for i in (0, 2):
        for a, b in zip(p.frame(i), r.frame(i)):
            assert a.dtype == b.dtype == np.float32
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("frame", [0, 3])
def test_perspective_splats_equal_the_reference(frame):
    """``SyntheticSequence(perspective_splats=True)`` at 94x311, 200 landmarks, seed 0: the reference's
    frames within 1e-5. ``perspective_splats=False`` and the default render the reference's
    fixed-size frames byte for byte. The option sits where the reference has it, before ``noise``."""
    gt = p_kitti.read_poses(str(DATA / "kitti" / "poses" / "00.txt"))[:4]
    r_calib = r_kitti.load_stereo_calib(str(DATA / "kitti" / "00"))
    p_calib = p_kitti.load_stereo_calib(str(DATA / "kitti" / "00"))
    kw = dict(n_landmarks=200, seed=0, image_size=(94, 311))
    positional = p_syn.SyntheticSequence(p_calib, gt, None, 200, 9, 0, (94, 311), True, 0.0)
    assert positional.perspective_splats and positional.noise == 0.0 and positional.z_ref == 20.0
    persp = [im for im in positional.frame(frame)]
    r_persp = r_syn.SyntheticSequence(r_calib, gt, perspective_splats=True, **kw).frame(frame)
    flat = p_syn.SyntheticSequence(p_calib, gt, perspective_splats=False, **kw).frame(frame)
    default = p_syn.SyntheticSequence(p_calib, gt, **kw).frame(frame)
    r_flat = r_syn.SyntheticSequence(r_calib, gt, **kw).frame(frame)
    for a, b, c, d, e in zip(persp, r_persp, flat, default, r_flat):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        assert c.tobytes() == d.tobytes() == e.tobytes()
        assert not np.array_equal(a, c)  # the splats did change size


@pytest.fixture(scope="module")
def built():
    """The port's decoder, built from vo_tpu_torch/csrc/loader.cpp by the host compiler."""
    assert native_loader.available(), native_loader.unavailable_reason()
    lib = native_loader.library_path()
    assert lib.exists() and lib.parent.name == "vo_tpu_torch" and lib.parent.parent.name == "build"
    return lib


def _write_png(path, arr, mode="L"):
    Image.fromarray(arr, mode=mode).save(path)


def _luma(arr):
    return ((0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]) / 255.0).astype(np.float32)


@pytest.mark.parametrize(
    "mode,shape,atol", [("L", (37, 53), 1e-6), ("L", (376, 1241), 1e-6), ("RGB", (20, 30, 3), 2e-3), ("RGBA", (14, 22, 4), 2e-3)]
)
def test_native_decoder_matches_pil(built, tmp_path, mode, shape, atol):
    rng = np.random.default_rng(0)
    if shape == (376, 1241):  # a gradient image exercises the Sub/Up/Average/Paeth filter paths
        y, x = np.mgrid[0 : shape[0], 0 : shape[1]]
        arr = ((x + y) % 256).astype(np.uint8)
    else:
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "im.png")
    _write_png(p, arr, mode)
    got = native_loader.read_png_gray(p)
    assert native_loader.png_info(p) == shape[:2] and got.dtype == np.float32
    with Image.open(p) as im:
        pil = np.asarray(im.convert("L"), np.float32) / 255.0
    np.testing.assert_allclose(got, arr.astype(np.float32) / 255.0 if mode == "L" else _luma(arr), atol=atol)
    np.testing.assert_allclose(got, pil, atol=max(atol, 2.5e-3))  # PIL rounds its luma to 8 bits
    np.testing.assert_array_equal(p_kitti.read_image(p), got)  # the native decoder comes first
    assert p_kitti.decoder() == "native"


def test_native_decoder_missing_file(built, tmp_path):
    with pytest.raises(IOError):
        native_loader.read_png_gray(str(tmp_path / "missing.png"))


def test_read_image_falls_back_to_pil(tmp_path, monkeypatch):
    """Where the decoder cannot be built, PIL decodes and the feed says so."""
    monkeypatch.setattr(native_loader, "available", lambda: False)
    arr = np.arange(64, dtype=np.uint8).reshape(8, 8)
    p = str(tmp_path / "im.png")
    _write_png(p, arr)
    assert p_kitti.decoder() == "PIL"
    np.testing.assert_allclose(p_kitti.read_image(p), arr.astype(np.float32) / 255.0, atol=1e-6)


def test_prefetch_feed(built, tmp_path):
    rng = np.random.default_rng(2)
    paths, arrs = [], []
    for i in range(12):
        a = rng.integers(0, 256, (16, 24), dtype=np.uint8)
        paths.append(str(tmp_path / f"f{i}.png"))
        _write_png(paths[-1], a)
        arrs.append(a)
    feed = native_loader.PrefetchFeed(paths, ahead=4, threads=3)
    try:
        assert len(feed) == 12
        for idx in [0, 3, 1, 2, 11, 5, 5]:  # out of order and repeated
            np.testing.assert_allclose(feed[idx], arrs[idx].astype(np.float32) / 255.0, atol=1e-6)
        with pytest.raises(IndexError):
            feed[12]
    finally:
        feed.close()
    with pytest.raises(ValueError):
        native_loader.PrefetchFeed([])


@pytest.mark.parametrize("prefetch", [True, False])
def test_stereo_sequence_over_a_kitti_directory(built, tmp_path, prefetch):
    rng = np.random.default_rng(5)
    seq_dir = tmp_path / "00"
    (seq_dir / "image_0").mkdir(parents=True)
    (seq_dir / "image_1").mkdir(parents=True)
    shutil.copy(DATA / "kitti" / "00" / "calib.txt", seq_dir / "calib.txt")
    np.savetxt(seq_dir / "times.txt", np.arange(4) * 0.1)
    arrs = []
    for i in range(4):
        pair = tuple(rng.integers(0, 256, (12, 20), dtype=np.uint8) for _ in range(2))
        for cam, a in enumerate(pair):
            _write_png(str(seq_dir / f"image_{cam}" / f"{i:06d}.png"), a)
        arrs.append(pair)
    seq = p_kitti.StereoSequence(str(seq_dir), poses_path=str(DATA / "kitti" / "poses" / "00.txt"), prefetch=prefetch)
    try:
        assert len(seq) == 4 and seq.decoder == "native" and (seq._feed is not None) == prefetch
        assert seq.calib.fu == pytest.approx(718.856) and seq.calib.P1.device.type == "cpu"
        np.testing.assert_allclose(seq.times, np.arange(4) * 0.1)
        assert seq.gt_poses.shape == (4500, 4, 4)
        for i in [0, 2, 1, 3]:
            for got, want in zip(seq.frame(i), arrs[i]):
                np.testing.assert_allclose(got, want.astype(np.float32) / 255.0, atol=1e-6)
        assert len(list(seq)) == 4
    finally:
        seq.close()
    assert p_kitti.list_frames(str(tmp_path / "nowhere")) == []
    r = r_kitti.list_frames(str(seq_dir), 1)
    assert p_kitti.list_frames(str(seq_dir), 1) == r and len(r) == 4
