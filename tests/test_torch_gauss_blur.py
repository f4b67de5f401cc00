"""K4 ``gauss_blur`` (csrc/gauss_blur.cu): the detector's separable Gaussian blurs against the band products.

On the CPU the pyramid and the bin-map rows run the band products (the plain
version). Here a numpy tap loop that reads the tables the kernel is given
(``pyramid.tap_arrays``: the band matrices' own weights) and writes where the
kernel writes (``dense_desc.row_jobs``) stands in for the kernel, and is held
to the band products; the tables are held to the band matrices entry for entry.
The kernel-vs-band-product cases need a CUDA card (marker ``gpu``) and skip
without one. This module imports neither jax nor conftest's fixtures, so on the
card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gauss_blur.py -s
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch.config import PipelineConfig, SIFTConfig
from vo_tpu_torch.frontend import dense_desc, kernels, pyramid, sift
from vo_tpu_torch.io import kitti, synthetic
from vo_tpu_torch.odometry import landmarks, pipeline, runner
from vo_tpu_torch.utils import cuda_lib, graphs

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "kitti"
ORACLE_TOL = 1e-6  # float32 sums of at most 33 products of values in [0, 1], in two orders
CARD_TOL = 2e-7  # K4 against the card's band products: at most a rounding apart where not bit-equal
SIG, _ = pyramid.sigma_schedule(SIFTConfig())
LEVELS = pyramid._level_kernels(SIG)  # taps 1, 9, 13, 19, 25, 31: the identity and the widest
BASE = pyramid.gaussian_kernel_1d(np.sqrt(SIFTConfig().sigma0**2 - 0.25))
MAP_SIGMAS = [float(s) for s in SIG[1:4]]


def _fma(w, x, acc):
    """float32 fmaf, through float64: the product is exact there, the sum rounds twice at most."""
    return (np.float64(w) * x.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


def _tap_loop(x: np.ndarray, j_taps, axis: int) -> np.ndarray:
    """Blur ``x`` along ``axis`` by set ``j_taps`` of tap_arrays, as K4 sums: each output a chain from +0
    over its band row's nonzero weights in ascending source index."""
    radii, taps, lo, hi, tot = j_taps
    r = int(radii)
    x = np.moveaxis(x, axis, 0)
    n = x.shape[0]
    out = np.zeros_like(x)
    for i in range(n):
        acc = np.zeros(x.shape[1:], np.float32)
        for t in range(2 * r + 1):
            j = i + t - r
            if j < 0 or j > n - 1:
                continue
            w = tot if n == 1 else lo[i] if j == 0 else hi[n - 1 - i] if j == n - 1 else taps[t]
            acc = _fma(w, x[j], acc)
        out[i] = acc
    return np.moveaxis(out, 0, axis)


def _oracle_stack(src: np.ndarray, kernels_1d, decimate: bool) -> np.ndarray:
    """[B, H, W] -> [B, L, H', W'] levels: rows over y first, then over x, on the even samples where
    ``decimate``."""
    tables = pyramid.tap_arrays(kernels_1d)
    x = src[:, ::2, ::2] if decimate else src
    return np.stack(
        [_tap_loop(_tap_loop(x, [a[l] for a in tables], 1), [a[l] for a in tables], 2) for l in range(len(kernels_1d))],
        axis=1,
    )


def _oracle_rows(raws, sigma_rels) -> np.ndarray:
    """Per-octave [B, L, 8, H2, W2] maps -> [B, N, 8] rows at dense_desc.row_jobs' offsets."""
    B, L = raws[0].shape[:2]
    shapes = [r.shape[3:] for r in raws]
    tables = pyramid.tap_arrays(tuple(dense_desc._map_kernel(s) for s in sigma_rels))
    out = np.full((B, sum(L * h * w for h, w in shapes), 8), np.nan, np.float32)
    for o, l, row in dense_desc.row_jobs(shapes, L):
        H2, W2 = shapes[o]
        t = [a[l] for a in tables]
        blurred = _tap_loop(_tap_loop(raws[o][:, l], t, 2), t, 3)  # [B, 8, H2, W2]
        out[:, row : row + H2 * W2] = blurred.transpose(0, 2, 3, 1).reshape(B, H2 * W2, 8)
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 31, 47, 188])
@pytest.mark.parametrize("which", range(len(LEVELS) + 4))
def test_tap_table_is_the_band_matrix(n, which):
    """The weights K4 is given, placed by its rule, are _band_matrix's float32 entries bit for bit, at
    sizes below, at and above the tap count (every level kernel, the base blur, the bin-map blurs)."""
    k = ([*LEVELS, BASE] + [dense_desc._map_kernel(s) for s in MAP_SIGMAS])[which]
    r, taps, lo, hi, tot = pyramid.tap_table(k)
    want = pyramid._band_matrix(n, k)
    got = np.zeros_like(want)
    for i in range(n):
        for j in range(max(0, i - r), min(n - 1, i + r) + 1):
            got[i, j] = tot if n == 1 else lo[i] if j == 0 else hi[n - 1 - i] if j == n - 1 else taps[j - i + r]
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize(
    "H,W,decimate",
    [(37, 53, False), (75, 101, True), (8, 13, False), (16, 9, True), (94, 311, True)],
    ids=["odd", "decimated", "31-taps-on-8-rows", "decimated-to-8x5", "octave-2"],
)
def test_oracle_matches_the_band_products(H, W, decimate):
    """The tap loop over K4's tables against _blur_stack_from_base and its DoG: odd sizes, the ::2
    decimation, the identity level 0, and 31 taps on images of 8 rows or 5 columns."""
    rng = np.random.default_rng(H * W)
    base = rng.random((2, H, W), np.float32)
    want = pyramid._blur_stack_from_base(torch.from_numpy(base), SIG, decimate=decimate).numpy()
    got = _oracle_stack(base, LEVELS, decimate)
    assert got.shape == want.shape == (2, 6, (H + 1) // 2 if decimate else H, (W + 1) // 2 if decimate else W)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORACLE_TOL)
    assert np.array_equal(got[:, 0], base[:, ::2, ::2] if decimate else base)  # the identity level
    dog = torch.from_numpy(want)[:, 1:] - torch.from_numpy(want)[:, :-1]
    np.testing.assert_allclose(got[:, 1:] - got[:, :-1], dog.numpy(), rtol=0, atol=2 * ORACLE_TOL)
    np.testing.assert_allclose(
        _oracle_stack(base, (BASE,), False)[:, 0], pyramid.blur_separable(torch.from_numpy(base), BASE).numpy(),
        rtol=0, atol=ORACLE_TOL,
    )


def test_oracle_bin_rows_match_the_band_products():
    """Channel-last rows of 3 levels x 3 octaves of odd sizes, each level at its row offset: the tap loop
    against bin_map_rows' band products on the CPU (which K4 replaces on the card)."""
    rng = np.random.default_rng(3)
    raws = [rng.random((2, 3, 8, h, w), np.float32) for h, w in [(23, 77), (12, 39), (5, 19)]]
    want = dense_desc.bin_map_rows([torch.from_numpy(r) for r in raws], MAP_SIGMAS).numpy()
    got = _oracle_rows(raws, MAP_SIGMAS)
    assert got.shape == want.shape == (2, 3 * (23 * 77 + 12 * 39 + 5 * 19), 8)
    assert np.isfinite(got).all()  # every row written once
    np.testing.assert_allclose(got, want, rtol=0, atol=ORACLE_TOL)
    jobs = dense_desc.row_jobs([(23, 77), (12, 39)], 3)
    assert [row for _, _, row in jobs] == [0, 1771, 3542, 5313, 5781, 6249]


def test_cpu_detection_launches_no_blur_kernel():
    """A detection call on CPU tensors takes the band products: no K4 launch (nor K1, K2)."""
    rng = np.random.default_rng(5)
    before = dict(cuda_lib.LAUNCHES)
    f = sift.detect_and_describe(torch.from_numpy(rng.random((2, 64, 96), np.float32)), SIFTConfig(max_keypoints=64, n_octaves=2))
    assert cuda_lib.LAUNCHES == before
    assert torch.isfinite(f.desc).all()


def test_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        pyramid.gauss_stack(torch.zeros((1, 8, 8)), LEVELS, decimate=False, dog=True)  # the CPU
    with pytest.raises(ValueError):
        pyramid.gauss_stack(torch.zeros((1, 8, 8), device="meta"), LEVELS, decimate=False, dog=True)
    with pytest.raises(ValueError):
        pyramid.tap_arrays((pyramid.gaussian_kernel_1d(6.0),))  # radius 18 > 16
    with pytest.raises(ValueError):
        dense_desc._bin_map_rows_k4([torch.zeros((1, 3, 8, 4, 4), device="meta")], MAP_SIGMAS)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sequence():
    """Two rendered KITTI-00 stereo frames at the main path's 376x1241."""
    gt = kitti.read_poses(str(DATA / "poses" / "00.txt"))[:2]
    return synthetic.SyntheticSequence(kitti.load_stereo_calib(str(DATA / "00")), gt, n_landmarks=3000, seed=0)


def _frames(device, n_images):
    """The images of _sequence() as the step stages them (8 bits), in [0, 1]: left 0, right 0, left 1, ..."""
    seq = _sequence()
    ims = [runner.to_device(im, device) for i in range(2) for im in seq.frame(i)][:n_images]
    return torch.stack(ims).float() / 255.0


def _both(imgs, use_pallas):
    """The pyramid and the bin-map rows of every octave, K4's (use_pallas) or the band products'."""
    cfg = SIFTConfig(use_pallas=use_pallas)
    pyr = pyramid.build_pyramid(imgs, cfg)
    raws = kernels.bin_maps_octaves([G[:, 1:4] for G in pyr.gauss])
    return pyr, raws, dense_desc.bin_map_rows(raws, SIG[1:4], use_pallas=use_pallas)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 4])
def test_kernel_matches_the_card_band_products(cuda, B):
    """At the main path's shapes (376x1241, 4 octaves; the bin maps of 3 levels x 4 octaves) K4 against
    the band products on the card, launch by launch from the same inputs: within CARD_TOL, or within the
    band products' own spread where that is wider (cuBLAS picks its GEMM, and with it the order of its
    sums, by shape: the same images in a batch twice as large). Printed: the largest difference, the
    values that differ and the spread; along the whole pyramid too, where the base's difference carries."""
    imgs = _frames(cuda, B)

    def doubled(fn, x):
        return fn(torch.cat([x, x]))[:B]

    with torch.no_grad():
        pyr, raws, rows = _both(imgs, True)
        want = pyramid.build_pyramid(imgs, SIFTConfig(use_pallas=False))
        cur = pyramid.blur_separable(imgs, BASE)
        base = pyramid.gauss_stack(imgs, (BASE,), decimate=False, dog=False)[0][:, 0]
        parts = {"base": (base, cur, doubled(lambda x: pyramid.blur_separable(x, BASE), imgs))}
        for o in range(4):
            src = cur if o == 0 else pyr.gauss[o - 1][:, 3]
            band = pyramid._blur_stack_from_base(src, SIG, decimate=o > 0)
            band2 = doubled(lambda x: pyramid._blur_stack_from_base(x, SIG, decimate=o > 0), src)
            G, D = pyramid.gauss_stack(src, LEVELS, decimate=o > 0, dog=True)
            parts[f"octave {o}"] = (G, band, band2)
            parts[f"dog {o}"] = (D, band[:, 1:] - band[:, :-1], band2[:, 1:] - band2[:, :-1])
            parts[f"pyramid {o}"] = (pyr.gauss[o], want.gauss[o], None)
        plain_rows = dense_desc.bin_map_rows(raws, SIG[1:4], use_pallas=False)
        rows2 = dense_desc.bin_map_rows([torch.cat([r, r]) for r in raws], SIG[1:4], use_pallas=False)[:B]
        parts["bin rows"] = (rows, plain_rows, rows2)
        torch.cuda.synchronize()
    for name, (got, band, band2) in parts.items():
        d = (got - band).abs()
        spread = None if band2 is None else (band - band2).abs().max().item()
        print(f"B={B} {name}: max |K4 - band products| {d.max().item():.3e}, {int((d > 0).sum())} of {d.numel()} differ; "
              f"the band products' own spread {spread}")
        if spread is not None:
            assert d.max().item() <= max(CARD_TOL, spread), name


@pytest.mark.gpu
def test_kernel_is_batch_invariant(cuda):
    """An image's pyramid and map rows are the same bits in a batch of 1, 2 or 4."""
    imgs = _frames(cuda, 4)
    pyr4, _, rows4 = _both(imgs, True)
    for B in (1, 2):
        for b0 in range(0, 4, B):
            pyr, _, rows = _both(imgs[b0 : b0 + B].contiguous(), True)
            for o in range(4):
                assert torch.equal(pyr.gauss[o], pyr4.gauss[o][b0 : b0 + B])
                assert torch.equal(pyr.dog[o], pyr4.dog[o][b0 : b0 + B])
            assert torch.equal(rows, rows4[b0 : b0 + B])


@pytest.mark.gpu
def test_graphed_equals_eager_and_counts_per_replay(cuda):
    """The pyramid and the map rows captured into a CUDA graph: a replay gives the eager bits, and
    counts K4's launches (the base, one per octave, the map rows)."""
    imgs = _frames(cuda, 2)
    pyr, _, rows = _both(imgs, True)
    static = imgs.clone()
    captured = graphs.capture(lambda: _both(static, True), cuda)
    assert captured.counted["launches"]["gauss_blur"] == 6
    static.copy_(imgs.flip(0))
    n = cuda_lib.LAUNCHES["gauss_blur"]
    gpyr, _, grows = captured.replay()
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gauss_blur"] == n + 6
    flipped = _both(imgs.flip(0).contiguous(), True)
    for o in range(4):
        assert torch.equal(gpyr.gauss[o], flipped[0].gauss[o]) and torch.equal(gpyr.dog[o], flipped[0].dog[o])
    assert torch.equal(grows, flipped[2])
    assert torch.equal(flipped[2].flip(0), rows) and torch.equal(flipped[0].gauss[0].flip(0), pyr.gauss[0])


@pytest.mark.gpu
def test_step_replays_launch_the_blurs(cuda):
    """One replay of the group step (4 images) and one of the single-frame step (2 images) each add one
    detection call's K4 launches: the base blur, four octaves, the map rows."""
    cfg = PipelineConfig()
    seq = _sequence()
    frames = [tuple(runner.to_device(im, cuda) for im in seq.frame(i)) for i in range(2)]
    per_call = 2 + cfg.sift.n_octaves
    group = pipeline.make_fused_multi_step(seq.calib, cfg, with_landmarks=True, group=2)
    single = pipeline.make_jitted_step(seq.calib, cfg)
    state = pipeline.init_state(cfg, 0, cuda)
    lmap = landmarks.init_map(cfg.landmarks, cuda)
    state, lmap, *_ = group(state, lmap, *frames[0], *frames[1])  # captures, then replays
    n = cuda_lib.LAUNCHES["gauss_blur"]
    state, lmap, *_ = group(state, lmap, *frames[0], *frames[1])
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gauss_blur"] == n + per_call
    state1 = pipeline.init_state(cfg, 0, cuda)
    state1, _ = single(state1, *frames[0])
    n = cuda_lib.LAUNCHES["gauss_blur"]
    state1, _ = single(state1, *frames[1])
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gauss_blur"] == n + per_call
