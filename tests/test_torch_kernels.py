"""The two CUDA kernels' plain versions against the reference's Pallas kernels and XLA paths.

On the CPU the wrappers run their plain versions; the plain versions are held
against ``extrema_scores_pallas`` / ``_bin_maps_call`` in interpret mode and
against the reference's XLA paths, and the multi-octave wrappers against the
per-octave plain versions. The kernel-vs-plain cases need a CUDA card (marker
``gpu``) and skip without one. This module imports the jax reference only
inside the CPU tests, and the gpu cases use neither jax nor conftest's
fixtures, so they also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from vo_tpu_torch.config import SIFTConfig
from vo_tpu_torch.frontend import kernels, sift

# The suite runs in several worker processes at once: one thread each, or they fight for the cores.
torch.set_num_threads(1)

THR = 0.0133
BORDER = 5


def _dog(rng, L, H, W):
    return (gaussian_filter(rng.standard_normal((L, H, W)), 1.2) * 0.1).astype(np.float32)


def _quantised_dog(rng, B, L, H, W):
    """A DoG stack with 7 distinct values, so that a pixel often ties with a neighbour (>= / <=)."""
    return torch.from_numpy((rng.integers(-3, 4, (B, L, H, W)) * 0.01).astype(np.float32))


def _bin_maps_float64(G: np.ndarray) -> np.ndarray:
    """The formula of soft_bin_pool_plain evaluated in float64 numpy: [B, H, W] -> [B, 8, H//2, W//2]."""
    G = G.astype(np.float64)
    B, H, W = G.shape
    gx, gy = np.zeros_like(G), np.zeros_like(G)
    gx[:, :, 1:-1] = 0.5 * (G[:, :, 2:] - G[:, :, :-2])
    gy[:, 1:-1] = 0.5 * (G[:, 2:] - G[:, :-2])
    mag = np.hypot(gx, gy)
    b = (np.arctan2(gy, gx) / (2.0 * np.pi) + 0.5) * 8
    b0 = np.floor(b)
    fb = b - b0
    b0i = b0.astype(np.int64) % 8
    maps = np.zeros((B, H, W, 8))
    np.put_along_axis(maps, b0i[..., None], ((1.0 - fb) * mag)[..., None], -1)
    nxt = np.zeros((B, H, W, 8))
    np.put_along_axis(nxt, ((b0i + 1) % 8)[..., None], (fb * mag)[..., None], -1)
    H2, W2 = H // 2, W // 2
    return (maps + nxt)[:, : H2 * 2, : W2 * 2].reshape(B, H2, 2, W2, 2, 8).sum((2, 4)).transpose(0, 3, 1, 2)


def _bin_maps_interpret(G: np.ndarray) -> np.ndarray:
    """bin_maps_pallas with interpret=True (pattern of tests/test_pallas_kernels.py)."""
    import jax.numpy as jnp

    from vo_tpu.frontend.pallas_kernels import _bin_maps_call, _round_up

    B, H, W = G.shape
    th = min(96, _round_up(H, 16))
    Hp = _round_up(H, th)
    Wp = _round_up(W, 256)
    Gp = jnp.pad(jnp.asarray(G), ((0, 0), (1, Hp + 1 - H), (0, Wp - W)))
    return np.asarray(_bin_maps_call(Gp, H, W, th, interpret=True)[:, :, : H // 2, : W // 2])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_extrema_plain_matches_pallas_interpret(rng):
    import jax.numpy as jnp

    from vo_tpu.frontend.pallas_kernels import extrema_scores_pallas

    H, W = 70, 150
    dogs = np.stack([_dog(rng, 5, H, W) for _ in range(2)])
    got = kernels.extrema_scores_plain(torch.from_numpy(dogs), THR, BORDER).numpy()
    assert got.shape == (2, 3, H, W)
    for b in range(2):
        ref, _, _ = extrema_scores_pallas(jnp.asarray(dogs[b]), THR, BORDER, interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(ref)[:, :H, :W])


def test_extrema_plain_matches_find_candidates(rng):
    """The top-k of the plain scores is the reference's _find_candidates set, values exact."""
    import jax.numpy as jnp

    from vo_tpu.frontend import sift as r_sift

    H, W, k = 64, 96, 200
    dog = _dog(rng, 5, H, W)
    cfg = SIFTConfig(contrast_threshold=THR)  # the reference reads the same field by name
    lvl, ys, xs, top, valid = (np.asarray(a) for a in r_sift._find_candidates(jnp.asarray(dog), cfg, k))
    p = sift._find_candidates(torch.from_numpy(dog)[None], cfg, k)
    plvl, pys, pxs, ptop, pvalid = (a[0].numpy() for a in p)
    assert valid.sum() == pvalid.sum() > 0
    ref_set = set(zip(lvl[valid], ys[valid], xs[valid], top[valid]))
    assert ref_set == set(zip(plvl[pvalid], pys[pvalid], pxs[pvalid], ptop[pvalid]))


@pytest.mark.parametrize("H,W", [(64, 300), (96, 311), (47, 156)])
def test_bin_maps_plain_matches_reference(rng, H, W):
    """The port's plain version, the reference's XLA path and its Pallas kernel in interpret mode,
    each held to a float64 evaluation of the same formula. All three are float32 and differ from it
    by the rounding of the bin coordinate in [0, 8] (half an ulp there is 2.4e-7) times a gradient
    magnitude below 0.71, summed over 4 pixels: at most 5e-7 on this input, so 2e-6 leaves a factor
    of 4, and any two sides still agree within 4e-6, inside the 1e-5 they were held to directly.
    Judged each against the truth, a side that strays names itself."""
    import jax.numpy as jnp

    from vo_tpu.frontend import dense_desc as r_dense

    G = rng.random((2, H, W), np.float32)
    want = _bin_maps_float64(G)
    got = kernels.soft_bin_pool_plain(torch.from_numpy(G)).numpy()
    assert got.shape == want.shape == (2, 8, H // 2, W // 2)
    xla = np.stack([np.asarray(r_dense._soft_bin_pool(jnp.asarray(g))) for g in G])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, err_msg="the port's plain version")
    np.testing.assert_allclose(xla, want, rtol=0, atol=2e-6, err_msg="the reference's XLA path")
    np.testing.assert_allclose(_bin_maps_interpret(G), want, rtol=0, atol=2e-6, err_msg="the reference's Pallas kernel")


def test_wrappers_take_plain_version_on_cpu(rng):
    dog = torch.from_numpy(np.stack([_dog(rng, 5, 40, 60)]))
    G = torch.from_numpy(rng.random((3, 40, 60), np.float32))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.extrema_scores(dog, THR), kernels.extrema_scores_plain(dog, THR))
    assert torch.equal(kernels.bin_maps(G), kernels.soft_bin_pool_plain(G))
    assert kernels.LAUNCHES == before  # the plain version is not a launch


def test_wrappers_raise_off_cpu_and_cuda():
    with pytest.raises(ValueError):
        kernels.extrema_scores(torch.empty((1, 5, 32, 32), device="meta"), THR)
    with pytest.raises(ValueError):
        kernels.bin_maps(torch.empty((1, 32, 32), device="meta"))


def test_main_path_hands_kernels_contiguous_float32(monkeypatch, rng):
    """What the CUDA wrappers check (rank, dtype, one batch and level count, contiguous DoG stacks,
    unit stride along x of the Gaussian levels) holds for the one call per kernel that
    detect_and_describe makes, and the Gaussian levels arrive as views, not copies."""
    seen = []

    def spy(fn, contiguous):
        def wrapped(xs, *a, **kw):
            kernels._check_octaves(xs, fn.__name__, contiguous)  # raises on what the kernel refuses
            seen.append((fn.__name__, len(xs), all(x.is_contiguous() for x in xs)))
            return fn(xs, *a, **kw)

        return wrapped

    monkeypatch.setattr(kernels, "extrema_scores_octaves", spy(kernels.extrema_scores_octaves, True))
    monkeypatch.setattr(kernels, "bin_maps_octaves", spy(kernels.bin_maps_octaves, False))
    img = torch.from_numpy(gaussian_filter(rng.random((3, 96, 160)), 1.0).astype(np.float32))
    sift.detect_and_describe(img, SIFTConfig(max_keypoints=64, n_octaves=3))
    assert sorted(seen) == [("bin_maps_octaves", 3, False), ("extrema_scores_octaves", 3, True)]


# The main path's four aspect ratios at small size, and odd sizes.
OCTAVE_SIZES = [[(47, 156), (24, 78), (12, 39), (6, 20)], [(47, 155), (23, 77)], [(33, 41)]]


@pytest.mark.parametrize("sizes", OCTAVE_SIZES, ids=lambda s: "x".join(f"{h}-{w}" for h, w in s))
def test_octave_wrappers_equal_per_octave_plain(rng, sizes):
    dogs = [torch.from_numpy(np.stack([_dog(rng, 5, H, W) for _ in range(2)])) for H, W in sizes]
    gauss = [torch.from_numpy(rng.random((2, 6, H, W), np.float32)) for H, W in sizes]
    levels = [g[:, 1:4] for g in gauss]
    before = dict(kernels.LAUNCHES)
    scores = kernels.extrema_scores_octaves(dogs, THR, BORDER)
    maps = kernels.bin_maps_octaves(levels)
    assert kernels.LAUNCHES == before
    assert len(scores) == len(maps) == len(sizes)
    for (H, W), dog, lev, sc, mp in zip(sizes, dogs, levels, scores, maps):
        assert torch.equal(sc, kernels.extrema_scores_plain(dog, THR, BORDER))
        assert mp.shape == (2, 3, 8, H // 2, W // 2)
        for l in range(3):
            assert torch.equal(mp[:, l], kernels.soft_bin_pool_plain(lev[:, l]))


def test_bin_maps_on_level_slice_equals_contiguous_copy(rng):
    G = torch.from_numpy(rng.random((2, 6, 47, 156), np.float32))
    view = G[:, 1:4]
    assert not view.is_contiguous()
    got = kernels.bin_maps(view)
    assert got.shape == (2, 3, 8, 23, 78)
    assert torch.equal(got, kernels.bin_maps(view.contiguous()))
    assert torch.equal(got[:, 0], kernels.bin_maps(G[:, 1]))  # the rank-3 form: one level per image


@pytest.mark.parametrize(
    "bad",
    [
        lambda: [torch.zeros((1, 5, 8, 8), dtype=torch.float64)],
        lambda: [torch.zeros((5, 8, 8))],
        lambda: [torch.zeros((1, 5, 8, 8)), torch.zeros((2, 5, 4, 4))],
        lambda: [torch.zeros((1, 5, 8, 16))[..., ::2]],
        lambda: [torch.zeros((1, 5, 8, 8))] * (kernels.MAX_OCTAVES + 1),
        lambda: [],
    ],
    ids=["dtype", "rank", "batch", "x-stride", "too-many", "none"],
)
def test_octave_check_refuses(bad):
    with pytest.raises(ValueError):
        kernels._check_octaves(bad(), "kernel", contiguous=False)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize(
    "H,W", [(376, 1241), (188, 621), (94, 311), (47, 156), (9, 127), (15, 129), (4, 128), (3, 40), (13, 257), (11, 11)]
)
def test_extrema_kernel_matches_plain(cuda, B, H, W):
    """Exact, at the main path's widths, one column more and fewer than a 128-wide tile, heights
    below, at and just above a multiple of the 4-row tile, and images that are all border."""
    rng = np.random.default_rng(7)
    dog = torch.from_numpy(np.stack([_dog(rng, 5, H, W) for _ in range(B)])).to(cuda)
    n = kernels.LAUNCHES["extrema_scores"]
    got = kernels.extrema_scores(dog, THR)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["extrema_scores"] == n + 1
    assert torch.equal(got, kernels.extrema_scores_plain(dog, THR))


@pytest.mark.gpu
@pytest.mark.parametrize("border", [0, 1, 5])
def test_extrema_kernel_ties_and_borders(cuda, border):
    """A DoG of 7 distinct values (ties with neighbours everywhere) at 3 to 6 levels; border 0
    clips the cube at the image edge as the plain version's padded pooling does."""
    rng = np.random.default_rng(9)
    for L in (3, 5, 6):
        dog = _quantised_dog(rng, 2, L, 45, 150).to(cuda)
        got = kernels.extrema_scores(dog, 0.0, border)
        want = kernels.extrema_scores_plain(dog, 0.0, border)
        assert (want > 0).sum() > 100
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_extrema_kernel_octaves_in_one_launch(cuda):
    rng = np.random.default_rng(10)
    sizes = [(376, 1241), (188, 621), (94, 311), (47, 156)]
    dogs = [torch.from_numpy(np.stack([_dog(rng, 5, H, W) for _ in range(4)])).to(cuda) for H, W in sizes]
    n = kernels.LAUNCHES["extrema_scores"]
    got = kernels.extrema_scores_octaves(dogs, THR)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["extrema_scores"] == n + 1
    for g, d in zip(got, dogs):
        assert torch.equal(g, kernels.extrema_scores_plain(d, THR))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize(
    "H,W", [(376, 1241), (188, 621), (94, 311), (47, 156), (96, 311), (9, 126), (31, 127), (33, 130), (2, 2)]
)
def test_bin_maps_kernel_matches_plain(cuda, B, H, W):
    """Within 1e-5 (the kernel's polynomial angle and approximate division and square root against
    atan2 and true ones: about 1e-6), at the main path's widths, around a 64-wide pooled tile
    (126 to 130 pixels), heights below and just above a 16-row pooled tile, and the smallest image."""
    rng = np.random.default_rng(8)
    G = torch.from_numpy(rng.random((B, H, W), np.float32)).to(cuda)
    n = kernels.LAUNCHES["bin_maps"]
    got = kernels.bin_maps(G)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bin_maps"] == n + 1
    assert got.shape == (B, 8, H // 2, W // 2)
    assert (got - kernels.soft_bin_pool_plain(G)).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_bin_maps_kernel_flat_and_axis_aligned_gradients(cuda):
    """Zero gradients (weight 0, no NaN from 0/0) and gradients along the axes, whose angles lie on
    bin boundaries: the soft binning is continuous there."""
    ramp = torch.arange(64, dtype=torch.float32, device=cuda) / 64.0
    G = torch.stack([torch.zeros((40, 64), device=cuda), ramp.expand(40, 64), ramp[:40, None].expand(40, 64),
                     1.0 - ramp.expand(40, 64), 1.0 - ramp[:40, None].expand(40, 64)]).contiguous()
    got = kernels.bin_maps(G)
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    assert (got - kernels.soft_bin_pool_plain(G)).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_bin_maps_kernel_reads_strided_levels_in_one_launch(cuda):
    """The level slice G[:, 1:4] of every octave, read in place, equals the plain version on copies."""
    rng = np.random.default_rng(11)
    sizes = [(376, 1241), (188, 621), (94, 311), (47, 156)]
    gauss = [torch.from_numpy(rng.random((4, 6, H, W), np.float32)).to(cuda) for H, W in sizes]
    levels = [g[:, 1:4] for g in gauss]
    n = kernels.LAUNCHES["bin_maps"]
    got = kernels.bin_maps_octaves(levels)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bin_maps"] == n + 1
    for g, lev in zip(got, levels):
        assert (g - kernels.bin_maps_plain(lev)).abs().max().item() <= 1e-5
    rows = gauss[1][:, :, ::2]  # a row stride of 2 * W as well
    assert (kernels.bin_maps(rows) - kernels.bin_maps_plain(rows)).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_kernels_take_a_detection_batch_of_one(cuda):
    """One image, all four octaves in one launch per kernel: what a rank of a mesh whose "data"
    axis is 2 detects (the grid is a tile prefix over B x octaves)."""
    rng = np.random.default_rng(13)
    sizes = [(376, 1241), (188, 621), (94, 311), (47, 156)]
    dogs = [torch.from_numpy(_dog(rng, 5, H, W)[None]).to(cuda) for H, W in sizes]
    levels = [torch.from_numpy(rng.random((1, 6, H, W), np.float32)).to(cuda)[:, 1:4] for H, W in sizes]
    n1, n2 = kernels.LAUNCHES["extrema_scores"], kernels.LAUNCHES["bin_maps"]
    scores, maps = kernels.extrema_scores_octaves(dogs, THR), kernels.bin_maps_octaves(levels)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["extrema_scores"], kernels.LAUNCHES["bin_maps"]) == (n1 + 1, n2 + 1)
    for got, d in zip(scores, dogs):
        assert torch.equal(got, kernels.extrema_scores_plain(d, THR))
    for got, lev in zip(maps, levels):
        assert (got - kernels.bin_maps_plain(lev)).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_kernels_launch_on_the_current_stream(cuda):
    """On a non-default stream (the refiner's worker runs on its own): inputs made on that stream,
    results read after synchronising that stream only."""
    rng = np.random.default_rng(12)
    dog_h = torch.from_numpy(np.stack([_dog(rng, 5, 94, 311) for _ in range(2)]))
    G_h = torch.from_numpy(rng.random((2, 3, 94, 311), np.float32))
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        dog, G = dog_h.to(cuda, non_blocking=True), G_h.to(cuda, non_blocking=True)
        for _ in range(3):
            dog, G = dog * 1.0, G * 1.0  # queued work that the kernels must run after
        scores = kernels.extrema_scores(dog, THR)
        maps = kernels.bin_maps(G)
    stream.synchronize()
    assert torch.equal(scores.cpu(), kernels.extrema_scores_plain(dog_h, THR))
    assert (maps.cpu() - kernels.bin_maps_plain(G_h)).abs().max().item() <= 1e-5
