"""The two CUDA kernels' plain versions against the reference's Pallas kernels and XLA paths.

On the CPU the wrappers run their plain versions; the plain versions are held
against ``extrema_scores_pallas`` / ``_bin_maps_call`` in interpret mode and
against the reference's XLA paths. The kernel-vs-plain cases need a CUDA card
(marker ``gpu``) and skip without one. This module imports the jax reference
only inside the CPU tests, and the gpu cases use neither jax nor conftest's
fixtures, so they also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from vo_tpu.config import SIFTConfig
from vo_tpu_torch.frontend import kernels, sift

THR = 0.0133
BORDER = 5


def _dog(rng, L, H, W):
    return (gaussian_filter(rng.standard_normal((L, H, W)), 1.2) * 0.1).astype(np.float32)


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
    cfg = SIFTConfig(contrast_threshold=THR)
    lvl, ys, xs, top, valid = (np.asarray(a) for a in r_sift._find_candidates(jnp.asarray(dog), cfg, k))
    p = sift._find_candidates(torch.from_numpy(dog)[None], cfg, k)
    plvl, pys, pxs, ptop, pvalid = (a[0].numpy() for a in p)
    assert valid.sum() == pvalid.sum() > 0
    ref_set = set(zip(lvl[valid], ys[valid], xs[valid], top[valid]))
    assert ref_set == set(zip(plvl[pvalid], pys[pvalid], pxs[pvalid], ptop[pvalid]))


@pytest.mark.parametrize("H,W", [(64, 300), (96, 311), (47, 156)])
def test_bin_maps_plain_matches_reference(rng, H, W):
    import jax.numpy as jnp

    from vo_tpu.frontend import dense_desc as r_dense

    G = rng.random((2, H, W), np.float32)
    got = kernels.soft_bin_pool_plain(torch.from_numpy(G)).numpy()
    assert got.shape == (2, 8, H // 2, W // 2)
    xla = np.stack([np.asarray(r_dense._soft_bin_pool(jnp.asarray(g))) for g in G])
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _bin_maps_interpret(G), rtol=1e-5, atol=1e-5)


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
    """What the CUDA wrappers check (rank, dtype, contiguity) holds for every call detect_and_describe makes."""
    seen = []

    def spy(fn, rank):
        def wrapped(x, *a, **kw):
            seen.append((fn.__name__, x.ndim == rank and x.dtype == torch.float32 and x.is_contiguous()))
            return fn(x, *a, **kw)

        return wrapped

    monkeypatch.setattr(kernels, "extrema_scores", spy(kernels.extrema_scores, 4))
    monkeypatch.setattr(kernels, "bin_maps", spy(kernels.bin_maps, 3))
    img = torch.from_numpy(gaussian_filter(rng.random((3, 96, 160)), 1.0).astype(np.float32))
    sift.detect_and_describe(img, SIFTConfig(max_keypoints=64, n_octaves=3))
    assert sorted(n for n, _ in seen) == ["bin_maps"] * 3 + ["extrema_scores"] * 3
    assert all(ok for _, ok in seen), seen


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(376, 1241), (47, 156)])
def test_extrema_kernel_matches_plain(cuda, H, W):
    rng = np.random.default_rng(7)
    dog = torch.from_numpy(np.stack([_dog(rng, 5, H, W) for _ in range(2)])).to(cuda)
    n = kernels.LAUNCHES["extrema_scores"]
    got = kernels.extrema_scores(dog, THR)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["extrema_scores"] == n + 1
    assert torch.equal(got, kernels.extrema_scores_plain(dog, THR))


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(376, 1241), (96, 311), (47, 156)])
def test_bin_maps_kernel_matches_plain(cuda, H, W):
    rng = np.random.default_rng(8)
    G = torch.from_numpy(rng.random((3, H, W), np.float32)).to(cuda)
    n = kernels.LAUNCHES["bin_maps"]
    got = kernels.bin_maps(G)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bin_maps"] == n + 1
    assert (got - kernels.soft_bin_pool_plain(G)).abs().max().item() <= 1e-5
