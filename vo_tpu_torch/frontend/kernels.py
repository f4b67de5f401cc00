"""The front-end's hand-written CUDA kernels: K1 and K2's wrappers and plain versions.

K1 ``extrema_scores`` replaces vo_tpu/frontend/pallas_kernels.py::extrema_scores_pallas;
K2 ``bin_maps`` replaces vo_tpu/frontend/pallas_kernels.py::bin_maps_pallas. Their sources
are ``csrc/extrema_scores.cu`` and ``csrc/bin_maps.cu``, built, bound, launched and counted
(``cuda_lib.LAUNCHES``) through utils.cuda_lib, as are the library's other kernels, whose
wrappers live where they are used: K3 ``pose_refine`` in pose/ransac.py, K4 ``gauss_blur``
in pyramid.py and dense_desc.py, the tracer's stage stamp in utils/profiling.py.

K1 and K2 take every octave of a detection call in ONE launch (``extrema_scores_octaves``,
``bin_maps_octaves``); the one-octave wrappers (``extrema_scores``, ``bin_maps``) launch the
same kernels on a list of one. CPU tensors take the plain versions.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..utils import cuda_lib

NB = 8  # orientation bins of the dense descriptor maps
MAX_OCTAVES = 8  # octaves one launch takes (kMaxOctaves in csrc/*.cu)

_PTRS, _INTS, _LONGS = (ctypes.POINTER(t) for t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong))
# Per octave: inputs, outputs, H, W; then octaves, B, L, thr/2, border.
_K1 = cuda_lib.Kernel("vo_extrema_scores", "extrema_scores",
                      [_PTRS, _PTRS, _INTS, _INTS, *[ctypes.c_int] * 3, ctypes.c_float, ctypes.c_int])
# Per octave: inputs, outputs, the three outer strides, H, W; then octaves, B, L.
_K2 = cuda_lib.Kernel("vo_bin_maps", "bin_maps", [_PTRS, _PTRS, *[_LONGS] * 3, _INTS, _INTS, *[ctypes.c_int] * 3])


def _check_octaves(xs, name: str, contiguous: bool) -> None:
    """What the kernels take, on any device: 1..MAX_OCTAVES float32 tensors [B, L, H, W] with
    one B and L and a unit stride along x (``contiguous``: no stride at all)."""
    if not 1 <= len(xs) <= MAX_OCTAVES:
        raise ValueError(f"{name}: expected 1..{MAX_OCTAVES} octaves, got {len(xs)}")
    for x in xs:
        ok = x.dtype == torch.float32 and x.ndim == 4 and x.shape[:2] == xs[0].shape[:2] and x.device == xs[0].device
        ok = ok and (x.is_contiguous() if contiguous else x.stride(3) == 1)
        if not ok:
            raise ValueError(
                f"{name}: expected float32 [B, L, H, W] tensors of one B, L and device, "
                f"{'contiguous' if contiguous else 'with unit stride along x'}; got {x.dtype} {tuple(x.shape)} "
                f"strides {x.stride()} on {x.device}"
            )
        if x.shape[0] * x.shape[1] > 65535 or x.shape[2] * x.shape[3] >= 2**31:
            raise ValueError(f"{name}: {tuple(x.shape)} exceeds the launch grid")


def _require_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got device {x.device}")


def _empty_octaves(shapes, device) -> list:
    """One uninitialised float32 tensor per shape: views, back to back, of one allocation."""
    sizes = [math.prod(shape) for shape in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    return [part.view(shape) for part, shape in zip(flat.split(sizes), shapes)]


# ---------------------------------------------------------------------------
# K1: extrema scores
# ---------------------------------------------------------------------------


def extrema_scores_plain(dog: torch.Tensor, thr: float, border: int = 5) -> torch.Tensor:
    """[B, L, H, W] DoG stacks -> [B, L-2, H, W] candidate scores (the score part of
    vo_tpu's sift._find_candidates): |dog| at 3x3x3 extrema with |dog| > thr/2 at least
    ``border`` px inside the image, -1 elsewhere; inner levels only."""
    B, L, H, W = dog.shape
    x = dog[:, None]
    mx = F.max_pool3d(x, 3, stride=1, padding=1)[:, 0, 1:-1]
    mn = -F.max_pool3d(-x, 3, stride=1, padding=1)[:, 0, 1:-1]
    c = dog[:, 1:-1]
    ys = torch.arange(H, device=dog.device)[:, None]
    xs = torch.arange(W, device=dog.device)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    valid = ((c >= mx) | (c <= mn)) & (c.abs() > 0.5 * thr) & inb
    return torch.where(valid, c.abs(), -1.0)


def extrema_scores_octaves(dogs, thr: float, border: int = 5) -> list:
    """K1 wrapper over a pyramid: per-octave [B, L, H_o, W_o] DoG stacks -> per-octave
    [B, L-2, H_o, W_o] scores (see extrema_scores_plain), all octaves in one launch."""
    dogs = list(dogs)
    if dogs and dogs[0].device.type == "cpu":
        return [extrema_scores_plain(d, thr, border) for d in dogs]
    _check_octaves(dogs, "extrema_scores", contiguous=True)
    _require_cuda(dogs[0], "extrema_scores")
    B, L = dogs[0].shape[:2]
    if B == 0 or L < 3 or border < 0:
        raise ValueError(f"extrema_scores: need B >= 1, L >= 3 levels and border >= 0, got {tuple(dogs[0].shape)}, {border}")
    shapes = [(B, L - 2, d.shape[2], d.shape[3]) for d in dogs]
    outs = _empty_octaves(shapes, dogs[0].device)
    _K1.launch(
        dogs[0], cuda_lib.array(ctypes.c_void_p, [d.data_ptr() for d in dogs]),
        cuda_lib.array(ctypes.c_void_p, [o.data_ptr() for o in outs]),
        cuda_lib.array(ctypes.c_int, [d.shape[2] for d in dogs]),
        cuda_lib.array(ctypes.c_int, [d.shape[3] for d in dogs]),
        len(dogs), B, L, 0.5 * thr, border,
    )
    return outs


def extrema_scores(dog: torch.Tensor, thr: float, border: int = 5) -> torch.Tensor:
    """K1 wrapper, one octave: [B, L, H, W] -> [B, L-2, H, W] scores (see extrema_scores_plain)."""
    return extrema_scores_octaves([dog], thr, border)[0]


# ---------------------------------------------------------------------------
# K2: pooled soft-bin maps
# ---------------------------------------------------------------------------


def soft_bin_pool_plain(G: torch.Tensor) -> torch.Tensor:
    """[B, H, W] Gaussian levels -> UNBLURRED pooled soft-bin maps [B, 8, H//2, W//2]
    (vo_tpu's dense_desc._soft_bin_pool, batched)."""
    B, H, W = G.shape
    gx = 0.5 * (torch.roll(G, -1, dims=2) - torch.roll(G, 1, dims=2))
    gy = 0.5 * (torch.roll(G, -1, dims=1) - torch.roll(G, 1, dims=1))
    gx[:, :, 0] = 0.0
    gx[:, :, -1] = 0.0
    gy[:, 0, :] = 0.0
    gy[:, -1, :] = 0.0
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    b = (ang / (2.0 * math.pi) + 0.5) * NB  # [0, 8]
    b0 = torch.floor(b)
    fb = b - b0
    b0i = b0.long() % NB
    bins = torch.arange(NB, device=G.device)
    # Exact soft binning: each pixel feeds its two adjacent bins.
    maps = (b0i[..., None] == bins) * ((1.0 - fb) * mag)[..., None] + (
        ((b0i + 1) % NB)[..., None] == bins
    ) * (fb * mag)[..., None]  # [B, H, W, 8]
    H2, W2 = H // 2, W // 2
    maps = maps[:, : H2 * 2, : W2 * 2].reshape(B, H2, 2, W2, 2, NB).sum(dim=(2, 4))
    return maps.permute(0, 3, 1, 2).contiguous()


def bin_maps_plain(levels: torch.Tensor) -> torch.Tensor:
    """soft_bin_pool_plain over [B, L, H, W] -> [B, L, 8, H//2, W//2]."""
    B, L, H, W = levels.shape
    return soft_bin_pool_plain(levels.reshape(B * L, H, W)).reshape(B, L, NB, H // 2, W // 2)


def bin_maps_octaves(levels) -> list:
    """K2 wrapper over a pyramid: per-octave [B, L, H_o, W_o] Gaussian levels -> per-octave
    [B, L, 8, H_o//2, W_o//2] pooled soft-bin maps (see soft_bin_pool_plain), all octaves in
    one launch. The levels are read in place: any strides with a unit stride along x, so a
    slice of levels such as ``G[:, 1:4]`` needs no copy."""
    levels = list(levels)
    if levels and levels[0].device.type == "cpu":
        return [bin_maps_plain(g) for g in levels]
    _check_octaves(levels, "bin_maps", contiguous=False)
    _require_cuda(levels[0], "bin_maps")
    B, L = levels[0].shape[:2]
    if B == 0 or L == 0 or any(g.shape[2] < 2 or g.shape[3] < 2 for g in levels):
        raise ValueError(f"bin_maps: need B, L >= 1 and H, W >= 2, got {[tuple(g.shape) for g in levels]}")
    shapes = [(B, L, NB, g.shape[2] // 2, g.shape[3] // 2) for g in levels]
    outs = _empty_octaves(shapes, levels[0].device)
    _K2.launch(
        levels[0], cuda_lib.array(ctypes.c_void_p, [g.data_ptr() for g in levels]),
        cuda_lib.array(ctypes.c_void_p, [o.data_ptr() for o in outs]),
        *(cuda_lib.array(ctypes.c_longlong, [g.stride(d) for g in levels]) for d in (0, 1, 2)),
        cuda_lib.array(ctypes.c_int, [g.shape[2] for g in levels]),
        cuda_lib.array(ctypes.c_int, [g.shape[3] for g in levels]),
        len(levels), B, L,
    )
    return outs


def bin_maps(G: torch.Tensor) -> torch.Tensor:
    """K2 wrapper, one octave: [B, L, H, W] -> [B, L, 8, H//2, W//2], or [B, H, W] -> [B, 8, H//2, W//2]."""
    if G.ndim == 3:
        return bin_maps_octaves([G[:, None]])[0][:, 0]
    return bin_maps_octaves([G])[0]
