"""Plain PyTorch versions of the front end's two CUDA kernels (frozen copy of the plain
functions of vo_tpu_torch/frontend/kernels.py): K1 ``extrema_scores_plain`` and K2
``bin_maps_plain``. The reference runs these where the program launches its kernels."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NB = 8  # orientation bins of the dense descriptor maps


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


def bin_maps(G: torch.Tensor) -> torch.Tensor:
    """K2 over one octave, plain: [B, L, H, W] -> [B, L, 8, H//2, W//2], or [B, H, W] -> [B, 8, H//2, W//2]."""
    if G.ndim == 3:
        return soft_bin_pool_plain(G)
    return bin_maps_plain(G)


def extrema_scores_octaves(dogs, thr: float, border: int = 5) -> list:
    """K1 over every octave of a detection call, plain (the port's wrapper on the CPU)."""
    return [extrema_scores_plain(d, thr, border) for d in dogs]


def bin_maps_octaves(levels) -> list:
    """K2 over every octave of a detection call, plain (the port's wrapper on the CPU)."""
    return [bin_maps_plain(g) for g in levels]
