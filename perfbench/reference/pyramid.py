"""Frozen copy of vo_tpu_torch/frontend/pyramid.py for the benchmark's plain reference: imports repointed to this
folder, kernels replaced by their plain versions, the TF32 flags left to the caller.
The program may change; this copy stays as it was.

Gaussian / difference-of-Gaussian pyramid, batched over images (port of vo_tpu.frontend.pyramid).

The band-matrix and decimation-matrix constructors are numpy, copied from the
reference (which imports jax). Every blur is a product with a banded [n, n]
matrix whose edge taps accumulate onto the border (edge-replicate padding),
and every level of an octave blurs directly from the octave base; the 2x
decimation of the next octave is folded into the band matrices. The products
run through ``torch.matmul``/``einsum`` in full float32: reduced precision in
the pyramid flickers detections.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .config import SIFTConfig


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _band_matrix(n: int, kernel: np.ndarray) -> np.ndarray:
    """[n, n] banded blur matrix; taps outside [0, n) accumulate on the border element."""
    r = (kernel.shape[0] - 1) // 2
    B = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for t, kt in enumerate(kernel):
        src = np.clip(rows + t - r, 0, n - 1)
        np.add.at(B, (rows, src), kt)
    return B


def _decimation_matrix(n_in: int) -> np.ndarray:
    """[(n_in+1)//2, n_in] every-2nd-row selector (the ::2 decimation)."""
    n_out = (n_in + 1) // 2
    D = np.zeros((n_out, n_in), np.float32)
    D[np.arange(n_out), 2 * np.arange(n_out)] = 1.0
    return D


def sigma_schedule(cfg: SIFTConfig) -> tuple[np.ndarray, np.ndarray]:
    """Absolute per-level sigmas and the incremental blur from level i-1 -> i."""
    s = cfg.scales_per_octave
    k = 2.0 ** (1.0 / s)
    sig = np.array([cfg.sigma0 * (k**i) for i in range(s + 3)])
    inc = np.zeros_like(sig)
    for i in range(1, s + 3):
        inc[i] = math.sqrt(max(sig[i] ** 2 - sig[i - 1] ** 2, 1e-8))
    return sig, inc


# Device copies of the constant matrices, keyed by what determines them. The
# numpy constructors are deterministic, so a cached copy is always the same value.
_CONST_CACHE: dict = {}


def _const(key: tuple, build, device):
    """Device copy of ``build()`` (an array or a tuple of arrays), built once per key and device."""
    k = key + (str(device),)
    hit = _CONST_CACHE.get(k)
    if hit is None:
        arrs = build()
        hit = tuple(torch.from_numpy(a).to(device) for a in arrs) if isinstance(arrs, tuple) else torch.from_numpy(arrs).to(device)
        _CONST_CACHE[k] = hit
    return hit


def blur_separable(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] with edge-replicate padding (two band products)."""
    H, W = img.shape[-2], img.shape[-1]
    kb = kernel.tobytes()
    Bh = _const(("band", H, kb), lambda: _band_matrix(H, kernel), img.device)
    Bw = _const(("band", W, kb), lambda: _band_matrix(W, kernel), img.device)
    x = torch.matmul(Bh, img)
    return torch.matmul(x, Bw.T)


def _stack_matrices(H: int, W: int, sig: np.ndarray, decimate: bool) -> tuple:
    """[L, H', H] and [L, W', W] band matrices of every level of one octave."""
    Dh = _decimation_matrix(H) if decimate else None
    Dw = _decimation_matrix(W) if decimate else None
    Ho = Dh.shape[0] if decimate else H
    Wo = Dw.shape[0] if decimate else W
    Bh, Bw = [], []
    for i in range(len(sig)):
        d2 = float(sig[i]) ** 2 - float(sig[0]) ** 2
        k = np.array([1.0], np.float32) if d2 <= 1e-8 else gaussian_kernel_1d(math.sqrt(d2))
        bh = _band_matrix(Ho, k)
        bw = _band_matrix(Wo, k)
        Bh.append(bh @ Dh if decimate else bh)
        Bw.append(bw @ Dw if decimate else bw)
    return np.stack(Bh), np.stack(Bw)


def _blur_stack_from_base(base: torch.Tensor, sig: np.ndarray, decimate: bool = False) -> torch.Tensor:
    """[B, H, W] octave base -> [B, L, H', W'] all levels, as two batched products."""
    H, W = base.shape[-2], base.shape[-1]
    key = ("stack", H, W, sig.tobytes(), decimate)
    Bh_all, Bw_all = _const(key, lambda: _stack_matrices(H, W, sig, decimate), base.device)
    x = torch.einsum("lhH,bHw->blhw", Bh_all, base)
    # einsum may hand back a permuted view; the kernels downstream take contiguous stacks.
    return torch.einsum("blhw,lWw->blhW", x, Bw_all).contiguous()


class Pyramid(NamedTuple):
    """Per-octave stacks, one list entry per octave."""

    gauss: list  # octave -> [B, S+3, H_o, W_o]
    dog: list  # octave -> [B, S+2, H_o, W_o]
    sigmas: np.ndarray  # [S+3] sigma of each level relative to the octave base
    n_scales: int  # S


def build_pyramid(img: torch.Tensor, cfg: SIFTConfig) -> Pyramid:
    """img: [B, H, W] float32 in [0, 1]."""
    sig, _ = sigma_schedule(cfg)
    s = cfg.scales_per_octave
    # The input carries sigma ~0.5 of the camera; bring the base to sigma0.
    base_blur = math.sqrt(max(cfg.sigma0**2 - 0.5**2, 0.01))
    cur = blur_separable(img, gaussian_kernel_1d(base_blur))
    gauss_octaves, dog_octaves = [], []
    for o in range(cfg.n_octaves):
        # Next-octave handoff: level S decimated 2x, folded into the band matrices.
        G = _blur_stack_from_base(cur, sig, decimate=o > 0)
        gauss_octaves.append(G)
        dog_octaves.append(G[:, 1:] - G[:, :-1])
        cur = G[:, s]
    return Pyramid(gauss=gauss_octaves, dog=dog_octaves, sigmas=sig, n_scales=s)


def gradients(G: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients of [..., H, W] Gaussian stacks -> (gx, gy), zero on the image border."""
    gx = 0.5 * (torch.roll(G, -1, dims=-1) - torch.roll(G, 1, dims=-1))
    gy = 0.5 * (torch.roll(G, -1, dims=-2) - torch.roll(G, 1, dims=-2))
    # Zero the wrapped borders.
    gx[..., :, 0] = 0.0
    gx[..., :, -1] = 0.0
    gy[..., 0, :] = 0.0
    gy[..., -1, :] = 0.0
    return gx, gy
