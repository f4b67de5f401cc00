"""Gaussian / difference-of-Gaussian pyramid, batched over images (port of vo_tpu.frontend.pyramid).

The band-matrix and decimation-matrix constructors are numpy, copied from the
reference (which imports jax). Every blur is a product with a banded [n, n]
matrix whose edge taps accumulate onto the border (edge-replicate padding),
and every level of an octave blurs directly from the octave base; the 2x
decimation of the next octave is folded into the band matrices. On a CUDA
tensor with ``use_pallas`` kernel K4 (``gauss_stack``, csrc/gauss_blur.cu)
applies the band matrices' nonzero weights directly, in the products' order of
summation, one launch for the base blur and one per octave, each writing the
octave's levels and its DoG. Otherwise (the CPU, ``use_pallas=False``) the
products run through ``torch.matmul``/``einsum``, in full float32: reduced
precision in the pyramid flickers detections.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SIFTConfig
from . import kernels


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


def _level_kernels(sig: np.ndarray) -> tuple:
    """The blur of each level of an octave from its base: sigma sqrt(sig[i]^2 - sig[0]^2), level 0 the identity."""
    out = []
    for i in range(len(sig)):
        d2 = float(sig[i]) ** 2 - float(sig[0]) ** 2
        out.append(np.array([1.0], np.float32) if d2 <= 1e-8 else gaussian_kernel_1d(math.sqrt(d2)))
    return tuple(out)


def _stack_matrices(H: int, W: int, sig: np.ndarray, decimate: bool) -> tuple:
    """[L, H', H] and [L, W', W] band matrices of every level of one octave."""
    Dh = _decimation_matrix(H) if decimate else None
    Dw = _decimation_matrix(W) if decimate else None
    Ho = Dh.shape[0] if decimate else H
    Wo = Dw.shape[0] if decimate else W
    Bh, Bw = [], []
    for k in _level_kernels(sig):
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
    base = gaussian_kernel_1d(math.sqrt(max(cfg.sigma0**2 - 0.5**2, 0.01)))
    levels = _level_kernels(sig)
    gauss_octaves, dog_octaves = [], []
    if cfg.use_pallas and img.device.type != "cpu":
        # K4: the base blur, then per octave every level and the DoG in one launch.
        cur = gauss_stack(img, (base,), decimate=False, dog=False)[0][:, 0]
        for o in range(cfg.n_octaves):
            G, D = gauss_stack(cur, levels, decimate=o > 0, dog=True)
            gauss_octaves.append(G)
            dog_octaves.append(D)
            cur = G[:, s]
        return Pyramid(gauss=gauss_octaves, dog=dog_octaves, sigmas=sig, n_scales=s)
    cur = blur_separable(img, base)
    for o in range(cfg.n_octaves):
        # Next-octave handoff: level S decimated 2x, folded into the band matrices.
        G = _blur_stack_from_base(cur, sig, decimate=o > 0)
        gauss_octaves.append(G)
        dog_octaves.append(G[:, 1:] - G[:, :-1])
        cur = G[:, s]
    return Pyramid(gauss=gauss_octaves, dog=dog_octaves, sigmas=sig, n_scales=s)


# ---------------------------------------------------------------------------
# K4: the blurs as a hand-written kernel (csrc/gauss_blur.cu)
# ---------------------------------------------------------------------------

MAX_RADIUS = 16  # kMaxR in csrc/gauss_blur.cu
MAX_LEVELS = 8  # kMaxLevels: levels of one gauss_stack launch
_TAP_CACHE: dict = {}


def tap_table(kernel: np.ndarray) -> tuple:
    """K4's weights for a blur by ``kernel``, read off the band matrices: (r, taps [2r+1], lo [r+1],
    hi [r+1], tot), float32.

    A row of ``_band_matrix(n, kernel)`` depends only on its distance from the ends: the interior
    weights are the taps, lo[i] = B[i, 0] and hi[i] = B[n-1-i, n-1] (i <= r) are the taps merged onto
    the end samples (for any n >= 2), and tot = B[0, 0] at n = 1, where every tap falls on one sample.
    """
    r = (kernel.shape[0] - 1) // 2
    n = 2 * r + 2
    band = _band_matrix(n, kernel)
    i = np.arange(r + 1)
    return r, band[r, : 2 * r + 1], band[i, 0], band[n - 1 - i, n - 1], _band_matrix(1, kernel)[0, 0]


def tap_arrays(kernels_1d) -> tuple:
    """tap_table of each kernel in the layout csrc/gauss_blur.cu reads: radii int32 [n], taps float32
    [n, 2 MAX_RADIUS + 1], lo and hi [n, MAX_RADIUS + 1], tot [n], zero-padded. Built once per set."""
    key = tuple(k.tobytes() for k in kernels_1d)
    hit = _TAP_CACHE.get(key)
    if hit is None:
        n = len(kernels_1d)
        radii = np.zeros(n, np.int32)
        taps = np.zeros((n, 2 * MAX_RADIUS + 1), np.float32)
        lo = np.zeros((n, MAX_RADIUS + 1), np.float32)
        hi = np.zeros((n, MAX_RADIUS + 1), np.float32)
        tot = np.zeros(n, np.float32)
        for j, k in enumerate(kernels_1d):
            r, t, lo_j, hi_j, tot_j = tap_table(k)
            if r > MAX_RADIUS:
                raise ValueError(f"gauss_blur: a blur of radius {r} exceeds the kernel's {MAX_RADIUS}")
            radii[j], taps[j, : 2 * r + 1], lo[j, : r + 1], hi[j, : r + 1], tot[j] = r, t, lo_j, hi_j, tot_j
        hit = _TAP_CACHE[key] = (radii, taps, lo, hi, tot)
    return hit


def tap_pointers(kernels_1d) -> list:
    """tap_arrays as the ctypes pointers the kernel's entry points take (the arrays stay cached)."""
    radii, *floats = tap_arrays(kernels_1d)
    return [radii.ctypes.data_as(ctypes.POINTER(ctypes.c_int))] + [
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in floats
    ]


def gauss_stack(src: torch.Tensor, kernels_1d, decimate: bool, dog: bool) -> tuple:
    """K4 over one octave: [B, H, W] float32 ``src`` on a CUDA device (unit stride along x; a level
    view ``G[:, s]`` is read in place) blurred by each of ``kernels_1d`` -> (G [B, L, H', W'], the DoG
    G[:, 1:] - G[:, :-1] where ``dog``, else None), contiguous; with ``decimate`` the samples are the
    even rows and columns of ``src`` (H' = (H + 1) // 2), as _blur_stack_from_base's matrices take
    them. Equal to the band products up to their GEMM's order of summation. One launch."""
    if src.device.type != "cuda":
        raise ValueError(f"gauss_blur: K4 runs on a CUDA device, got {src.device} (the plain version: the band products)")
    L = len(kernels_1d)
    if src.dtype != torch.float32 or src.ndim != 3 or src.stride(2) != 1 or 0 in src.shape:
        raise ValueError(
            f"gauss_blur: expected a float32 [B, H, W] tensor with unit stride along x, got {src.dtype} "
            f"{tuple(src.shape)} strides {src.stride()}"
        )
    if not (2 if dog else 1) <= L <= MAX_LEVELS:
        raise ValueError(f"gauss_blur: {L} levels (at most {MAX_LEVELS}, at least 2 with the DoG)")
    B, H, W = src.shape
    Ho, Wo = ((H + 1) // 2, (W + 1) // 2) if decimate else (H, W)
    G = torch.empty((B, L, Ho, Wo), dtype=torch.float32, device=src.device)
    D = torch.empty((B, L - 1, Ho, Wo), dtype=torch.float32, device=src.device) if dog else None
    with torch.cuda.device(src.device):
        err = kernels.load().vo_gauss_stack(
            src.data_ptr(), src.stride(0), src.stride(1), 2 if decimate else 1, Ho, Wo, G.data_ptr(),
            None if D is None else D.data_ptr(), B, L, *tap_pointers(kernels_1d),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.raise_on(err, "gauss_blur")
    kernels.count_launch("gauss_blur")
    return G, D


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
