"""Dense-map SIFT orientation + descriptor, batched over images (port of vo_tpu.frontend.dense_desc).

Per pyramid level, gradient orientations are soft-binned into 8 channel maps,
2x2 sum-pooled to stride 2 (kernel K2, ``kernels.bin_maps_octaves``) and blurred at
the descriptor-cell scale into channel-last rows (kernel K4, ``bin_map_rows``). A
keypoint's orientation histogram and its 4x4x8 descriptor are then a few bilinear
ROW samples of those maps (8 contiguous channels per sample). See the reference module for the approximations this
makes against Lowe's exact formulation and the tests that gate them.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils import cuda_lib
from . import kernels
from .pyramid import TAP_TYPES, _const, blur_separable, gaussian_kernel_1d, tap_pointers

_NB = kernels.NB  # descriptor orientation bins
_CELLS = 4  # 4x4 spatial cells


def _cell_weights() -> np.ndarray:
    """Per-cell global Gaussian weight (ratio-invariant in units of cell size)."""
    w = np.zeros((_CELLS * _CELLS,), np.float32)
    for i in range(_CELLS):
        for j in range(_CELLS):
            a, b = i - 1.5, j - 1.5
            w[i * _CELLS + j] = math.exp(-(a * a + b * b) / 8.0)
    return w


_W_CELL = _cell_weights()  # [16]


def _map_kernel(sigma_rel: float) -> np.ndarray:
    """The blur of a level's pooled maps at the descriptor cell window scale (half sigma on the stride-2 grid)."""
    return gaussian_kernel_1d(max(1.5 * sigma_rel / 2.0, 0.5))


def _blur_maps(maps: torch.Tensor, sigma_rel: float) -> torch.Tensor:
    """Blur [..., 8, H2, W2] pooled maps by _map_kernel: the band products."""
    return blur_separable(maps, _map_kernel(sigma_rel))


def build_bin_maps(G_level: torch.Tensor, sigma_rel: float) -> torch.Tensor:
    """One Gaussian level [H, W] -> blurred stride-2 bin maps [H2, W2, 8].

    ``sigma_rel`` is the level's scale relative to the octave base; the blur
    approximates the descriptor cell window sigma_cell = 1.5 * sigma_rel. The
    pooled maps come from kernel K2 and their blur from K4 on a CUDA tensor,
    from their plain versions on the CPU.
    """
    raw = kernels.bin_maps(G_level[None, None])  # [1, 1, 8, H2, W2]
    return bin_map_rows([raw], [sigma_rel]).reshape(raw.shape[-2], raw.shape[-1], _NB)


def bin_map_rows(raws, sigma_rels, use_pallas: bool = True) -> torch.Tensor:
    """Unblurred pooled maps, per octave [B, L, 8, H2_o, W2_o] -> the descriptor's flat map rows
    [B, N, 8]: octave by octave, level by level, row-major, level l blurred by
    ``_map_kernel(sigma_rels[l])``.

    ``use_pallas`` on a CUDA tensor: kernel K4, every level of every octave in one launch,
    each writing its rows where they lie; otherwise, and on the CPU, the band products.
    """
    raws = list(raws)
    if use_pallas and raws[0].device.type != "cpu":
        return _bin_map_rows_k4(raws, [float(s) for s in sigma_rels])
    rows = []
    for raw in raws:
        B, L = raw.shape[:2]
        for l in range(L):
            blurred = _blur_maps(raw[:, l], float(sigma_rels[l]))  # [B, 8, H2, W2]
            rows.append(blurred.permute(0, 2, 3, 1).reshape(B, -1, _NB))
    return torch.cat(rows, dim=1)


def row_jobs(shapes, n_levels: int) -> list:
    """(octave, level, first row) of each level's rows in bin_map_rows' output, per octave map size (H2, W2)."""
    jobs, row = [], 0
    for o, (H2, W2) in enumerate(shapes):
        for l in range(n_levels):
            jobs.append((o, l, row))
            row += H2 * W2
    return jobs


MAX_ROW_JOBS = 24  # kMaxJobs in csrc/gauss_blur.cu: octaves x levels of one launch
# Per job: source, its batch stride, first row, H2, W2, level; then jobs, dst, its batch stride, B, L, the tap tables.
_K4_ROWS = cuda_lib.Kernel("vo_gauss_rows", "gauss_blur", [
    ctypes.POINTER(ctypes.c_void_p), *[ctypes.POINTER(ctypes.c_longlong)] * 2, *[ctypes.POINTER(ctypes.c_int)] * 3,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, *TAP_TYPES,
])


def _bin_map_rows_k4(raws, sigma_rels) -> torch.Tensor:
    """bin_map_rows through K4 (csrc/gauss_blur.cu) in one launch: contiguous float32 maps of one B and L."""
    B, L = raws[0].shape[:2]
    for raw in raws:
        if not (raw.device.type == "cuda" and raw.dtype == torch.float32 and raw.ndim == 5 and raw.is_contiguous()
                and raw.shape[:3] == (B, L, _NB) and raw.device == raws[0].device and 0 not in raw.shape):
            raise ValueError(
                f"gauss_blur: expected contiguous float32 CUDA maps [B, L, 8, H2, W2] of one B, L and device, got "
                f"{raw.dtype} {tuple(raw.shape)} on {raw.device}"
            )
    shapes = [tuple(raw.shape[3:]) for raw in raws]
    jobs = row_jobs(shapes, L)
    if not len(jobs) <= MAX_ROW_JOBS or len(sigma_rels) < L:
        raise ValueError(f"gauss_blur: {len(jobs)} level maps in one launch (at most {MAX_ROW_JOBS}), {len(sigma_rels)} sigmas")
    dst = torch.empty((B, sum(L * h * w for h, w in shapes), _NB), dtype=torch.float32, device=raws[0].device)
    srcs = [raws[o].data_ptr() + 4 * l * _NB * shapes[o][0] * shapes[o][1] for o, l, _ in jobs]
    _K4_ROWS.launch(
        dst, cuda_lib.array(ctypes.c_void_p, srcs),
        cuda_lib.array(ctypes.c_longlong, [raws[o].stride(0) for o, _, _ in jobs]),
        cuda_lib.array(ctypes.c_longlong, [row for _, _, row in jobs]),
        cuda_lib.array(ctypes.c_int, [shapes[o][0] for o, _, _ in jobs]),
        cuda_lib.array(ctypes.c_int, [shapes[o][1] for o, _, _ in jobs]),
        cuda_lib.array(ctypes.c_int, [l for _, l, _ in jobs]),
        len(jobs), dst.data_ptr(), dst.stride(0), B, L,
        *tap_pointers(tuple(_map_kernel(s) for s in sigma_rels[:L])),
    )
    return dst


def _bilinear_rows(flat: torch.Tensor, row_base, ys: torch.Tensor, xs: torch.Tensor, H2, W2) -> torch.Tensor:
    """Bilinear sample of [B, N, 8] rows at stride-2 coords [B, ...] -> [B, ..., 8].

    ``row_base`` is the flat row of (y=0, x=0) of the level each sample reads;
    H2/W2 are ints or integer tensors broadcastable against ``ys``/``xs``.
    Row indices are clamped into [0, N) like the reference's ``mode="clip"``.
    """
    B, N, C = flat.shape
    x0 = torch.clamp(torch.clamp(torch.floor(xs), min=0), max=W2 - 2)
    y0 = torch.clamp(torch.clamp(torch.floor(ys), min=0), max=H2 - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(ys - y0, 0.0, 1.0)[..., None]
    base = row_base + y0.long() * W2 + x0.long()
    img_off = (torch.arange(B, device=flat.device) * N).reshape((B,) + (1,) * (base.ndim - 1))
    rows = flat.reshape(B * N, C)

    def tap(idx):
        i = idx.clamp(0, N - 1) + img_off
        return rows.index_select(0, i.reshape(-1)).reshape(i.shape + (C,))

    return (
        tap(base) * (1 - fx) * (1 - fy)
        + tap(base + 1) * fx * (1 - fy)
        + tap(base + W2) * (1 - fx) * fy
        + tap(base + W2 + 1) * fx * fy
    )


def _col(v):
    """Broadcast a per-keypoint [B, K] tensor (or int) against [B, K, P] taps."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def orientation_hists(maps_flat, row_base, yf, xf, sigma_rel, H2, W2) -> torch.Tensor:
    """Smoothed circular orientation histogram per keypoint, [B, K, 8].

    A 3x3 tap grid at 1.5*sigma spacing with Gaussian weights widens the
    window past the descriptor-cell blur (a single row sample is so local
    that sub-pixel shifts flip the winning bin). yf/xf: [B, K] octave-local
    full-res coords; a stride-2 cell i covers full-res pixels 2i, 2i+1, so
    map coords are (p - 0.5) / 2.
    """
    d = torch.arange(-1.0, 2.0, dtype=torch.float32, device=yf.device)  # [-1, 0, 1], made on the device
    oy = d[:, None].expand(3, 3).reshape(-1)  # [9]
    ox = d[None, :].expand(3, 3).reshape(-1)
    w = torch.exp(-0.5 * (oy**2 + ox**2))  # [9]
    step = 1.5 * sigma_rel[..., None]  # [B, K, 1]
    ys = (yf[..., None] + oy * step - 0.5) / 2.0
    xs = (xf[..., None] + ox * step - 0.5) / 2.0
    taps = _bilinear_rows(maps_flat, _col(row_base), ys, xs, _col(H2), _col(W2))  # [B, K, 9, 8]
    hist = torch.einsum("p,bkpc->bkc", w, taps)
    # Circular smoothing (the maps are spatially but not angularly smoothed).
    return (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0


def descriptors(maps_flat, row_base, yf, xf, sigma_rel, theta, H2, W2) -> torch.Tensor:
    """[B, K, 128] descriptors via 16 rotated cell-center row samples per keypoint."""
    d = torch.arange(_CELLS, dtype=torch.float32, device=yf.device) - (_CELLS - 1) / 2.0
    oy = d[:, None].expand(_CELLS, _CELLS).reshape(-1)  # [16]
    ox = d[None, :].expand(_CELLS, _CELLS).reshape(-1)
    cell = 3.0 * sigma_rel[..., None]  # [B, K, 1] cell width in full-res px
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    # Rotated cell centers, full-res px -> stride-2 map coords.
    xs = (xf[..., None] + (ct * ox - st * oy) * cell - 0.5) / 2.0
    ys = (yf[..., None] + (st * ox + ct * oy) * cell - 0.5) / 2.0
    cells = _bilinear_rows(maps_flat, _col(row_base), ys, xs, _col(H2), _col(W2))  # [B, K, 16, 8]
    cells = cells * _const(("cell_weights",), lambda: _W_CELL, cells.device)[:, None]
    # Rotate the bins into the keypoint frame: a fractional circular shift,
    # out-bin o reads in-bins i0 and i0+1 with weights (1-fs, fs).
    shift = theta / (2.0 * math.pi) * _NB
    s0 = torch.floor(shift)
    fs = (shift - s0)[..., None, None]  # [B, K, 1, 1]
    i0 = (torch.arange(_NB, device=yf.device) + s0.long()[..., None]) % _NB  # [B, K, 8]
    i0 = i0[..., None, :].expand(cells.shape)
    desc = (1.0 - fs) * torch.gather(cells, -1, i0) + fs * torch.gather(cells, -1, (i0 + 1) % _NB)
    desc = desc.reshape(desc.shape[:-2] + (_CELLS * _CELLS * _NB,))
    # Lowe normalization: L2 -> clip 0.2 -> L2.
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-12)
    desc = torch.clamp(desc, max=0.2)
    return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-12)
