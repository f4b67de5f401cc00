"""SIFT-style detection + description over a batch of images (port of vo_tpu.frontend.sift).

Detection is one code path: dense 3x3x3 DoG extrema scores (kernel K1, one
``kernels.extrema_scores_octaves`` launch for the whole pyramid), an exact
per-octave ``torch.topk``, vectorised quadratic subpixel refinement, a global
top-k by response. Orientation and description have two:

- the fast path (``fast_descriptor=True``, the default): orientation
  histograms and descriptors from the dense bin maps (kernel K2, one
  ``kernels.bin_maps_octaves`` launch, blurred by
  ``dense_desc.build_bin_map_rows``);
- the Lowe-exact oracle path (``fast_descriptor=False``): per-keypoint bilinear
  samples of the flattened multi-octave gradient stacks, a 17x17 window for the
  orientation histogram and a rotated 16x16 grid for the 4x4x8 descriptor, as
  tensor operations over all keypoints of all images at once. It launches K1
  and never K2; it is what tests hold the fast path against, not a hot path.

Every set is a fixed capacity (``max_keypoints``) with a validity mask.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from ..config import SIFTConfig
from . import dense_desc, kernels
from .pyramid import Pyramid, _const, build_pyramid, gradients, sigma_schedule


class Features(NamedTuple):
    """Fixed-capacity feature sets: [B, K, ...] from detect_and_describe, [K, ...] per image."""

    xy: torch.Tensor  # [..., K, 2] (x, y) pixel coords, 0-based, original resolution
    scale: torch.Tensor  # [..., K] absolute sigma
    orientation: torch.Tensor  # [..., K] radians
    response: torch.Tensor  # [..., K] |DoG| contrast
    desc: torch.Tensor  # [..., K, 128] L2-normalized
    mask: torch.Tensor  # [..., K] bool


# ---------------------------------------------------------------------------
# static geometry of the exact descriptor (numpy, computed once at import)
# ---------------------------------------------------------------------------

_DESC_GRID = 16  # samples per axis
_DESC_CELLS = 4
_DESC_BINS = 8
_ORI_R = 8  # orientation window radius (samples)


def _spatial_weights() -> np.ndarray:
    """[256, 16] trilinear spatial weights of each sample into the 4x4 cells."""
    n, c = _DESC_GRID, _DESC_CELLS
    w = np.zeros((n * n, c * c), dtype=np.float32)
    for i in range(n):  # y
        for j in range(n):  # x
            cy = (i + 0.5) * c / n - 0.5  # cell-space coordinate
            cx = (j + 0.5) * c / n - 0.5
            y0, x0 = int(np.floor(cy)), int(np.floor(cx))
            fy, fx = cy - y0, cx - x0
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    yy, xx = y0 + dy, x0 + dx
                    if 0 <= yy < c and 0 <= xx < c:
                        w[i * n + j, yy * c + xx] = wy * wx
    return w


def _gauss_window(n: int, sigma: float) -> np.ndarray:
    ax = np.arange(n) - (n - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    return np.outer(g, g).astype(np.float32).reshape(-1)


_W_SPATIAL = _spatial_weights()  # [256, 16]
_W_GAUSS_DESC = _gauss_window(_DESC_GRID, _DESC_GRID / 2.0)  # [256]


def _bilinear_flat(flat: torch.Tensor, level, ys: torch.Tensor, xs: torch.Tensor, H, W, row0=0) -> torch.Tensor:
    """Bilinear samples of flattened [L*H*W] stacks at (level, ys, xs); level integer.

    ``flat`` is [B, N], one flattened buffer per image; ``ys``/``xs`` are
    [B, ...] sample coordinates, and ``level``, ``H``, ``W`` and ``row0`` (the
    element offset of the stack's first row in a multi-octave buffer) are
    integers or integer tensors that broadcast against them. Indices past
    either end of the buffer read its first or last element.
    """
    H = torch.as_tensor(H, device=flat.device)
    W = torch.as_tensor(W, device=flat.device)
    x0 = torch.minimum(torch.floor(xs).clamp(min=0), (W - 2).to(xs.dtype))
    y0 = torch.minimum(torch.floor(ys).clamp(min=0), (H - 2).to(ys.dtype))
    fx = (xs - x0).clamp(0.0, 1.0)
    fy = (ys - y0).clamp(0.0, 1.0)
    base = row0 + level * (H * W) + y0.long() * W + x0.long()
    B, N = flat.shape

    def take(idx):
        return torch.gather(flat, 1, idx.clamp(0, N - 1).reshape(B, -1)).reshape(idx.shape)

    v00, v10, v01, v11 = take(base), take(base + 1), take(base + W), take(base + W + 1)
    return v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy) + v01 * (1 - fx) * fy + v11 * fx * fy


def _per_sample(a):
    """A per-keypoint quantity (tensor [B, K] or a plain number) against [B, K, P] samples."""
    return a[..., None] if isinstance(a, torch.Tensor) else a


def _soft_bins(b: torch.Tensor, weight: torch.Tensor, nb: int) -> torch.Tensor:
    """Each sample's ``weight`` [..., P] split linearly over the two bins next to its fractional
    bin coordinate ``b`` in [0, nb] (circular) -> [..., P, nb]."""
    b0 = torch.floor(b)
    fb = b - b0
    b0i = b0.long() % nb
    b1i = (b0i + 1) % nb
    bins = torch.arange(nb, device=b.device)
    return (b0i[..., None] == bins) * (weight * (1 - fb))[..., None] + (b1i[..., None] == bins) * (weight * fb)[..., None]


def _orientation_hist_one(gx_flat, gy_flat, lvl, yc, xc, sigma_rel, H, W, cfg: SIFTConfig, row0=0) -> torch.Tensor:
    """Smoothed circular orientation histogram of every keypoint (the reference's per-keypoint
    function, over [B, K] keypoints at once) -> [B, K, ori_bins]."""
    R = _ORI_R
    d = torch.arange(-R, R + 1, dtype=torch.float32, device=gx_flat.device)
    oy, ox = (g.reshape(-1) for g in torch.meshgrid(d, d, indexing="ij"))
    # Sample spacing proportional to the keypoint scale (window radius ~ 3*1.5*sigma).
    step = (1.5 * sigma_rel * 3.0 / R)[..., None]
    ys = yc[..., None] + oy * step
    xs = xc[..., None] + ox * step
    k = _per_sample
    gxs = _bilinear_flat(gx_flat, k(lvl), ys, xs, k(H), k(W), k(row0))
    gys = _bilinear_flat(gy_flat, k(lvl), ys, xs, k(H), k(W), k(row0))
    mag = torch.sqrt(gxs * gxs + gys * gys)
    w = torch.exp(-(oy**2 + ox**2) / (2.0 * (R / 1.5) ** 2))
    ang = torch.atan2(gys, gxs)  # [-pi, pi]
    nb = cfg.ori_bins
    hist = _soft_bins((ang / (2 * math.pi) + 0.5) * nb, w * mag, nb).sum(dim=-2)
    # Circular smoothing (two box passes).
    for _ in range(2):
        hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    return hist


def _descriptor_one(gx_flat, gy_flat, lvl, yc, xc, sigma_rel, theta, H, W, row0=0) -> torch.Tensor:
    """128-D SIFT descriptor of every keypoint (the reference's per-keypoint function, over
    [B, K] keypoints at once) -> [B, K, 128]."""
    n = _DESC_GRID
    dev = gx_flat.device
    d = torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2.0
    oy, ox = (g.reshape(-1) for g in torch.meshgrid(d, d, indexing="ij"))
    # Sample spacing: 3*sigma per histogram cell, 4 samples per cell.
    step = (3.0 * sigma_rel / (n / _DESC_CELLS))[..., None]
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    xs = xc[..., None] + (ct * ox - st * oy) * step
    ys = yc[..., None] + (st * ox + ct * oy) * step
    k = _per_sample
    gxs = _bilinear_flat(gx_flat, k(lvl), ys, xs, k(H), k(W), k(row0))
    gys = _bilinear_flat(gy_flat, k(lvl), ys, xs, k(H), k(W), k(row0))
    # Rotate gradients into the keypoint frame.
    rgx = ct * gxs + st * gys
    rgy = -st * gxs + ct * gys
    mag = torch.sqrt(rgx * rgx + rgy * rgy) * _const(("w_gauss_desc",), lambda: _W_GAUSS_DESC, dev)
    ang = torch.atan2(rgy, rgx)
    nb = _DESC_BINS
    ori_w = _soft_bins((ang / (2 * math.pi) + 0.5) * nb, mag, nb)  # [B, K, 256, 8]
    w_spatial = _const(("w_spatial",), lambda: _W_SPATIAL, dev)
    desc = torch.einsum("pc,...pb->...cb", w_spatial, ori_w).flatten(-2)  # [B, K, 128]
    # Normalize -> clip 0.2 -> renormalize (Lowe).
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-12)
    desc = torch.clamp(desc, max=0.2)
    return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-12)


def _scores(dogs: list, cfg: SIFTConfig, border: int, use_pallas: bool) -> list:
    """Extrema scores of every octave: kernel K1 in one launch, or its plain version."""
    if use_pallas:
        return kernels.extrema_scores_octaves(dogs, cfg.contrast_threshold, border)
    return [kernels.extrema_scores_plain(d, cfg.contrast_threshold, border) for d in dogs]


def _find_candidates(dog: torch.Tensor, cfg: SIFTConfig, k_cap: int, border: int = 5, use_pallas: bool = True, scores=None):
    """Extrema scores + exact top-k on one octave's [B, S+2, H, W] DoG stacks.

    ``scores`` are the octave's [B, S, H, W] extrema scores where the caller
    already has them (one launch for the pyramid); otherwise they are computed
    here. Returns (level, y, x, score, valid), each [B, k_cap]; level indexes
    the DoG stack (inner levels 1..S).
    """
    B, _, H, W = dog.shape
    if scores is None:
        scores = _scores([dog], cfg, border, use_pallas)[0]
    top, idx = torch.topk(scores.reshape(B, -1), k_cap, dim=1)
    lvl = idx // (H * W) + 1  # scores hold inner levels only
    rem = idx % (H * W)
    return lvl, rem // W, rem % W, top, top > 0


def _refine(dog: torch.Tensor, lvl, y, x, cfg: SIFTConfig):
    """Quadratic subpixel refinement of [B, K] candidates on [B, L, H, W] DoG stacks.

    Returns (dx, dy, ds, contrast, ok): offsets in (x, y, scale), interpolated
    contrast, and the accept flag (offset bound + contrast + edge tests).
    """
    B, L, H, W = dog.shape
    d = torch.arange(-1, 2, device=dog.device)
    off = (d[:, None, None] * (H * W) + d[None, :, None] * W + d[None, None, :]).reshape(-1)  # [27]
    idx = (lvl * (H * W) + y * W + x)[..., None] + off  # [B, K, 27]
    C = torch.gather(dog.reshape(B, -1), 1, idx.reshape(B, -1).clamp(0, L * H * W - 1))
    C = C.reshape(lvl.shape + (3, 3, 3))  # [..., l, y, x]

    def c_(l, yy, xx):
        return C[..., l, yy, xx]

    g0 = 0.5 * (c_(1, 1, 2) - c_(1, 1, 0))  # d/dx
    g1 = 0.5 * (c_(1, 2, 1) - c_(1, 0, 1))  # d/dy
    g2 = 0.5 * (c_(2, 1, 1) - c_(0, 1, 1))  # d/ds
    c = c_(1, 1, 1)
    dxx = c_(1, 1, 2) - 2 * c + c_(1, 1, 0)
    dyy = c_(1, 2, 1) - 2 * c + c_(1, 0, 1)
    dss = c_(2, 1, 1) - 2 * c + c_(0, 1, 1)
    dxy = 0.25 * (c_(1, 2, 2) - c_(1, 2, 0) - c_(1, 0, 2) + c_(1, 0, 0))
    dxs = 0.25 * (c_(2, 1, 2) - c_(2, 1, 0) - c_(0, 1, 2) + c_(0, 1, 0))
    dys = 0.25 * (c_(2, 2, 1) - c_(2, 0, 1) - c_(0, 2, 1) + c_(0, 0, 1))
    # Closed-form symmetric 3x3 solve (adjugate / Cramer).
    A0 = dyy * dss - dys * dys
    A1 = dxs * dys - dxy * dss
    A2 = dxy * dys - dxs * dyy
    det = dxx * A0 + dxy * A1 + dxs * A2
    B0 = dxx * dss - dxs * dxs
    B1 = dxs * dxy - dxx * dys
    C0 = dxx * dyy - dxy * dxy
    det_safe = torch.where(det.abs() < 1e-12, 1e-12, det)
    ox = -(A0 * g0 + A1 * g1 + A2 * g2) / det_safe
    oy = -(A1 * g0 + B0 * g1 + B1 * g2) / det_safe
    os_ = -(A2 * g0 + B1 * g1 + C0 * g2) / det_safe
    contrast = c + 0.5 * (g0 * ox + g1 * oy + g2 * os_)
    ok = (ox.abs() < 0.6) & (oy.abs() < 0.6) & (os_.abs() < 0.6)
    ok &= contrast.abs() >= cfg.contrast_threshold
    # Edge response on the 2x2 spatial Hessian (Lowe's r-test).
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = cfg.edge_threshold
    ok &= (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
    return ox, oy, os_, contrast, ok


def _octave_caps(cfg: SIFTConfig) -> list:
    return [max(64, cfg.max_keypoints >> o) for o in range(cfg.n_octaves)]


class _Candidates(NamedTuple):
    """Refined extrema from all octaves, octave-local coordinates, [B, M] each."""

    octave: torch.Tensor  # int64
    lvl: torch.Tensor  # int64 DoG level of the extremum
    xf: torch.Tensor  # octave-local subpixel x
    yf: torch.Tensor
    sigma_rel: torch.Tensor  # sigma relative to the octave base
    response: torch.Tensor  # |interpolated contrast|
    valid: torch.Tensor  # bool


def _detect_candidates(pyr: Pyramid, cfg: SIFTConfig) -> _Candidates:
    """Extrema + subpixel refinement for every octave (detection phase only)."""
    fields = {k: [] for k in _Candidates._fields}
    border = 5
    scores = _scores(pyr.dog[: cfg.n_octaves], cfg, border, cfg.use_pallas)
    for o in range(cfg.n_octaves):
        dog = pyr.dog[o]
        lvl, ys, xs, _, valid = _find_candidates(dog, cfg, _octave_caps(cfg)[o], border, scores=scores[o])
        dx, dy, ds, contrast, ok = _refine(dog, lvl, ys, xs, cfg)
        lf = lvl.to(torch.float32) + ds
        fields["octave"].append(torch.full_like(lvl, o))
        fields["lvl"].append(lvl)
        fields["xf"].append(xs.to(torch.float32) + dx)
        fields["yf"].append(ys.to(torch.float32) + dy)
        fields["sigma_rel"].append(cfg.sigma0 * torch.pow(2.0, lf / cfg.scales_per_octave))
        fields["response"].append(contrast.abs())
        fields["valid"].append(valid & ok)
    return _Candidates(**{k: torch.cat(v, dim=1) for k, v in fields.items()})


def _select_top(cand: _Candidates, k: int) -> tuple[_Candidates, torch.Tensor]:
    """Global top-k by response over all octaves' candidates."""
    score = torch.where(cand.valid, cand.response, -1.0)
    top, idx = torch.topk(score, k, dim=1)
    sel = _Candidates(*(torch.gather(a, 1, idx) for a in cand))
    return sel._replace(valid=top > 0), idx


def _interp_peak(hist: torch.Tensor, peak: torch.Tensor, nb: int) -> torch.Tensor:
    """Parabolic sub-bin interpolation of histogram peaks -> radians.

    hist: [..., nb]; peak: integer bins with hist's batch shape (one peak per
    histogram) or one extra trailing axis (several peaks per histogram).
    Bin centers sit at (i + 0.5)/nb of the circle.
    """
    squeeze = peak.ndim == hist.ndim - 1
    p = peak[..., None] if squeeze else peak
    hc = torch.gather(hist, -1, p % nb)
    hl = torch.gather(hist, -1, (p - 1) % nb)
    hr = torch.gather(hist, -1, (p + 1) % nb)
    denom = hl - 2 * hc + hr
    interp = torch.where(denom.abs() > 1e-12, 0.5 * (hl - hr) / denom, 0.0)
    bin_f = p.to(torch.float32) + interp
    theta = (bin_f / nb - 0.5 + 1.0 / (2 * nb)) * 2 * torch.pi
    return theta[..., 0] if squeeze else theta


def _two_peaks(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(theta1, theta2, has2) from smoothed circular histograms [..., nb].

    Lowe/MATLAB multi-orientation rule: peaks are circular local maxima; the
    strongest is the primary, the runner-up qualifies iff it clears 0.8x the
    primary. A flat histogram (no strict peak) falls back to its argmax.
    """
    nb = hist.shape[-1]
    hl = torch.roll(hist, 1, dims=-1)
    hr = torch.roll(hist, -1, dims=-1)
    is_peak = (hist >= hl) & (hist > hr)
    pk = torch.where(is_peak, hist, -1e30)
    vals, bins = torch.topk(pk, 2, dim=-1)
    theta = _interp_peak(hist, bins, nb)
    no_peak = vals[..., 0] <= -1e29
    theta1 = torch.where(no_peak, _interp_peak(hist, torch.argmax(hist, dim=-1), nb), theta[..., 0])
    has2 = (vals[..., 1] > -1e29) & (vals[..., 1] >= 0.8 * vals[..., 0]) & ~no_peak
    return theta1, theta[..., 1], has2


def _octave_table(kind: str, hs, ws, offsets, device) -> torch.Tensor:
    """[3, n_octaves] int64 (heights, widths, row offsets) on ``device``: a per-shape device constant,
    copied once, so that a step captured into a CUDA graph reads no host buffer."""
    return _const((kind, tuple(hs), tuple(ws), tuple(offsets)), lambda: np.asarray([hs, ws, offsets], np.int64), device)


def detect_and_describe(img: torch.Tensor, cfg: SIFTConfig) -> Features:
    """Detector + descriptor for a [B, H, W] batch -> Features with [B, max_keypoints] sets
    (``cfg.fast_descriptor``: the dense-map descriptor, else the Lowe-exact oracle path)."""
    pyr = build_pyramid(img, cfg)
    sig, _ = sigma_schedule(cfg)
    cand = _detect_candidates(pyr, cfg)
    sel, _ = _select_top(cand, cfg.max_keypoints)
    dev = img.device
    s = cfg.scales_per_octave

    # --- orientation stage (histograms first so multi-peak can duplicate) ---
    if cfg.fast_descriptor:
        rows, oct_off, H2s, W2s = [], [], [], []
        off = 0
        # Levels 1..s of every octave, read where they lie (views, no copy): kernel K2 in one launch.
        levels = [G[:, 1 : s + 1] for G in pyr.gauss[: cfg.n_octaves]]
        raws = kernels.bin_maps_octaves(levels) if cfg.use_pallas else [None] * len(levels)
        for o in range(cfg.n_octaves):
            G = pyr.gauss[o]
            H2, W2 = G.shape[2] // 2, G.shape[3] // 2
            rows.append(dense_desc.build_bin_map_rows(levels[o], sig[1 : s + 1], use_pallas=cfg.use_pallas, raw=raws[o]))
            oct_off.append(off)
            off += s * H2 * W2
            H2s.append(H2)
            W2s.append(W2)
        maps_flat = torch.cat(rows, dim=1)  # [B, N, 8]
        H2_t, W2_t, off_t = _octave_table("bin_rows", H2s, W2s, oct_off, dev)

        def derived(sl):
            lvl0 = torch.clamp(sl.lvl - 1, 0, s - 1)
            H2_k = H2_t[sl.octave]
            W2_k = W2_t[sl.octave]
            return off_t[sl.octave] + lvl0 * H2_k * W2_k, H2_k, W2_k

        def hists(sl):
            row_base, H2_k, W2_k = derived(sl)
            return dense_desc.orientation_hists(maps_flat, row_base, sl.yf, sl.xf, sl.sigma_rel, H2_k, W2_k)

        def descriptors(sl, ori):
            row_base, H2_k, W2_k = derived(sl)
            return dense_desc.descriptors(maps_flat, row_base, sl.yf, sl.xf, sl.sigma_rel, ori, H2_k, W2_k)

    else:
        # Lowe-exact oracle path: per-keypoint bilinear sampling from the
        # flattened multi-octave gradient stacks, one buffer per image.
        gx_rows, gy_rows, oct_off, GHs, GWs = [], [], [], [], []
        off = 0
        for o in range(cfg.n_octaves):
            G = pyr.gauss[o]
            gx, gy = gradients(G)
            gx_rows.append(gx.flatten(1))
            gy_rows.append(gy.flatten(1))
            oct_off.append(off)
            off += G.shape[1] * G.shape[2] * G.shape[3]
            GHs.append(G.shape[2])
            GWs.append(G.shape[3])
        gx_flat = torch.cat(gx_rows, dim=1)  # [B, N]
        gy_flat = torch.cat(gy_rows, dim=1)
        GH_t, GW_t, off_t = _octave_table("grad_rows", GHs, GWs, oct_off, dev)

        def hists(sl):
            return _orientation_hist_one(
                gx_flat, gy_flat, sl.lvl, sl.yf, sl.xf, sl.sigma_rel, GH_t[sl.octave], GW_t[sl.octave], cfg,
                row0=off_t[sl.octave],
            )

        def descriptors(sl, ori):
            return _descriptor_one(
                gx_flat, gy_flat, sl.lvl, sl.yf, sl.xf, sl.sigma_rel, ori, GH_t[sl.octave], GW_t[sl.octave],
                row0=off_t[sl.octave],
            )

    hist = hists(sel)

    # --- multi-peak duplication (Lowe/MATLAB >=80% rule), static shapes ---
    if cfg.n_orientations >= 2:
        th1, th2, has2 = _two_peaks(hist)
        ori_all = torch.cat([th1, th2], dim=1)
        valid_all = torch.cat([sel.valid, sel.valid & has2], dim=1)
        # Secondaries rank a hair below their primary so, at capacity, a
        # duplicate never evicts a stronger keypoint's primary orientation.
        resp_all = torch.cat([sel.response, sel.response * 0.99999], dim=1)
        score = torch.where(valid_all, resp_all, -1.0)
        top, idx = torch.topk(score, cfg.max_keypoints, dim=1)
        sel = _Candidates(*(torch.gather(torch.cat([a, a], dim=1), 1, idx) for a in sel))._replace(valid=top > 0)
        ori = torch.gather(ori_all, 1, idx)
    else:
        ori = _interp_peak(hist, torch.argmax(hist, dim=-1), hist.shape[-1])

    # --- descriptor stage on the final keypoint set ---
    desc = descriptors(sel, ori)

    oct_scale = torch.pow(2.0, sel.octave.to(torch.float32))
    xy = torch.stack([sel.xf, sel.yf], dim=-1) * oct_scale[..., None]
    return Features(
        xy=xy,
        scale=sel.sigma_rel * oct_scale,
        orientation=ori,
        response=sel.response,
        desc=desc,
        mask=sel.valid,
    )
