"""SIFT-style detection + dense description over a batch of images (port of vo_tpu.frontend.sift).

The fast path of the reference (``fast_descriptor=True``): dense 3x3x3 DoG
extrema scores (kernel K1, ``kernels.extrema_scores``), an exact per-octave
``torch.topk``, vectorised quadratic subpixel refinement, a global top-k by
response, then orientation histograms and descriptors from the dense bin maps
(kernel K2 inside ``dense_desc.build_bin_map_rows``). Every set is a fixed
capacity (``max_keypoints``) with a validity mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SIFTConfig
from ..utils.host_copy import upload
from . import dense_desc, kernels
from .pyramid import Pyramid, build_pyramid, sigma_schedule


class Features(NamedTuple):
    """Fixed-capacity feature sets: [B, K, ...] from detect_and_describe, [K, ...] per image."""

    xy: torch.Tensor  # [..., K, 2] (x, y) pixel coords, 0-based, original resolution
    scale: torch.Tensor  # [..., K] absolute sigma
    orientation: torch.Tensor  # [..., K] radians
    response: torch.Tensor  # [..., K] |DoG| contrast
    desc: torch.Tensor  # [..., K, 128] L2-normalized
    mask: torch.Tensor  # [..., K] bool


def _find_candidates(dog: torch.Tensor, cfg: SIFTConfig, k_cap: int, border: int = 5, use_pallas: bool = True):
    """Extrema scores + exact top-k on one octave's [B, S+2, H, W] DoG stacks.

    Returns (level, y, x, score, valid), each [B, k_cap]; level indexes the
    DoG stack (inner levels 1..S).
    """
    B, _, H, W = dog.shape
    if use_pallas:
        scores = kernels.extrema_scores(dog, cfg.contrast_threshold, border)
    else:
        scores = kernels.extrema_scores_plain(dog, cfg.contrast_threshold, border)
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
    for o in range(cfg.n_octaves):
        dog = pyr.dog[o]
        lvl, ys, xs, _, valid = _find_candidates(dog, cfg, _octave_caps(cfg)[o], use_pallas=cfg.use_pallas)
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


def detect_and_describe(img: torch.Tensor, cfg: SIFTConfig) -> Features:
    """Detector + dense descriptor for a [B, H, W] batch -> Features with [B, max_keypoints] sets."""
    if not cfg.fast_descriptor:
        raise NotImplementedError("vo_tpu_torch ports the fast descriptor path only (fast_descriptor=True)")
    pyr = build_pyramid(img, cfg)
    sig, _ = sigma_schedule(cfg)
    cand = _detect_candidates(pyr, cfg)
    sel, _ = _select_top(cand, cfg.max_keypoints)

    # --- orientation stage (histograms first so multi-peak can duplicate) ---
    s = cfg.scales_per_octave
    rows, oct_off, H2s, W2s = [], [], [], []
    off = 0
    for o in range(cfg.n_octaves):
        G = pyr.gauss[o]
        H2, W2 = G.shape[2] // 2, G.shape[3] // 2
        rows.append(dense_desc.build_bin_map_rows(G[:, 1 : s + 1], sig[1 : s + 1], use_pallas=cfg.use_pallas))
        oct_off.append(off)
        off += s * H2 * W2
        H2s.append(H2)
        W2s.append(W2)
    maps_flat = torch.cat(rows, dim=1)  # [B, N, 8]
    dev = img.device
    H2_t, W2_t, off_t = upload(torch.tensor([H2s, W2s, oct_off]), dev)

    def fast_derived(sl):
        lvl0 = torch.clamp(sl.lvl - 1, 0, s - 1)
        H2_k = H2_t[sl.octave]
        W2_k = W2_t[sl.octave]
        return off_t[sl.octave] + lvl0 * H2_k * W2_k, H2_k, W2_k

    row_base, H2_k, W2_k = fast_derived(sel)
    hist = dense_desc.orientation_hists(maps_flat, row_base, sel.yf, sel.xf, sel.sigma_rel, H2_k, W2_k)

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
    row_base, H2_k, W2_k = fast_derived(sel)
    desc = dense_desc.descriptors(maps_flat, row_base, sel.yf, sel.xf, sel.sigma_rel, ori, H2_k, W2_k)

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
